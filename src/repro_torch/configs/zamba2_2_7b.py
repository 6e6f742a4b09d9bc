"""zamba2-2.7b [hybrid] — 54L d_model=2560, Mamba2 backbone + ONE shared
attention block (32H kv=32, d_ff=10240) invoked every 6 mamba layers,
ssm_state=64, vocab=32000. [arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    shared_block_period=6, activation="geglu",
)
