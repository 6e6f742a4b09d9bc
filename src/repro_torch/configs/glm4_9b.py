"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552,
RoPE + GQA. [hf:THUDM/glm-4-9b; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=13696, vocab_size=151552,
    rope_theta=10000.0, activation="swiglu",
)
