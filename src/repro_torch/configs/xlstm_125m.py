"""xlstm-125m [ssm] — 12L d_model=768 4H, mLSTM blocks with sLSTM every 6th
layer, no separate FFN (d_ff=0), vocab=50304. [arXiv:2405.04517; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, head_dim=192,
    d_ff=0, vocab_size=50304,
    slstm_every=6, mlstm_expand=2, use_rope=False, tie_embeddings=True,
)
