"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256; every 5th layer is a cross-attention image layer. The vision
frontend is a STUB: input_specs() supplies precomputed patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256,
    rope_theta=500000.0, activation="swiglu",
    cross_attn_period=5, n_vision_tokens=1601,
)
