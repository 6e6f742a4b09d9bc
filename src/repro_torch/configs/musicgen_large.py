"""musicgen-large [audio] — 48L d_model=2048 32H (MHA kv=32) d_ff=8192,
decoder-only over EnCodec tokens: 4 codebooks, vocab=2048 each, additive
sinusoidal positions. The EnCodec frontend is a STUB: input_specs() supplies
the token grid. [arXiv:2306.05284; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048, n_codebooks=4,
    use_rope=False, activation="gelu",
)
