"""Common layer primitives: norms, RoPE and sinusoidal positions,
embeddings (musicgen's K codebook tables too), MLP variants.

Parameters are ``nn.Module``s holding tensors in ``cfg.dtype`` (bf16 by
default); normalization and softmax statistics accumulate in float32.
Weights keep the reference's ``[d_in, d_out]`` orientation and are applied
as ``x @ W`` (no ``nn.Linear`` transpose), so a parameter crosses from the
JAX package unchanged (``repro_torch.bridge``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def pdtype(cfg: ModelConfig) -> torch.dtype:
    """The parameter / activation dtype of ``cfg``."""
    return _DTYPES[cfg.dtype]


def frozen_param(t: torch.Tensor) -> nn.Parameter:
    """An inference weight: a parameter that takes no gradient."""
    return nn.Parameter(t, requires_grad=False)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device, scale: float = 0.02) -> torch.Tensor:
    """A ``[d_in, d_out]`` weight drawn N(0, scale^2) from ``gen``."""
    return (torch.randn((d_in, d_out), generator=gen, device=device)
            * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    """RMSNorm scale vector (the reference's ``{"scale": [d]}``)."""

    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = frozen_param(scale)

    @classmethod
    def ones(cls, d: int, dtype, device) -> "RMSNorm":
        """A unit scale (the reference's init)."""
        return cls(torch.ones(d, dtype=dtype, device=device))


def rmsnorm(norm: RMSNorm, x: torch.Tensor, eps: float = 1e-6):
    """RMSNorm over the last axis, computed in f32, cast back to x's dtype."""
    return head_rmsnorm(norm.scale, x, eps)


def head_rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    """QK-norm over the head_dim axis (qwen3-style), x: [..., head_dim]."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position encoding (rotate-half, not interleaved)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """Inverse frequencies ``theta ** -(2i / head_dim)``, f32 [D/2]."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [B, S, H, D]; positions: [B, S] (int32)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # [D/2]
    angles = positions.float()[..., None] * freqs               # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor,
                         d_model: int) -> torch.Tensor:
    """Additive sinusoidal embedding (musicgen), f32. positions: [B, S]
    -> [B, S, d_model] (sines, then cosines)."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs                 # [B, S, half]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """Gated (swiglu / geglu: w_gate, w_up, w_down) or plain (gelu: w_up,
    w_down) MLP weights."""

    def __init__(self, w_up: torch.Tensor, w_down: torch.Tensor,
                 w_gate: torch.Tensor | None = None):
        super().__init__()
        self.w_up = frozen_param(w_up)
        self.w_down = frozen_param(w_down)
        self.w_gate = None if w_gate is None else frozen_param(w_gate)


def mlp_init(gen: torch.Generator, cfg: ModelConfig, device) -> MLP:
    """Draw an MLP for ``cfg`` from ``gen`` (gate, up, down order)."""
    d, dt = cfg.d_model, pdtype(cfg)
    if cfg.activation in ("swiglu", "geglu"):
        w_gate = dense_init(gen, d, cfg.d_ff, dt, device)
        w_up = dense_init(gen, d, cfg.d_ff, dt, device)
        return MLP(w_up, dense_init(gen, cfg.d_ff, d, dt, device), w_gate)
    w_up = dense_init(gen, d, cfg.d_ff, dt, device)
    return MLP(w_up, dense_init(gen, cfg.d_ff, d, dt, device))


def mlp_apply(mlp: MLP, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` is the tanh form, hence ``approximate="tanh"``."""
    if cfg.activation == "swiglu":
        h = F.silu(x @ mlp.w_gate) * (x @ mlp.w_up)
    elif cfg.activation == "geglu":
        h = F.gelu(x @ mlp.w_gate, approximate="tanh") * (x @ mlp.w_up)
    else:
        h = F.gelu(x @ mlp.w_up, approximate="tanh")
    return h @ mlp.w_down


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


class Embed(nn.Module):
    """Token table [V, d]; ``unembed`` [d, V] only when not tied. The
    audio family stacks its K codebooks' tables: [K·V, d] and [d, K·V]."""

    def __init__(self, embedding: torch.Tensor,
                 unembed: torch.Tensor | None = None):
        super().__init__()
        self.embedding = frozen_param(embedding)
        self.unembed = None if unembed is None else frozen_param(unembed)


def embed_init(gen: torch.Generator, cfg: ModelConfig, device) -> Embed:
    """Draw the embedding (and untied unembedding) from ``gen``."""
    dt = pdtype(cfg)
    rows = (cfg.n_codebooks if cfg.family == "audio" else 1) * cfg.vocab_size
    table = (torch.randn((rows, cfg.d_model), generator=gen,
                         device=device) * 0.02).to(dt)
    unembed = None
    if not cfg.tie_embeddings:
        unembed = dense_init(gen, cfg.d_model, rows, dt, device)
    return Embed(table, unembed)


def embed_apply(embed: Embed, cfg: ModelConfig, tokens: torch.Tensor):
    """tokens: [B, S] int -> [B, S, d]. Audio: tokens [B, K, S], codebook
    k's ids offset by ``k · vocab``, the K rows summed -> [B, S, d]."""
    if cfg.family == "audio":
        offsets = (torch.arange(cfg.n_codebooks, device=tokens.device)
                   * cfg.vocab_size)[None, :, None]
        return embed.embedding[tokens.long() + offsets].sum(dim=1)
    return embed.embedding[tokens.long()]


def unembed_apply(embed: Embed, cfg: ModelConfig, x: torch.Tensor):
    """x: [B, S, d] -> logits [B, S, V] (tied table transposed); audio
    -> [B, K, S, V], one slice of V per codebook."""
    if cfg.tie_embeddings:
        logits = x @ embed.embedding.T
    else:
        logits = x @ embed.unembed
    if cfg.family == "audio":
        b, s, _ = logits.shape
        logits = logits.view(b, s, cfg.n_codebooks,
                             cfg.vocab_size).movedim(2, 1)
    return logits
