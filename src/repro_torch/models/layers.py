"""Common layer primitives: norms, RoPE and sinusoidal positions,
embeddings (musicgen's K codebook tables too), MLP variants, the
cross-entropy loss.

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
from repro_torch.parallel import sharding

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


def mlp_apply(mlp: MLP, cfg: ModelConfig, x: torch.Tensor,
              group=None, train: bool = False) -> torch.Tensor:
    """``jax.nn.gelu`` is the tanh form, hence ``approximate="tanh"``.
    With the weights of a rank ``group`` split on d_ff
    (``parallel.sharding``): the gate / up products column-parallel, the
    down product row-parallel (``parallel.sharding.row_parallel``); with
    ``train``, differentiably: ``x`` enters through ``copy_in`` and the
    ranks' f32 products leave through ``reduce_out``."""
    if train and group is not None and mlp.w_down.shape[0] != cfg.d_ff:
        x = sharding.copy_in(group, x)
        return sharding.reduce_out(
            group, sharding.product_f32(_mlp_hidden(mlp, cfg, x),
                                        mlp.w_down), x.dtype)
    return sharding.row_product(group, _mlp_hidden(mlp, cfg, x),
                                mlp.w_down, cfg.d_ff)


def _mlp_hidden(mlp: MLP, cfg: ModelConfig, x: torch.Tensor):
    if cfg.activation == "swiglu":
        h = F.silu(x @ mlp.w_gate) * (x @ mlp.w_up)
    elif cfg.activation == "geglu":
        h = F.gelu(x @ mlp.w_gate, approximate="tanh") * (x @ mlp.w_up)
    else:
        h = F.gelu(x @ mlp.w_up, approximate="tanh")
    return h


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


def _table_rows(cfg: ModelConfig) -> int:
    return (cfg.n_codebooks if cfg.family == "audio" else 1) * cfg.vocab_size


def embed_apply(embed: Embed, cfg: ModelConfig, tokens: torch.Tensor,
                group=None, train: bool = False):
    """tokens: [B, S] int -> [B, S, d]. Audio: tokens [B, K, S], codebook
    k's ids offset by ``k · vocab``, the K rows summed -> [B, S, d].
    With the table of a rank ``group`` split on its rows
    (``parallel.sharding``), an id this rank does not hold gives 0 and a
    sum across the ranks puts the rows together (with ``train``,
    ``sharding.reduce_out``: each rank's rows take their gradient)."""
    ids = tokens.long()
    if cfg.family == "audio":
        ids = ids + (torch.arange(cfg.n_codebooks, device=tokens.device)
                     * cfg.vocab_size)[None, :, None]
    table = embed.embedding
    if group is None or table.shape[0] == _table_rows(cfg):
        x = table[ids]
    else:
        local = ids - group.rank * table.shape[0]
        held = (local >= 0) & (local < table.shape[0])
        rows = torch.where(held[..., None],
                           table[local.clamp(0, table.shape[0] - 1)], 0)
        x = (sharding.reduce_out(group, rows) if train
             else sharding.reduce_sum(group, rows))
    return x.sum(dim=1) if cfg.family == "audio" else x


def unembed_apply(embed: Embed, cfg: ModelConfig, x: torch.Tensor,
                  group=None):
    """x: [B, S, d] -> logits [B, S, V] (tied table transposed); audio
    -> [B, K, S, V], one slice of V per codebook. With the table of a rank
    ``group`` split on the vocabulary, the ranks' logits are gathered."""
    if cfg.tie_embeddings:
        logits = x @ embed.embedding.T
    else:
        logits = x @ embed.unembed
    if group is not None and logits.shape[-1] != _table_rows(cfg):
        logits = sharding.gather_columns(group, logits)
    if cfg.family == "audio":
        b, s, _ = logits.shape
        logits = logits.view(b, s, cfg.n_codebooks,
                             cfg.vocab_size).movedim(2, 1)
    return logits


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def table_split(embed: Embed, cfg: ModelConfig) -> bool:
    """Whether this rank holds part of the vocabulary (the table, or the
    untied unembedding, cut on it by ``parallel.sharding``)."""
    if cfg.tie_embeddings:
        return embed.embedding.shape[0] != _table_rows(cfg)
    return embed.unembed.shape[1] != _table_rows(cfg)


def vocab_parallel_xent(embed: Embed, cfg: ModelConfig, x: torch.Tensor,
                        labels: torch.Tensor, group) -> torch.Tensor:
    """``softmax_xent(unembed_apply(embed, cfg, x), labels)`` with the
    vocabulary split over the rank ``group`` (this rank's contiguous
    columns, ``table_split``), differentiably and without gathering the
    [T, V] logits: each rank's logits over its columns; the max (no
    gradient: the result does not depend on it) and, per codebook, the
    sum of exponentials and the label's logit (from the rank holding it,
    0 elsewhere) summed over the ranks in f32. x [B, S, d] whole on every
    rank; labels [B, S] (audio [B, K, S])."""
    x = sharding.copy_in(group, x)
    w = embed.embedding.T if cfg.tie_embeddings else embed.unembed
    logits = (x @ w).float()                                 # [B, S, n]
    n, v = logits.shape[-1], cfg.vocab_size
    lo = group.rank * n
    lab = labels.long() if labels.ndim == 3 else labels.long()[:, None]
    k_n = lab.shape[1]
    maxes, sums, golds = [], [], []
    for k in range(k_n):
        a, b = max(k * v, lo), min((k + 1) * v, lo + n)
        col = lab[:, k] + k * v - lo                         # [B, S]
        held = (col >= 0) & (col < n)
        golds.append(torch.where(held, logits.gather(
            -1, col.clamp(0, n - 1)[..., None])[..., 0], 0.0))
        if a < b:
            part = logits[..., a - lo:b - lo]
            maxes.append(part.detach().amax(dim=-1))
            sums.append(part)
        else:
            maxes.append(torch.full_like(golds[-1], float("-inf")))
            sums.append(None)
    mx = group.all_reduce(torch.stack(maxes, 1).contiguous(), "max")
    exps = [torch.zeros_like(golds[k]) if p is None else
            torch.exp(p - mx[:, k, :, None]).sum(dim=-1)
            for k, p in enumerate(sums)]
    tot = sharding.reduce_out(group, torch.stack([torch.stack(exps, 1),
                                                  torch.stack(golds, 1)]))
    return (torch.log(tot[0]) + mx - tot[1]).mean()


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy in f32: ``logsumexp`` minus the gold logit.
    logits [..., V]; labels [...] int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()
