"""Model assembly for the dense family: init, paged cache, decode and
chunked prefill steps, on-device sampling.

The reference streams a stacked layer axis through its speculative-read
scan; here the layers are a plain loop over ``DenseModel.blocks`` (the
reference's serving engine drops the prefetch for a single device too).
KV caches keep the reference's paged layout ``{"kv": {"k","v"}:
[L, B, P, page, Hkv, D], "pos": [B]}`` and are updated **in place**: the
steps return the same cache dict they were given, where the reference
returns new arrays (its engine donates them).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.layers import (Embed, RMSNorm, embed_apply,
                                       embed_init, pdtype, rmsnorm,
                                       unembed_apply)

PORTED_FAMILIES = ("dense",)


def check_family(cfg: ModelConfig) -> None:
    """Raise for a model family this port does not serve yet."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  f"(ported: {PORTED_FAMILIES})")


class DenseModel(nn.Module):
    """A dense decoder: ``embed``, per-layer ``blocks`` and ``ln_f``."""

    def __init__(self, embed: Embed, blocks, ln_f: RMSNorm):
        super().__init__()
        self.embed = embed
        self.blocks = nn.ModuleList(blocks)
        self.ln_f = ln_f


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_model(cfg: ModelConfig, *, seed: int = 0,
               device="cuda") -> DenseModel:
    """Random weights (N(0, 0.02^2)) drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``. The draws cannot reproduce
    the reference's ``jax.random`` bits; to compare with it, carry its
    weights across with ``repro_torch.bridge.params_from_jax``."""
    check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = pdtype(cfg)
    with torch.no_grad():
        embed = embed_init(gen, cfg, dev)
        blocks = [transformer.block_init(gen, cfg, dev)
                  for _ in range(cfg.n_layers)]
        return DenseModel(embed, blocks, RMSNorm.ones(cfg.d_model, dt, dev))


# ---------------------------------------------------------------------------
# KV cache (paged layout)
# ---------------------------------------------------------------------------


def cache_init(cfg: ModelConfig, rc: RunConfig, batch: int, max_seq: int,
               *, device="cuda") -> Dict:
    """Zeroed paged cache ``{"kv": {"k","v"}: [L,B,P,page,Hkv,D],
    "pos": int32 [B]}`` in the model dtype."""
    check_family(cfg)
    if rc.kv_quant != "none":
        raise NotImplementedError("int8 KV pages are not ported yet")
    dev = resolve_device(device)
    page = min(rc.kv_page_size, max_seq)
    n_pages = max(max_seq // page, 1)
    shape = (cfg.n_layers, batch, n_pages, page, cfg.n_kv_heads,
             cfg.head_dim)
    return {"kv": {"k": torch.zeros(shape, dtype=pdtype(cfg), device=dev),
                   "v": torch.zeros(shape, dtype=pdtype(cfg), device=dev)},
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def _layer_kv(cache: Dict, i: int) -> Dict[str, torch.Tensor]:
    return {name: a[i] for name, a in cache["kv"].items()}


# ---------------------------------------------------------------------------
# decode / prefill
# ---------------------------------------------------------------------------


@torch.no_grad()
def decode_step(params: DenseModel, cfg: ModelConfig, rc: RunConfig,
                tokens: torch.Tensor, cache: Dict
                ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode for every row. tokens: [B, 1] -> logits [B, 1, V].

    Writes each row's new K/V at its ``cache["pos"]`` and advances every
    row's position by one, in place."""
    check_family(cfg)
    pos = cache["pos"]
    x = embed_apply(params.embed, cfg, tokens)
    for i, block in enumerate(params.blocks):
        x = transformer.block_decode_paged(block, cfg, x, pos,
                                           _layer_kv(cache, i))
    x = rmsnorm(params.ln_f, x, cfg.norm_eps)
    logits = unembed_apply(params.embed, cfg, x)
    cache["pos"] += 1
    return logits, cache


@torch.no_grad()
def prefill_step_cached(params: DenseModel, cfg: ModelConfig,
                        rc: RunConfig, tokens: torch.Tensor, cache: Dict, *,
                        last_only: bool = False
                        ) -> Tuple[torch.Tensor, Dict]:
    """Chunked multi-token prefill that writes the paged KV cache in place.

    tokens: [B, C] int. Every row ingests its C tokens starting at its own
    ``cache["pos"]``; returns (logits [B, C, V] — or only the last
    position's, [B, 1, V], with ``last_only`` — and the cache with pos
    advanced by C).
    """
    check_family(cfg)
    pos = cache["pos"]
    x = embed_apply(params.embed, cfg, tokens)
    c = x.shape[1]
    positions = (pos.reshape(-1, 1).to(torch.int32)
                 + torch.arange(c, dtype=torch.int32, device=x.device)[None])
    for i, block in enumerate(params.blocks):
        x = transformer.block_prefill_cached(block, cfg, x, positions, pos,
                                             _layer_kv(cache, i))
    if last_only:
        x = x[:, -1:]
    x = rmsnorm(params.ln_f, x, cfg.norm_eps)
    logits = unembed_apply(params.embed, cfg, x)
    cache["pos"] += c
    return logits, cache


# ---------------------------------------------------------------------------
# on-device sampling
# ---------------------------------------------------------------------------


def last_token_logits(logits: torch.Tensor) -> torch.Tensor:
    """Final-position logits row per batch element: [B, S, V] -> [B, V]."""
    return logits[:, -1]


def sample_tokens(logits_row: torch.Tensor, u: Optional[torch.Tensor],
                  temperature: float) -> torch.Tensor:
    """Greedy / temperature sampling on device. logits_row: [B, V] -> [B].

    Temperature sampling inverts the softmax CDF at one uniform per row,
    ``u`` ([B], in [0, 1)); the caller draws it (the engine from its seeded
    ``torch.Generator``), so a test can feed the reference's draw.
    """
    row = logits_row.float()
    if temperature and temperature > 0:
        p = torch.softmax(row / temperature, dim=-1)
        cdf = torch.cumsum(p, dim=-1)
        return (cdf < u[:, None] * cdf[:, -1:]).sum(dim=-1).to(torch.int32)
    return torch.argmax(row, dim=-1).to(torch.int32)
