"""Attention for the serving path: QKV projection, chunked-prefill attention
and the single-rank paged decode.

Both attentions run the port's kernels (``repro_torch.kernels``): on a CUDA
tensor the hand-written CUDA kernel, on a CPU tensor its plain version.
The cache is written in place where the reference writes a new array.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import paged_decode
from repro_torch.kernels.flash_attention.ops import flash_prefill
from repro_torch.models.layers import (apply_rope, dense_init, frozen_param,
                                       head_rmsnorm, pdtype)


class Attention(nn.Module):
    """Projection weights ``wq/wk/wv/wo`` ([d_in, d_out]) and, with
    qk-norm, the per-head ``q_norm``/``k_norm`` scales."""

    def __init__(self, wq, wk, wv, wo, q_norm=None, k_norm=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = (frozen_param(w) for w in
                                              (wq, wk, wv, wo))
        self.q_norm = None if q_norm is None else frozen_param(q_norm)
        self.k_norm = None if k_norm is None else frozen_param(k_norm)


def attn_init(gen: torch.Generator, cfg: ModelConfig, device) -> Attention:
    """Draw the projections from ``gen`` (q, k, v, o order)."""
    d, dt = cfg.d_model, pdtype(cfg)
    ws = [dense_init(gen, d, cfg.q_dim, dt, device),
          dense_init(gen, d, cfg.kv_dim, dt, device),
          dense_init(gen, d, cfg.kv_dim, dt, device),
          dense_init(gen, cfg.q_dim, d, dt, device)]
    norms = [None, None]
    if cfg.qk_norm:
        norms = [torch.ones(cfg.head_dim, dtype=dt, device=device)
                 for _ in range(2)]
    return Attention(*ws, *norms)


def qkv_project(attn: Attention, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, rope: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> q [B,S,H,D], k/v [B,S,Hkv,D] with qk-norm + RoPE."""
    b, s, _ = x.shape
    q = (x @ attn.wq).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (x @ attn.wk).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ attn.wv).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = head_rmsnorm(attn.q_norm, q, cfg.norm_eps)
        k = head_rmsnorm(attn.k_norm, k, cfg.norm_eps)
    if rope and cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def chunk_prefill_attention(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, pos: torch.Tensor,
                            logit_softcap: float = 0.0) -> torch.Tensor:
    """Chunked prefill against a live cache (the flash-prefill kernel).

    q: [B, C, H, D] — a chunk of C fresh tokens whose K/V were already
    written into the caches at [pos, pos+C) (per-row ``pos``, int32 [B]).
    caches: [B, Smax, Hkv, D]. Query i of row b attends to cache positions
    <= pos[b] + i. Returns [B, C, H, D].
    """
    return flash_prefill(q, k_cache, v_cache, pos,
                         logit_softcap=logit_softcap)


def write_rows(buf: torch.Tensor, new: torch.Tensor,
               start: torch.Tensor) -> None:
    """In place: ``buf[b, start[b] : start[b] + S] = new[b]`` for every row.

    buf: [B, Smax, Hkv, D]; new: [B, S, Hkv, D]. Like the reference's
    ``dynamic_update_slice``, a start that would run past the end is
    clamped to ``Smax - S``.
    """
    b, s = new.shape[0], new.shape[1]
    first = start.long().clamp(0, buf.shape[1] - s)
    idx = first[:, None] + torch.arange(s, device=buf.device)[None]
    rows = torch.arange(b, device=buf.device)[:, None]
    buf[rows, idx] = new.to(buf.dtype)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, new_k: torch.Tensor,
                           new_v: torch.Tensor, pos: torch.Tensor, *,
                           n_ranks: int = 1,
                           logit_softcap: float = 0.0) -> torch.Tensor:
    """Single-token decode over each slot's KV pages (the paged-decode
    kernel).

    q: [B,1,H,D]; new_k/new_v: [B,1,Hkv,D]; pages: [B,P,page,Hkv,D];
    pos: int32 [B] per-slot positions. The new token's K/V is written in
    place at ``pos[b]`` (clamped to the last position) before slot b
    attends to positions [0, pos[b]]. Returns o [B,1,H,D]; the pages are
    updated in place. Only the single-rank path is ported; the
    page-sharded path raises.
    """
    if n_ranks > 1:
        raise NotImplementedError("page-sharded (multi-rank) decode is not "
                                  "ported yet")
    b, _, _, d = q.shape
    hkv = k_pages.shape[3]
    smax = k_pages.shape[1] * k_pages.shape[2]
    write_rows(k_pages.view(b, smax, hkv, d), new_k, pos)
    write_rows(v_pages.view(b, smax, hkv, d), new_v, pos)
    kv_len = (pos + 1).to(torch.int32)
    return paged_decode(q, k_pages, v_pages, kv_len,
                        logit_softcap=logit_softcap)
