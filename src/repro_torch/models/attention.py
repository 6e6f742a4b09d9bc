"""Attention: QKV projection, chunked-prefill attention, the single-rank
paged decode, the VLM's cross attention over a contiguous cache of vision
K/V, and the training path's plain, differentiable blockwise
``chunked_attention``.

The paged attentions run the port's kernels (``repro_torch.kernels``): on a
CUDA tensor the hand-written CUDA kernel, on a CPU tensor its plain
version. The cross attention is plain PyTorch on either device, as the
reference computes it in plain jnp outside any Pallas kernel
(``decode_attention``, ``chunked_attention`` with ``causal=False``); its
1601 vision tokens fill no whole number of pages, so no paged kernel
takes them.
The cache is written in place where the reference writes a new array.
With int8 pages (``models.kv_quant``) the decode kernel reads the codes in
place and only the page a row wrote is requantized; the reference
requantizes every page, which leaves the others bit for bit unchanged.

The page-sharded decode (a rank group of more than one rank,
``launch.mesh``) is the reference's shard_map body: the owner of each
slot's position writes its new K/V, every rank decodes over its own pages
(the kernel's ``return_ml`` partials) and the partials combine across the
ranks with one max and one sum all-reduce.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention.ops import paged_decode
from repro_torch.kernels.flash_attention.ops import flash_prefill
from repro_torch.models import kv_quant
from repro_torch.models.layers import (apply_rope, dense_init, frozen_param,
                                       head_rmsnorm, pdtype, rmsnorm)
from repro_torch.parallel import sharding


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


def _whole_columns(group, parts, widths):
    """Column-parallel products put together: each of ``parts`` whose last
    axis is short of its ``widths`` entry (its weight split over the rank
    ``group``, ``parallel.sharding``) is gathered from every rank, all of
    them in one all-gather; the others pass as they are."""
    cut = [p.shape[-1] != w for p, w in zip(parts, widths)]
    if not any(cut):
        return parts
    every = group.all_gather(torch.cat([p for p, c in zip(parts, cut) if c],
                                       dim=-1))        # [N, ..., sum n/N]
    out, at = [], 0
    for p, c in zip(parts, cut):
        if c:
            n = p.shape[-1]
            p = torch.cat(list(every[..., at:at + n]), dim=-1)
            at += n
        out.append(p)
    return out


def qkv_project(attn: Attention, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, rope: bool = True, group=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> q [B,S,H,D], k/v [B,S,Hkv,D] with qk-norm + RoPE.
    With ``wq``/``wk``/``wv`` split over a rank ``group`` on their
    columns, every rank projects its columns and one all-gather gives
    every rank all the heads, before the per-head norms and RoPE (a split
    need not fall on a head's edge: gemma-2b's one kv head of 256)."""
    b, s, _ = x.shape
    q, k, v = (x @ attn.wq, x @ attn.wk, x @ attn.wv)
    if group is not None:
        q, k, v = _whole_columns(group, (q, k, v),
                                 (cfg.q_dim, cfg.kv_dim, cfg.kv_dim))
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = head_rmsnorm(attn.q_norm, q, cfg.norm_eps)
        k = head_rmsnorm(attn.k_norm, k, cfg.norm_eps)
    if rope and cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def train_heads(cfg: ModelConfig, n: int) -> int:
    """The q heads a rank of a model axis of ``n`` computes in training
    where its split falls on head edges: H / n, when every rank's heads
    map to whole kv heads (G divides them) or share one (they divide G);
    else 0 (the split falls inside a head, or a rank's heads straddle kv
    heads unevenly: its q columns are gathered whole)."""
    h, g = cfg.n_heads, cfg.n_heads // cfg.n_kv_heads
    if h % n:
        return 0
    hl = h // n
    return hl if hl % g == 0 or g % hl == 0 else 0


def qkv_project_train(attn: Attention, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, group
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 bool]:
    """``qkv_project`` under grad over a model ``group``, x [B, S, d] whole
    on every rank: (q, k, v, split). Where ``wq`` is split on its columns
    (``split``) each rank computes its own heads' q (``train_heads``; its
    columns gathered whole where the split is not on head edges) and the
    kv heads they read: its own columns of a split ``wk``/``wv`` where its
    heads are exactly those, else the columns gathered whole (a split
    inside a head: gemma-2b's one kv head) or a whole weight's columns,
    sliced to its kv heads. Each rank's gradients are then its share,
    summed over the ranks by ``copy_in`` at ``x``, at a whole ``wk`` /
    ``wv`` and at the q/k norms, and by the gathers' backward. Where
    ``wq`` is whole (and so ``wo``) the attention is whole on every rank,
    a split ``wk``/``wv``'s columns gathered whole (each rank keeping its
    columns' gradient)."""
    b, s, _ = x.shape
    d, g = cfg.head_dim, cfg.n_heads // cfg.n_kv_heads
    split = attn.wq.shape[1] != cfg.q_dim
    qn, kn = attn.q_norm, attn.k_norm
    if not split:
        q = x @ attn.wq
        k, v = (x @ w if w.shape[1] == cfg.kv_dim else
                sharding.gather_cols(group, x @ w) for w in (attn.wk,
                                                              attn.wv))
    else:
        x = sharding.copy_in(group, x)
        hl = train_heads(cfg, group.size)
        q = x @ attn.wq
        q_lo = group.rank * hl
        if not hl:
            q = sharding.gather_cols(group, q, grad="sum")
            q_lo, hl = 0, cfg.n_heads
        kv_lo, kv_n = q_lo // g, max(1, hl // g)
        cols = slice(kv_lo * d, (kv_lo + kv_n) * d)

        def kv(w):
            if w.shape[1] == cfg.kv_dim:
                return x @ sharding.copy_in(group, w)[:, cols]
            if kv_n * d == w.shape[1] and kv_lo * d == group.rank * kv_n * d:
                return x @ w
            return sharding.gather_cols(group, x @ w, grad="sum")[..., cols]
        k, v = kv(attn.wk), kv(attn.wv)
        if cfg.qk_norm:
            qn, kn = (sharding.copy_in(group, t) for t in (qn, kn))
    q = q.reshape(b, s, -1, d)
    k = k.reshape(b, s, -1, d)
    v = v.reshape(b, s, -1, d)
    if cfg.qk_norm:
        q = head_rmsnorm(qn, q, cfg.norm_eps)
        k = head_rmsnorm(kn, k, cfg.norm_eps)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v, split


def q_project(attn: Attention, cfg: ModelConfig, x: torch.Tensor,
              group=None) -> torch.Tensor:
    """The query alone, without RoPE (the cross layer's): x: [B, S, d] ->
    q [B, S, H, D] with qk-norm; with ``wq`` split over a rank ``group``
    on its columns, gathered whole first."""
    b, s, _ = x.shape
    q = sharding.whole_columns(group, x @ attn.wq, cfg.q_dim)
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = head_rmsnorm(attn.q_norm, q, cfg.norm_eps)
    return q


NEG_INF = -1e30


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, kv_block: int = 512,
                      logit_softcap: float = 0.0) -> torch.Tensor:
    """Blockwise (flash-style) attention in plain, differentiable PyTorch:
    the reference's ``chunked_attention``, an online softmax over key
    blocks of ``kv_block`` in f32. q: [B,Sq,H,D], k/v: [B,Skv,Hkv,D] (H a
    multiple of Hkv) -> [B,Sq,H,D] in q's dtype.

    Causal masking assumes q and k cover the same [0, S) positions. A key
    length no block divides (the VLM's 1601 vision tokens) is padded and
    the padding masked. The reference scans its query blocks (its
    ``q_block``) side by side; here every query row of a key block is one
    product, [B, Hkv, Sq·G, D]
    against the block, which runs each row's online softmax through the
    same steps. The running max is held without gradient: the result does
    not depend on it, so its gradient is zero in exact arithmetic."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    kv_block = min(kv_block, skv)
    kv_valid = skv
    if skv % kv_block:
        pad = kv_block - skv % kv_block
        k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (k, v))
        skv += pad
    scale = 1.0 / (d ** 0.5)
    # rows (position, group member) of each kv head: [B, Hkv, Sq·G, D]
    qh = q.float().reshape(b, sq, hkv, g, d).transpose(1, 2).reshape(
        b, hkv, sq * g, d)
    kh, vh = (t.float().transpose(1, 2) for t in (k, v))    # [B,Hkv,Skv,D]
    row_pos = torch.arange(sq, device=q.device).repeat_interleave(g)
    acc = torch.zeros((b, hkv, sq * g, d), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, hkv, sq * g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    for j in range(skv // kv_block):
        keys = slice(j * kv_block, (j + 1) * kv_block)
        s = (qh @ kh[:, :, keys].transpose(-1, -2)) * scale
        if logit_softcap > 0.0:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        kv_pos = torch.arange(j * kv_block, (j + 1) * kv_block,
                              device=q.device)
        if causal:
            s = torch.where(row_pos[:, None] >= kv_pos[None], s, NEG_INF)
        if kv_valid != skv:
            s = torch.where(kv_pos < kv_valid, s, NEG_INF)
        m_new = torch.maximum(m, s.detach().amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p @ vh[:, :, keys]
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, hkv, sq, g, d).transpose(1, 2).reshape(
        b, sq, h, d).to(q.dtype)


def attention_train(block, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, group, *, causal: bool = True,
                    kv_block: int = 512) -> torch.Tensor:
    """The attention half of a block (``ln_attn``, ``attn``) under grad
    over a model ``group`` (x [B, S, d] whole on every rank; returns x
    plus the attention's output, whole on every rank): Megatron's form --
    each rank's heads (``qkv_project_train``), the plain
    ``chunked_attention`` on them, the row-parallel ``wo`` product in f32
    summed over the ranks and cast once (``sharding.reduce_out``)."""
    b, s = x.shape[0], x.shape[1]
    h = rmsnorm(block.ln_attn, x, cfg.norm_eps)
    q, k, v, split = qkv_project_train(block.attn, cfg, h, positions,
                                       group)
    o = chunked_attention(q, k, v, causal=causal, kv_block=kv_block,
                          logit_softcap=cfg.attn_logit_softcap)
    o = o.reshape(b, s, -1)
    if not split:
        return x + o @ block.attn.wo
    n = block.attn.wo.shape[0]
    if o.shape[-1] != n:                  # every head: this rank's columns
        o = o[..., group.rank * n:(group.rank + 1) * n]
    return x + sharding.reduce_out(
        group, sharding.product_f32(o, block.attn.wo), x.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Attention of every query over every key of a contiguous, non-paged
    cache, in f32: the VLM cross layer's (no mask, no softcap).

    q: [B, S, H, D]; k/v: [B, Skv, Hkv, D] (H a multiple of Hkv). Scores
    and the softmax in f32 as the reference's ``_flash_decode_partial``
    computes them, one softmax over every key instead of 2048-key blocks
    merged online (the same function; the VLM's 1601 keys are one block
    there). Returns [B, S, H, D] in q's dtype."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qh = q.reshape(b, s, hkv, h // hkv, d).float()
    sc = torch.einsum("bshgd,bkhd->bshgk", qh, k.float()) * (1.0 / d ** 0.5)
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    o = torch.einsum("bshgk,bkhd->bshgd", p, v.float())
    l = p.sum(dim=-1, keepdim=True)
    return (o / torch.clamp(l, min=1e-30)).reshape(b, s, h, d).to(q.dtype)


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


def _requantize_row(k_codes, v_codes, k_scale, v_scale, new_k, new_v, at,
                    own=None):
    """The page holding row ``at[b]`` of every slot is dequantized, takes
    the new row (where ``own[b]``, when given; else the page comes back
    unchanged, bit for bit) and is requantized, in place."""
    b, _, page = k_codes.shape[:3]
    rows = torch.arange(b, device=at.device)
    idx = (rows[:, None], (at // page)[:, None])     # [B, 1] pages
    for codes, scale, new in ((k_codes, k_scale, new_k),
                              (v_codes, v_scale, new_v)):
        prev = scale[idx]
        x = kv_quant.dequantize_pages(codes[idx], prev)
        row = new[:, 0].float()
        if own is not None:
            row = torch.where(own[:, None, None], row, x[rows, 0, at % page])
        x[rows, 0, at % page] = row
        codes[idx], scale[idx] = kv_quant.requantize_pages(x, prev)


def _decode_int8(q, k_codes, v_codes, k_scale, v_scale, new_k, new_v, pos,
                 logit_softcap):
    """The int8 decode: the kernel attends over the codes with the new
    row at full precision; then the page holding each row's clamped
    ``pos`` is dequantized, takes the new row, and is requantized."""
    o = paged_decode(q, k_codes, v_codes, k_scale=k_scale, v_scale=v_scale,
                     new_k=new_k, new_v=new_v, pos=pos,
                     logit_softcap=logit_softcap)
    at = pos.long().clamp(0, k_codes.shape[1] * k_codes.shape[2] - 1)
    _requantize_row(k_codes, v_codes, k_scale, v_scale, new_k, new_v, at)
    return o


def combine_partials(group, o: torch.Tensor, m: torch.Tensor,
                     l: torch.Tensor) -> torch.Tensor:
    """The cross-rank combine of the reference's page-sharded decode
    (``m_g = pmax(m)``, ``l_g = psum(l e^(m - m_g))``, ``acc_g = psum(acc
    e^(m - m_g))``), in base 2 as the kernel's ``m`` is. o: f32 [B,1,H,D]
    (normalised: acc = o l); m, l: [B,H]. A rank with no visible token
    (m = -inf, l = 0) weighs 0. Returns f32 [B,1,H,D], equal on every
    rank."""
    b, _, h, d = o.shape
    m_g = group.all_reduce(m.clone(), "max")
    w = l * torch.exp2(m - torch.where(torch.isfinite(m_g), m_g, 0.0))
    packed = torch.cat([o.reshape(b, h, d) * w[..., None], w[..., None]],
                       dim=-1)
    packed = group.all_reduce(packed, "sum")
    out = packed[..., :d] / torch.clamp(packed[..., d:], min=1e-30)
    return out.reshape(b, 1, h, d)


def _sharded_decode(group, q, k_pages, v_pages, new_k, new_v, pos,
                    logit_softcap, k_scale, v_scale):
    """This rank's part of the page-sharded decode over its pages
    ``[start, start + L)`` of every slot, then the combine."""
    b, n_local, page, hkv, d = k_pages.shape
    span = n_local * page
    off = pos.long() - group.rank * span
    own = (off >= 0) & (off < span)
    at = off.clamp(0, span - 1)
    kv_len = (off + 1).clamp(0, span).to(torch.int32)
    if k_scale is None:
        rows = torch.arange(b, device=q.device)
        for buf, new in ((k_pages, new_k), (v_pages, new_v)):
            flat = buf.view(b, span, hkv, d)
            flat[rows, at] = torch.where(own[:, None, None],
                                         new[:, 0].to(buf.dtype),
                                         flat[rows, at])
        o, m, l = paged_decode(q, k_pages, v_pages, kv_len,
                               logit_softcap=logit_softcap, return_ml=True)
    else:
        fresh = torch.where(own, off, -1).to(torch.int32)
        o, m, l = paged_decode(q, k_pages, v_pages, kv_len,
                               logit_softcap=logit_softcap, k_scale=k_scale,
                               v_scale=v_scale, new_k=new_k, new_v=new_v,
                               fresh=fresh, return_ml=True)
        _requantize_row(k_pages, v_pages, k_scale, v_scale, new_k, new_v,
                        at, own)
    return combine_partials(group, o, m, l).to(q.dtype)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, new_k: torch.Tensor,
                           new_v: torch.Tensor, pos: torch.Tensor, *,
                           group=None,
                           logit_softcap: float = 0.0,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Single-token decode over each slot's KV pages (the paged-decode
    kernel).

    q: [B,1,H,D]; new_k/new_v: [B,1,Hkv,D]; pages: [B,P,page,Hkv,D];
    pos: int32 [B] per-slot positions. The new token's K/V is written in
    place at ``pos[b]`` (clamped to the last position) before slot b
    attends to positions [0, pos[b]]. Returns o [B,1,H,D]; the pages are
    updated in place. With ``k_scale``/``v_scale`` (f32 [B,P,Hkv]) the
    pages are int8 codes: the new row is attended at full precision, then
    its page is requantized and the scales grow in place.

    With a rank ``group`` of more than one rank the pages are this rank's
    shard of every slot (``parallel.sharding``): only the rank that holds
    ``pos[b]`` writes it (nothing is written past the last rank's pages,
    as in the reference's shard_map body), each rank decodes over its own
    pages and the partials combine across the ranks.
    """
    if group is not None and group.size > 1:
        return _sharded_decode(group, q, k_pages, v_pages, new_k, new_v, pos,
                               logit_softcap, k_scale, v_scale)
    if k_scale is not None:
        return _decode_int8(q, k_pages, v_pages, k_scale, v_scale, new_k,
                            new_v, pos, logit_softcap)
    b, _, _, d = q.shape
    hkv = k_pages.shape[3]
    smax = k_pages.shape[1] * k_pages.shape[2]
    write_rows(k_pages.view(b, smax, hkv, d), new_k, pos)
    write_rows(v_pages.view(b, smax, hkv, d), new_v, pos)
    kv_len = (pos + 1).to(torch.int32)
    return paged_decode(q, k_pages, v_pages, kv_len,
                        logit_softcap=logit_softcap)
