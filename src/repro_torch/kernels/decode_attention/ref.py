"""Plain PyTorch versions of the paged flash-decode kernel's two modes.

The same functions as ``csrc/paged_decode.cu`` with f32 accumulation and
an exact (not online) softmax: the CPU tests run them, and
``chip_smoke.py`` holds the kernel against them on the card.
``paged_decode_split_ref`` is the kernel's split-and-merge arithmetic
written out plainly, for the CPU tests of the plan;
``paged_decode_mma_ref`` and ``paged_decode_int8_mma_ref`` are the
tensor-core instance's (P.V with p in two bf16 parts, int8 scales folded
into S and P), held to the reference's Pallas kernel on the CPU.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def paged_decode_ref(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, kv_len: torch.Tensor,
                     logit_softcap: float = 0.0, *, return_ml: bool = False):
    """q: [B,1,H,D]; pages [B,P,page,Hkv,D]; kv_len int [B] -> [B,1,H,D].

    Row b attends to its first ``kv_len[b]`` cache positions (all of them
    when ``kv_len[b]`` exceeds the cache). With ``return_ml`` returns
    ``(o f32, m, l)`` as the kernel does: each (slot, query head)'s max
    ``m`` of the log2 e-scaled logits and sum ``l = sum 2^(s - m)``, [B,
    H]; a row with no visible position gives m = -inf, l = 0, o = 0.
    """
    b, _, h, d = q.shape
    _, p, page, hkv, _ = k_pages.shape
    g = h // hkv
    smax = p * page
    k = k_pages.reshape(b, smax, hkv, d).float()
    v = v_pages.reshape(b, smax, hkv, d).float()
    qh = q.reshape(b, hkv, g, d).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qh, k) * (1.0 / (d ** 0.5))
    if logit_softcap > 0.0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    kv_pos = torch.arange(smax, device=q.device)
    visible = kv_pos[None, :] < kv_len.to(q.device)[:, None].long()
    if return_ml:
        s = torch.where(visible[:, None, None, :], s / math.log(2.0),
                        -math.inf)
        m = s.amax(dim=-1)
        e = torch.exp2(s - torch.where(torch.isfinite(m), m, 0.0)[..., None])
        l = e.sum(dim=-1)
        o = torch.einsum("bhgk,bkhd->bhgd", e, v) / torch.clamp(
            l, min=1e-30)[..., None]
        return o.reshape(b, 1, h, d), m.reshape(b, h), l.reshape(b, h)
    s = torch.where(visible[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", w, v)
    return o.reshape(b, 1, h, d).to(q.dtype)


def int8_rows(pos: torch.Tensor, smax: int):
    """The one-rank int8 mode's ``(kv_len, fresh)`` for per-slot ``pos``:
    row b attends over ``[0, min(pos+1, Smax))`` with the new token at
    ``min(pos, Smax - 1)`` (clamped, like ``write_rows``)."""
    return ((pos + 1).clamp(max=smax).to(torch.int32),
            pos.clamp(max=smax - 1).to(torch.int32))


def paged_decode_int8_ref(q: torch.Tensor, k_codes: torch.Tensor,
                          v_codes: torch.Tensor, k_scale: torch.Tensor,
                          v_scale: torch.Tensor, new_k: torch.Tensor,
                          new_v: torch.Tensor, pos: torch.Tensor = None,
                          logit_softcap: float = 0.0, *,
                          kv_len: torch.Tensor = None,
                          fresh: torch.Tensor = None,
                          return_ml: bool = False):
    """The int8 mode. q: [B,1,H,D]; codes int8 [B,P,page,Hkv,D]; scales
    f32 [B,P,Hkv]; new_k/new_v [B,1,Hkv,D]; pos int [B] -> [B,1,H,D].

    What the reference's decode computes before it requantizes
    (``repro.models.attention.paged_decode_attention``): dequantize every
    page in f32, put the new token's K/V at row ``fresh[b]`` at full
    precision (no row where ``fresh[b] < 0``), and attend over ``[0,
    kv_len[b])``. One rank gives ``pos`` (``int8_rows``: the row at
    ``pos[b]`` clamped to the last position, like ``write_rows``, over
    ``[0, pos[b]]``); a rank of a page-sharded cache its local ``kv_len``
    and ``fresh``. The codes are not written. ``return_ml`` as in
    ``paged_decode_ref``.
    """
    b, p, page, hkv, d = k_codes.shape
    smax = p * page
    if pos is not None:
        kv_len, fresh = int8_rows(pos, smax)
    rows = torch.arange(b, device=q.device)
    own = fresh >= 0
    at = fresh.long().clamp(min=0)
    kv = []
    for codes, scale, new in ((k_codes, k_scale, new_k),
                              (v_codes, v_scale, new_v)):
        x = (codes.float() * scale.float()[:, :, None, :, None]).reshape(
            b, smax, hkv, d)
        x[rows, at] = torch.where(own[:, None, None], new[:, 0].float(),
                                  x[rows, at])
        kv.append(x.reshape(b, p, page, hkv, d))
    return paged_decode_ref(q, kv[0], kv[1], kv_len, logit_softcap,
                            return_ml=return_ml)


def paged_decode_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, kv_len: torch.Tensor,
                           split: int,
                           logit_softcap: float = 0.0) -> torch.Tensor:
    """``paged_decode_ref`` computed as the kernel computes it: per split
    of ``split`` tokens, the unnormalised partial ``acc`` with its max
    ``m`` and sum ``l`` (in f32, base 2), then the splits that hold a
    visible token merged in split order with the max/sum rescale. A slot
    with no visible token gives zeros."""
    b, _, h, d = q.shape
    _, p, page, hkv, _ = k_pages.shape
    g = h // hkv
    smax = p * page
    k = k_pages.reshape(b, smax, hkv, d).float()
    v = v_pages.reshape(b, smax, hkv, d).float()
    qh = q.reshape(b, hkv, g, d).float()
    out = torch.zeros(b, hkv, g, d)
    log2e = 1.0 / math.log(2.0)
    for i in range(b):
        n = min(int(kv_len[i]), smax)
        parts = []
        for t0 in range(0, n, split):
            t1 = min(n, t0 + split)
            s = torch.einsum("hgd,khd->hgk", qh[i], k[i, t0:t1]) / d ** 0.5
            if logit_softcap > 0.0:
                s = logit_softcap * torch.tanh(s / logit_softcap)
            s = s * log2e
            m = s.amax(-1)                                  # [hkv, g]
            e = torch.exp2(s - m[..., None])
            parts.append((torch.einsum("hgk,khd->hgd", e, v[i, t0:t1]),
                          m, e.sum(-1)))
        if not parts:
            continue
        m_all = torch.stack([m for _, m, _ in parts]).amax(0)
        acc, l = torch.zeros(hkv, g, d), torch.zeros(hkv, g)
        for a, m, s_ in parts:                              # split order
            w = torch.exp2(m - m_all)
            acc, l = acc + a * w[..., None], l + s_ * w
        out[i] = acc / l[..., None]
    return out.reshape(b, 1, h, d).to(q.dtype)


def _split_bf16(x: torch.Tensor) -> torch.Tensor:
    """x as the kernel multiplies it: a bf16 high part plus the bf16
    rounding of the rest (~2^-17 relative)."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float()


def _mma_decode(q, k, v, k_row_scale, v_row_scale, kv_len, split,
                logit_softcap, return_ml):
    """The tensor-core instance over flat K/V [B, Smax, Hkv, D] as its
    tiles hold them, with each row's K and V scale [B, Smax, Hkv]."""
    b, _, h, d = q.shape
    smax, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qh = q.reshape(b, hkv, g, d).float()
    out = torch.zeros(b, hkv, g, d)
    m_out = torch.full((b, hkv, g), -math.inf)
    l_out = torch.zeros(b, hkv, g)
    log2e = 1.0 / math.log(2.0)
    for i in range(b):
        n = min(int(kv_len[i]), smax)
        parts = []
        for t0 in range(0, n, split):
            t1 = min(n, t0 + split)
            ks = k_row_scale[i, t0:t1].T[:, None]           # [hkv, 1, k]
            vs = v_row_scale[i, t0:t1].T[:, None]
            s = torch.einsum("hgd,khd->hgk", qh[i], k[i, t0:t1].float())
            s = s * ks / d ** 0.5
            if logit_softcap > 0.0:
                s = logit_softcap * torch.tanh(s / logit_softcap)
            s = s * log2e
            m = s.amax(-1)                                  # [hkv, g]
            e = torch.exp2(s - m[..., None])
            parts.append((torch.einsum("hgk,khd->hgd", _split_bf16(e * vs),
                                       v[i, t0:t1].float()),
                          m, e.sum(-1)))
        if not parts:
            continue
        m_all = torch.stack([m for _, m, _ in parts]).amax(0)
        acc, l = torch.zeros(hkv, g, d), torch.zeros(hkv, g)
        for a, m, s_ in parts:                              # split order
            w = torch.exp2(m - m_all)
            acc, l = acc + a * w[..., None], l + s_ * w
        out[i] = acc / l[..., None]
        m_out[i], l_out[i] = m_all, l
    if return_ml:
        return out.reshape(b, 1, h, d), m_out.reshape(b, h), l_out.reshape(
            b, h)
    return out.reshape(b, 1, h, d).to(q.dtype)


def paged_decode_mma_ref(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, kv_len: torch.Tensor,
                         split: int, logit_softcap: float = 0.0, *,
                         return_ml: bool = False):
    """The tensor-core instance's arithmetic written out plainly: per
    split of ``split`` tokens, S = q K^T in f32 from q and K as given, the
    base-2 max ``m`` and ``p = 2^(s - m)``; ``l`` sums p in f32, and P.V
    takes p as a bf16 high part plus the bf16 rounding of the rest
    (~2^-17 relative) against V; the splits that hold a visible token are
    merged in split order. ``return_ml`` as in ``paged_decode_ref``."""
    b, p, page, hkv, d = k_pages.shape
    flat = (b, p * page, hkv, d)
    ones = torch.ones(b, p * page, hkv)
    return _mma_decode(q, k_pages.reshape(flat), v_pages.reshape(flat), ones,
                       ones, kv_len, split, logit_softcap, return_ml)


def paged_decode_int8_mma_ref(q: torch.Tensor, k_codes: torch.Tensor,
                              v_codes: torch.Tensor, k_scale: torch.Tensor,
                              v_scale: torch.Tensor, new_k: torch.Tensor,
                              new_v: torch.Tensor, pos: torch.Tensor = None,
                              logit_softcap: float = 0.0, *, split: int,
                              kv_len: torch.Tensor = None,
                              fresh: torch.Tensor = None,
                              return_ml: bool = False):
    """The int8 mode on the tensor-core instance: the codes as they are
    (exact in bf16), the row ``fresh[b]`` replaced by new_k / new_v as
    given, and the page scales folded in where that is exact: each row's
    K scale into S's column, its V scale into P's (1 on the new row); then
    ``paged_decode_mma_ref``'s arithmetic. Arguments as
    ``paged_decode_int8_ref``'s."""
    b, p, page, hkv, d = k_codes.shape
    smax = p * page
    if pos is not None:
        kv_len, fresh = int8_rows(pos, smax)
    rows = torch.arange(b, device=q.device)
    own = fresh >= 0
    at = fresh.long().clamp(min=0)
    kv, row_scale = [], []
    for codes, scale, new in ((k_codes, k_scale, new_k),
                              (v_codes, v_scale, new_v)):
        x = codes.float().reshape(b, smax, hkv, d)
        x[rows, at] = torch.where(own[:, None, None], new[:, 0].float(),
                                  x[rows, at])
        sc = scale.float().repeat_interleave(page, dim=1)    # [B, Smax, Hkv]
        sc[rows, at] = torch.where(own[:, None], 1.0, sc[rows, at])
        kv.append(x)
        row_scale.append(sc)
    return _mma_decode(q, kv[0], kv[1], row_scale[0], row_scale[1], kv_len,
                       split, logit_softcap, return_ml)
