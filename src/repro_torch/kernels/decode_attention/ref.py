"""Plain PyTorch versions of the paged flash-decode kernel's two modes.

The same functions as ``csrc/paged_decode.cu`` with f32 accumulation and
an exact (not online) softmax: the CPU tests run them, and
``chip_smoke.py`` holds the kernel against them on the card.
``paged_decode_split_ref`` is the kernel's split-and-merge arithmetic
written out plainly, for the CPU tests of the plan.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def paged_decode_ref(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, kv_len: torch.Tensor,
                     logit_softcap: float = 0.0) -> torch.Tensor:
    """q: [B,1,H,D]; pages [B,P,page,Hkv,D]; kv_len int [B] -> [B,1,H,D].

    Row b attends to its first ``kv_len[b]`` cache positions (all of them
    when ``kv_len[b]`` exceeds the cache).
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
    s = torch.where(visible[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", w, v)
    return o.reshape(b, 1, h, d).to(q.dtype)


def paged_decode_int8_ref(q: torch.Tensor, k_codes: torch.Tensor,
                          v_codes: torch.Tensor, k_scale: torch.Tensor,
                          v_scale: torch.Tensor, new_k: torch.Tensor,
                          new_v: torch.Tensor, pos: torch.Tensor,
                          logit_softcap: float = 0.0) -> torch.Tensor:
    """The int8 mode. q: [B,1,H,D]; codes int8 [B,P,page,Hkv,D]; scales
    f32 [B,P,Hkv]; new_k/new_v [B,1,Hkv,D]; pos int [B] -> [B,1,H,D].

    What the reference's single-rank decode computes before it
    requantizes (``repro.models.attention.paged_decode_attention``):
    dequantize every page in f32, put the new token's K/V at ``pos[b]``
    (clamped to the last position, like ``write_rows``) at full
    precision, and attend over ``[0, pos[b]]``. The codes are not
    written.
    """
    b, p, page, hkv, d = k_codes.shape
    smax = p * page
    rows = torch.arange(b, device=q.device)
    at = pos.long().clamp(0, smax - 1)
    kv = []
    for codes, scale, new in ((k_codes, k_scale, new_k),
                              (v_codes, v_scale, new_v)):
        x = (codes.float() * scale.float()[:, :, None, :, None]).reshape(
            b, smax, hkv, d)
        x[rows, at] = new[:, 0].float()
        kv.append(x.reshape(b, p, page, hkv, d))
    kv_len = (pos.long() + 1).clamp(max=smax)
    return paged_decode_ref(q, kv[0], kv[1], kv_len, logit_softcap)


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
