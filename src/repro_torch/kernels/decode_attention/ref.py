"""Plain PyTorch version of the paged flash-decode kernel.

The same function as ``csrc/paged_decode.cu`` with f32 accumulation and an
exact (not online) softmax: the CPU tests run it, and ``chip_smoke.py``
holds the kernel against it on the card.
"""
from __future__ import annotations

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
