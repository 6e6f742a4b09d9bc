"""Plain PyTorch version of the chunked-prefill flash attention kernel.

The same function as ``csrc/flash_prefill.cu`` with f32 accumulation and an
exact softmax: the CPU tests run it, and ``chip_smoke.py`` holds the kernel
against it on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_prefill_ref(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, pos: torch.Tensor,
                      logit_softcap: float = 0.0) -> torch.Tensor:
    """q: [B,C,H,D]; caches [B,Smax,Hkv,D]; pos int [B] -> [B,C,H,D].

    Query i of row b attends to cache positions ``<= pos[b] + i``.
    """
    b, c, h, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    qh = q.reshape(b, c, hkv, g, d).float()
    s = torch.einsum("bchgd,bkhd->bhgck", qh, k_cache.float()) \
        * (1.0 / (d ** 0.5))
    if logit_softcap > 0.0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    limit = (pos.to(q.device).long()[:, None]
             + torch.arange(c, device=q.device)[None])          # [B, C]
    kv_pos = torch.arange(smax, device=q.device)
    visible = kv_pos[None, None, :] <= limit[:, :, None]        # [B, C, Smax]
    s = torch.where(visible[:, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgck,bkhd->bchgd", w, v_cache.float())
    return o.reshape(b, c, h, d).to(q.dtype)
