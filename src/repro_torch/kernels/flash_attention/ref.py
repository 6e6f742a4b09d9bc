"""Plain PyTorch version of the chunked-prefill flash attention kernel.

The same function as ``csrc/flash_prefill.cu`` with f32 accumulation and an
exact softmax: the CPU tests run it, and ``chip_smoke.py`` holds the kernel
against it on the card. Its two products go through ``mm`` and ``mm_pv``
(f32 ``torch.matmul`` by default, ``mm_pv`` defaulting to ``mm``; the CPU
tests pass ``tf32`` products to show the f32 kernels' tensor-core
arithmetic meets the f32 tolerance).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_prefill_ref(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, pos: torch.Tensor,
                      logit_softcap: float = 0.0,
                      mm=torch.matmul, mm_pv=None) -> torch.Tensor:
    """q: [B,C,H,D]; caches [B,Smax,Hkv,D]; pos int [B] -> [B,C,H,D].

    Query i of row b attends to cache positions ``<= pos[b] + i``.
    """
    b, c, h, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    qh = q.reshape(b, c, hkv, g, d).float().permute(0, 2, 3, 1, 4)
    kh, vh = (t.float().permute(0, 2, 1, 3)[:, :, None]        # [B,Hkv,1,S,D]
              for t in (k_cache, v_cache))
    s = mm(qh, kh.transpose(-1, -2)) * (1.0 / (d ** 0.5))      # [B,Hkv,G,C,S]
    if logit_softcap > 0.0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    limit = (pos.to(q.device).long()[:, None]
             + torch.arange(c, device=q.device)[None])          # [B, C]
    kv_pos = torch.arange(smax, device=q.device)
    visible = kv_pos[None, None, :] <= limit[:, :, None]        # [B, C, Smax]
    s = torch.where(visible[:, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = (mm_pv or mm)(w, vh).permute(0, 3, 1, 2, 4)            # [B,C,Hkv,G,D]
    return o.reshape(b, c, h, d).to(q.dtype)
