"""Plain PyTorch version of the chunked-prefill flash attention kernel.

The same function as ``csrc/flash_prefill.cu`` with f32 accumulation and an
exact softmax: the CPU tests run it, and ``chip_smoke.py`` holds the kernel
against it on the card. Its two products go through ``mm`` and ``mm_pv``
(f32 ``torch.matmul`` by default, ``mm_pv`` defaulting to ``mm``; the CPU
tests pass ``tf32`` products to show the f32 kernels' tensor-core
arithmetic meets the f32 tolerance). ``flash_prefill_tiled_ref`` is the
Hopper instance's arithmetic (online softmax over key tiles, p rounded to
V's dtype for P.V), held to the reference's Pallas kernel on the CPU.
"""
from __future__ import annotations

import math

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


def flash_prefill_tiled_ref(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, pos: torch.Tensor,
                            logit_softcap: float = 0.0,
                            keys: int = 128) -> torch.Tensor:
    """``flash_prefill_ref``'s function computed as the Hopper instance
    computes it: key tiles of ``keys`` in order, each row's base-2 running
    max and sum in f32 (rescaled once a tile), p = 2^(s - m) summed in f32
    and rounded to V's dtype for P.V (bf16: as the reference's Pallas
    kernel's ``p.astype(v.dtype)``), the output divided once at the end."""
    b, c, h, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    qh = q.reshape(b, c, hkv, g, d).float().permute(0, 2, 3, 1, 4)
    limit = (pos.long()[:, None] + torch.arange(c)[None]).clamp(
        max=smax - 1)                                          # [B, C]
    m = torch.full((b, hkv, g, c), -math.inf)
    l = torch.zeros(b, hkv, g, c)
    acc = torch.zeros(b, hkv, g, c, d)
    log2e = 1.0 / math.log(2.0)
    for k0 in range(0, int(limit.max()) + 1, keys):
        kt, vt = (t[:, k0:k0 + keys].permute(0, 2, 1, 3)[:, :, None]
                  for t in (k_cache, v_cache))                 # [B,Hkv,1,T,D]
        s = torch.matmul(qh, kt.float().transpose(-1, -2)) / d ** 0.5
        if logit_softcap > 0.0:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        s = s * log2e
        key = k0 + torch.arange(kt.shape[3])
        visible = key[None, None, :] <= limit[:, :, None]      # [B, C, T]
        s = torch.where(visible[:, None, None], s, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        base = torch.where(m_new == -math.inf, 0.0, m_new)
        p = torch.exp2(s - base[..., None])
        alpha = torch.exp2(m - base)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.matmul(
            p.to(v_cache.dtype).float(), vt.float())
        m = m_new
    o = (acc / l.clamp(min=1e-30)[..., None]).permute(0, 3, 1, 2, 4)
    return o.reshape(b, c, h, d).to(q.dtype)
