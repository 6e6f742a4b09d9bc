"""Wrapper of the chunked-prefill flash attention kernel (model layout).

On a CUDA tensor it launches ``csrc/flash_prefill.cu`` (or raises); on a
CPU tensor it runs the plain version (``ref.flash_prefill_ref``). There is
no fallback from one to the other. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_prefill_ref

HEAD_DIMS = (16, 32, 64, 80, 128, 256)   # instantiated in csrc/flash_prefill.cu

launches = 0


def flash_prefill(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, pos: torch.Tensor, *,
                  logit_softcap: float = 0.0) -> torch.Tensor:
    """q: [B,C,H,D]; caches [B,Smax,Hkv,D]; pos int32 [B] -> [B,C,H,D].

    Query i of row b attends to cache positions ``<= pos[b] + i``; the
    chunk's own K/V must already be written at ``[pos[b], pos[b] + C)``.
    """
    global launches
    if q.dim() != 4 or k_cache.dim() != 4:
        raise ValueError(f"expected q [B,C,H,D] and caches [B,Smax,Hkv,D], "
                         f"got {tuple(q.shape)} / {tuple(k_cache.shape)}")
    b, c, h, d = q.shape
    _, smax, hkv, dk = k_cache.shape
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != b or dk != d
            or h % hkv or pos.shape != (b,)):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}, "
                         f"pos {tuple(pos.shape)}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError("q and the caches must share one dtype")
    devices = {q.device, k_cache.device, v_cache.device, pos.device}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {devices}")
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k_cache, v_cache, pos, logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in build.DTYPE_CODES:
        raise TypeError(f"unsupported dtype {q.dtype}")
    if pos.dtype != torch.int32:
        raise TypeError("pos must be int32")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty_like(q)
    lib = build.library()
    rc = lib.repro_flash_prefill(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        out.data_ptr(), b, c, h, hkv, smax, d, build.DTYPE_CODES[q.dtype],
        1.0 / (d ** 0.5), float(logit_softcap), build.stream_ptr(q.device))
    launches += 1
    build.check(rc, "flash_prefill")
    return out
