"""Wrapper of the paged flash-decode kernel (model layout).

On a CUDA tensor it launches ``csrc/paged_decode.cu`` (or raises); on a
CPU tensor it runs the plain version (``ref.paged_decode_ref``). There is no
fallback from one to the other. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import paged_decode_ref

SPLIT_TOKENS = 256   # tokens per CTA of pass 1 (one page at the path's
                     # shapes)
MAX_GROUP = 8        # query heads per kv head the kernel takes

launches = 0


def split_count(smax: int) -> int:
    """Pass-1 CTAs per (slot, kv head) for a cache of ``smax`` tokens."""
    return -(-smax // SPLIT_TOKENS)


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, kv_len: torch.Tensor, *,
                 logit_softcap: float = 0.0) -> torch.Tensor:
    """q: [B,1,H,D]; pages [B,P,page,Hkv,D]; kv_len int32 [B] -> [B,1,H,D].

    Row b attends to its first ``min(kv_len[b], P*page)`` positions.
    """
    global launches
    if q.dim() != 4 or q.shape[1] != 1 or k_pages.dim() != 5:
        raise ValueError(f"expected q [B,1,H,D] and pages [B,P,page,Hkv,D], "
                         f"got {tuple(q.shape)} / {tuple(k_pages.shape)}")
    b, _, h, d = q.shape
    _, p, page, hkv, dk = k_pages.shape
    if (k_pages.shape != v_pages.shape or k_pages.shape[0] != b or dk != d
            or h % hkv or kv_len.shape != (b,)):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, "
                         f"kv_len {tuple(kv_len.shape)}")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError("q and the pages must share one dtype")
    devices = {q.device, k_pages.device, v_pages.device, kv_len.device}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {devices}")
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pages, v_pages, kv_len, logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in build.DTYPE_CODES:
        raise TypeError(f"unsupported dtype {q.dtype}")
    if kv_len.dtype != torch.int32:
        raise TypeError("kv_len must be int32")
    if h // hkv > MAX_GROUP:
        raise ValueError(f"at most {MAX_GROUP} query heads per kv head")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("kv_len", kv_len)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    smax = p * page
    n_splits = split_count(smax)
    g = h // hkv
    out = torch.empty_like(q)
    part_acc = torch.empty((b, hkv, n_splits, g, d), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, hkv, n_splits, g, 2), dtype=torch.float32,
                          device=q.device)
    lib = build.library()
    rc = lib.repro_paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), b, h, hkv, smax, d, SPLIT_TOKENS, n_splits,
        build.DTYPE_CODES[q.dtype], 1.0 / (d ** 0.5), float(logit_softcap),
        build.stream_ptr(q.device))
    launches += 1
    build.check(rc, "paged_decode")
    return out
