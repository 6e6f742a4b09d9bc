"""Wrapper of the paged weight-streaming matmul kernel.

On a CUDA tensor it launches ``csrc/paged_matmul.cu`` (or raises); on a
CPU tensor it runs the plain version (``ref.paged_matmul_ref``). There is
no fallback from one to the other. ``launches`` counts kernel launches.

No serving or training path of the reference calls this op: its serving
engine drops the speculative-read weight prefetch on one device, and only
the kernel tests call ``stream_matmul``. It is ported as that op.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.hdm_stream.ref import paged_matmul_ref

launches = 0


def stream_matmul(x: torch.Tensor, w_pages: torch.Tensor,
                  page_ids: torch.Tensor) -> torch.Tensor:
    """y = x @ vstack(w_pages[page_ids]).

    x: [M, K]; w_pages: [n_pages, page_k, N] in x's dtype; page_ids int32
    [K // page_k], each in [0, n_pages). Returns [M, N] in x's dtype, f32
    accumulation. M and N need not divide any tile.
    """
    global launches
    if x.dim() != 2 or w_pages.dim() != 3 or page_ids.dim() != 1:
        raise ValueError(f"expected x [M,K], w_pages [n_pages,page_k,N] and "
                         f"page_ids [K/page_k], got {tuple(x.shape)} / "
                         f"{tuple(w_pages.shape)} / {tuple(page_ids.shape)}")
    m, k = x.shape
    n_pages, page_k, n = w_pages.shape
    if k % page_k or page_ids.shape[0] != k // page_k:
        raise ValueError(f"K {k} is not {page_ids.shape[0]} pages of "
                         f"{page_k} rows")
    if x.dtype != w_pages.dtype:
        raise TypeError("x and w_pages must share one dtype")
    devices = {x.device, w_pages.device, page_ids.device}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {devices}")
    if x.device.type == "cpu":
        return paged_matmul_ref(x, w_pages, page_ids)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in build.DTYPE_CODES:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if page_ids.dtype != torch.int32:
        raise TypeError("page_ids must be int32")
    for name, t in (("x", x), ("w_pages", w_pages), ("page_ids", page_ids)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = build.library().repro_paged_matmul(
        x.data_ptr(), w_pages.data_ptr(), page_ids.data_ptr(), y.data_ptr(),
        m, k, n, page_k, n_pages, build.DTYPE_CODES[x.dtype],
        build.stream_ptr(x.device))
    launches += 1
    build.check(rc, "paged_matmul")
    return y
