"""Plain PyTorch version of the paged weight-streaming matmul.

The same function as ``csrc/paged_matmul.cu`` (the reference's oracle,
``repro.kernels.hdm_stream.ref.paged_matmul_ref``): the CPU tests run it,
and ``chip_smoke.py`` holds the kernel against it on the card.
"""
from __future__ import annotations

import torch


def paged_matmul_ref(x: torch.Tensor, w_pages: torch.Tensor,
                     page_ids: torch.Tensor) -> torch.Tensor:
    """x: [M, K]; w_pages: [n_pages, page_k, N]; page_ids: [K // page_k]
    -> [M, N] in x's dtype, accumulated in f32."""
    n = w_pages.shape[-1]
    w = w_pages[page_ids.long()].reshape(-1, n)          # [K, N]
    return (x.float() @ w.float()).to(x.dtype)


def paged_matmul_split_ref(x: torch.Tensor, w_pages: torch.Tensor,
                           page_ids: torch.Tensor,
                           split_rows: int) -> torch.Tensor:
    """The skinny instance's split-K arithmetic written out: K cut into
    runs of ``split_rows`` rows (the last may be shorter), each run's f32
    partial product, the partials added in split order, then cast to x's
    dtype -- the order in which the last CTA of a strip merges them."""
    n = w_pages.shape[-1]
    w = w_pages[page_ids.long()].reshape(-1, n).float()  # [K, N]
    xf = x.float()
    y = None
    for k0 in range(0, x.shape[1], split_rows):
        part = xf[:, k0:k0 + split_rows] @ w[k0:k0 + split_rows]
        y = part if y is None else y + part
    return y.to(x.dtype)
