"""Wrapper of the chunked SSD scan kernel (model layout).

On a CUDA tensor it launches ``csrc/ssd_scan.cu`` (or raises); on a CPU
tensor it runs the plain chunked form (``ref.ssd_chunked_ref``). There is no
fallback from one to the other. ``launches`` counts kernel launches.

The kernel walks each (row, head) in sub-chunks of ``KERNEL_CHUNK`` tokens,
its own choice: the SSD computes the same function for any chunk length, so
``chunk`` only sets the plain version's chunk (the reference's 256 was a
TPU VMEM choice).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mamba2_scan.ref import ssd_chunked_ref

KERNEL_CHUNK = 64
# (head_dim P, state N) pairs instantiated in csrc/ssd_scan.cu
HEAD_STATE_DIMS = ((16, 16), (64, 64))

launches = 0


def ssd(xdt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
        log_a: torch.Tensor, *, h0: Optional[torch.Tensor] = None,
        chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """xdt [B,S,H,P] f32; b/c [B,S,N] f32; log_a [B,S,H] f32 (per-step log
    decay); h0 [B,H,P,N] f32 or None (zero) -> (y [B,S,H,P] f32, h_last
    [B,H,P,N] f32), any S >= 1."""
    global launches
    if xdt.dim() != 4 or bmat.dim() != 3 or log_a.dim() != 3:
        raise ValueError(f"expected xdt [B,S,H,P], b/c [B,S,N], log_a "
                         f"[B,S,H], got {tuple(xdt.shape)} / "
                         f"{tuple(bmat.shape)} / {tuple(log_a.shape)}")
    b, s, h, p = xdt.shape
    n = bmat.shape[2]
    if (cmat.shape != bmat.shape or bmat.shape[:2] != (b, s)
            or log_a.shape != (b, s, h) or s < 1
            or (h0 is not None and h0.shape != (b, h, p, n))):
        raise ValueError(f"shape mismatch: xdt {tuple(xdt.shape)}, b "
                         f"{tuple(bmat.shape)}, c {tuple(cmat.shape)}, "
                         f"log_a {tuple(log_a.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)}")
    tensors = [("xdt", xdt), ("b", bmat), ("c", cmat), ("log_a", log_a)]
    if h0 is not None:
        tensors.append(("h0", h0))
    for name, t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    devices = {t.device for _, t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {devices}")
    if xdt.device.type == "cpu":
        return ssd_chunked_ref(xdt, bmat, cmat, log_a, h0, chunk)
    if xdt.device.type != "cuda":
        raise ValueError(f"unsupported device {xdt.device}")
    if (p, n) not in HEAD_STATE_DIMS:
        raise ValueError(f"(head_dim, state) {(p, n)} not in "
                         f"{HEAD_STATE_DIMS}")
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    y = torch.empty_like(xdt)
    h_last = torch.empty((b, h, p, n), dtype=torch.float32,
                         device=xdt.device)
    lib = build.library()
    rc = lib.repro_ssd_scan(
        xdt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), log_a.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_last.data_ptr(), b, s, h, p, n, build.stream_ptr(xdt.device))
    launches += 1
    build.check(rc, "ssd_scan")
    return y, h_last
