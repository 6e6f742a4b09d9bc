"""Wrapper of the chunked SSD scan kernel (model layout).

On a CUDA tensor it launches ``csrc/ssd_scan.cu`` (or raises); on a CPU
tensor it runs the plain chunked form (``ref.ssd_chunked_ref``). There is no
fallback from one to the other. ``launches`` counts kernel launches.

The kernel cuts the token axis into spans of whole sub-chunks of
``KERNEL_CHUNK`` tokens, one CTA per (head, span, row), scans each span
from a zero state, and chains the spans' states in order inside the launch
(``ref.ssd_split_ref`` is the same arithmetic written plainly). The SSD
computes the same function for any chunk length, so ``chunk`` only sets the
plain version's chunk (the reference's 256 was a TPU VMEM choice). The
split count is ``plan()``, a pure function of the shapes that the CPU tests
check: ``SPLITS`` spans where the sequence has that many sub-chunks (the
fastest of the counts timed at zamba2's chunk by ``chip_smoke.py``'s plan
sweep, PERF.md), one split at S <= ``KERNEL_CHUNK``. The workspace (each
span's end state and log decay, and the ticket, done count and flags of
each (row, head)) is made once per device and plan by ``_workspace``; the
kernel expects its counters at zero and leaves them so. The workspace
belongs to one stream, as the serving path's calls do: two launches that
overlap on it would draw each other's tickets, and the kernel traps on a
ticket past its splits.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mamba2_scan.ref import ssd_chunked_ref

KERNEL_CHUNK = 64
# (head_dim P, state N) pairs instantiated in csrc/ssd_scan.cu
HEAD_STATE_DIMS = ((16, 16), (64, 64))
SPLITS = 4            # spans per (row, head) where S has that many chunks
MAX_SMEM = 232448     # dynamic shared memory per block

launches = 0
_WORKSPACE = {}


@dataclasses.dataclass(frozen=True)
class Plan:
    splits: int        # spans per (row, head): grid (H, splits, B)
    span: int          # sub-chunks of KERNEL_CHUNK tokens per span
    smem_bytes: int
    part_h: tuple      # workspace shapes: f32 [B,H,splits,P,N],
    part_l: tuple      # f32 [B,H,splits],
    sync: tuple        # int32 [B,H,2+splits] (ticket, done, flags)


def split_plan(b: int, s: int, h: int, p: int, n: int, splits: int) -> Plan:
    """The launch at (at most) ``splits`` spans: the sub-chunks shared out
    as evenly as whole sub-chunks allow, every span non-empty."""
    if s < 1 or splits < 1:
        raise ValueError(f"{s} tokens in {splits} splits")
    if (p, n) not in HEAD_STATE_DIMS:
        raise ValueError(f"(head_dim, state) {(p, n)} not in "
                         f"{HEAD_STATE_DIMS}")
    n_sub = -(-s // KERNEL_CHUNK)
    span = -(-n_sub // min(splits, n_sub))
    splits = -(-n_sub // span)
    smem = 4 * (KERNEL_CHUNK * (p + 4) + 2 * KERNEL_CHUNK * (n + 4)
                + p * (n + 4) + 2 * KERNEL_CHUNK)
    return Plan(splits=splits, span=span, smem_bytes=smem,
                part_h=(b, h, splits, p, n), part_l=(b, h, splits),
                sync=(b, h, 2 + splits))


@functools.lru_cache(maxsize=None)
def plan(b: int, s: int, h: int, p: int, n: int) -> Plan:
    """The launch of ``csrc/ssd_scan.cu`` for xdt [b,s,h,p], state n:
    ``SPLITS`` spans (fewer where S has fewer sub-chunks)."""
    return split_plan(b, s, h, p, n, SPLITS)


def check_plan(pl: Plan, b: int, s: int, h: int, p: int, n: int) -> None:
    """Raise ValueError unless ``pl`` is ``split_plan``'s at its split
    count (spans covering [0, s) once, every span non-empty; its shared
    memory and workspace shapes) and fits the block's shared memory. The
    C entry checks the spans and shared memory again."""
    if pl.splits < 1 or pl != split_plan(b, s, h, p, n, pl.splits) or (
            pl.smem_bytes > MAX_SMEM):
        raise ValueError(f"ssd_scan refuses plan {pl} for S = {s}")


def _workspace(device: torch.device, pl: Plan):
    """The span states, log decays and counters of ``pl`` on ``device``,
    made once (the counters zeroed)."""
    key = (device, pl.part_h)
    ws = _WORKSPACE.get(key)
    if ws is None:
        ws = (torch.empty(pl.part_h, dtype=torch.float32, device=device),
              torch.empty(pl.part_l, dtype=torch.float32, device=device),
              torch.zeros(pl.sync, dtype=torch.int32, device=device))
        _WORKSPACE[key] = ws
    return ws


def ssd(xdt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
        log_a: torch.Tensor, *, h0: Optional[torch.Tensor] = None,
        chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """xdt [B,S,H,P] f32; b/c [B,S,N] f32; log_a [B,S,H] f32 (per-step log
    decay); h0 [B,H,P,N] f32 or None (zero) -> (y [B,S,H,P] f32, h_last
    [B,H,P,N] f32), any S >= 1. No backward: inputs that require grad are
    refused under grad on both devices (the training forward runs the
    plain ``models.mamba2.mamba_apply``)."""
    build.refuse_grad("ssd", xdt, bmat, cmat, log_a, h0)
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
    return launch(xdt, bmat, cmat, log_a, h0, plan(b, s, h, p, n))


def launch(xdt, bmat, cmat, log_a, h0, pl: Plan):
    """One launch of the kernel at plan ``pl`` on inputs that ``ssd`` has
    checked (``chip_smoke.py`` also times other split counts through
    it)."""
    global launches
    b, s, h, p = xdt.shape
    n = bmat.shape[2]
    check_plan(pl, b, s, h, p, n)
    part_h, part_l, sync = _workspace(xdt.device, pl)
    y = torch.empty_like(xdt)
    h_last = torch.empty((b, h, p, n), dtype=torch.float32,
                         device=xdt.device)
    lib = build.library()
    rc = lib.repro_ssd_scan(
        xdt.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), log_a.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_last.data_ptr(), part_h.data_ptr(), part_l.data_ptr(),
        sync.data_ptr(), b, s, h, p, n, pl.splits, pl.span, pl.smem_bytes,
        build.stream_ptr(xdt.device))
    launches += 1
    build.check(rc, "ssd_scan")
    return y, h_last
