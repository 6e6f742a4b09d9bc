"""Gradient compression: int8 with per-block scales and error feedback.

On the reference's multi-pod mesh the pod-axis reduction crosses the slow
inter-pod links, so it may compress the gradient to int8 with one absmax
scale per block of 256 values and carry an error-feedback residual through
the optimizer loop (the residual restores unbiasedness over steps). The
arithmetic is the reference's (``repro/optim/compression.py``): f32
division, round half to even and the clip to [-127, 127] give the same
codes and scales bit for bit. Works leaf by leaf on a list of tensors.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

BLOCK = 256


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes [n_blocks, BLOCK] and f32 absmax scales [n_blocks, 1]."""
    flat = x.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.shape[0]) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
                dtype) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


def compress_leaf(g: torch.Tensor, residual: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The error-feedback int8 round trip of one gradient: returns (the
    decompressed gradient in g's dtype, the new f32 residual)."""
    g32 = g.float() + residual
    q, scale = _quantize(g32)
    deq = _dequantize(q, scale, g.shape, torch.float32)
    return deq.to(g.dtype), g32 - deq


def init_residuals(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Zero f32 residuals shaped like ``params``, on their devices."""
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in params]


def compress_grads(grads: Sequence[torch.Tensor],
                   residuals: Sequence[torch.Tensor]
                   ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """int8-EF compression leaf by leaf: (grads', residuals')."""
    out = [compress_leaf(g, r) for g, r in zip(grads, residuals)]
    return [o[0] for o in out], [o[1] for o in out]


def compressed_bytes(tensors: Sequence[torch.Tensor]) -> int:
    """Wire bytes per step under int8 codes plus one f32 scale a block."""
    total = 0
    for t in tensors:
        n = t.numel()
        total += n + 4 * (-(-n // BLOCK))
    return total
