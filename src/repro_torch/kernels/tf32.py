"""Plain PyTorch versions of the kernels' tensor-core f32 arithmetic.

``csrc/common.cuh`` runs f32 products on tensor cores in TF32, whose
inputs keep 10 of f32's 23 mantissa bits. One TF32 product loses ~2^-11
relative per term; the error-compensated form splits each operand once
into ``hi`` (x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: nearest,
ties away from zero) and ``lo = x - hi``, which the tensor core reads
truncated to TF32, and sums ``lo.hi + hi.lo + hi.hi`` in f32, dropping
only ``lo.lo`` (~2^-22). Products of TF32 values are exact in f32, so a
CPU f32 matmul of the split operands is the tensor core's product up to
the order of the f32 sums. The CPU tests hold the kernels' plain versions
computed with these products to the f32 ones (``matmul_3xtf32_parts``:
the f32 D 256 prefill's Q K^T, summed over four quarters of the head dim).
"""
from __future__ import annotations

import torch

_LOW_BITS = 0x1FFF        # the 13 mantissa bits TF32 drops
_HALF = 0x1000            # half of TF32's last place


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32 as ``cvt.rna.tf32.f32`` does, kept in
    f32: the magnitude's last 13 mantissa bits rounded away, ties away
    from zero (finite inputs)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + _HALF) & ~_LOW_BITS).view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) as the tensor core reads it as a TF32 operand: the last
    13 mantissa bits dropped."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & ~_LOW_BITS).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """``x = hi + lo`` to ~2^-21: hi rounded to TF32, lo = x - hi
    truncated to TF32, as the kernels split an operand."""
    hi = tf32_round(x)
    return hi, tf32_truncate(x.float() - hi)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 product, f32 accumulate."""
    return torch.matmul(tf32_round(a), tf32_round(b))


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The error-compensated 3xTF32 product, f32 accumulate."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo)
            + torch.matmul(a_hi, b_hi))


def matmul_3xtf32_parts(a: torch.Tensor, b: torch.Tensor,
                        parts: int) -> torch.Tensor:
    """``a @ b`` in 3xTF32 with the contraction axis cut into ``parts``
    equal slices, their products added in slice order: ((p0 + p1) + p2)
    + ... -- as the warps that own a slice each add their partials."""
    k = a.shape[-1] // parts
    out = None
    for i in range(parts):
        p = matmul_3xtf32(a[..., i * k:(i + 1) * k],
                          b[..., i * k:(i + 1) * k, :])
        out = p if out is None else out + p
    return out
