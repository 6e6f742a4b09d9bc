"""Int8 KV page quantization with per-(page, head) fp32 scales.

The port of the reference's ``repro.models.kv_quant`` with the same
arithmetic, so that codes and scales are bit-identical to it on the same
f32 input: amax over the (page, D) axes in f32, ``max(amax, 1e-20) / 127``,
a monotone ``max`` with the previous scale, a multiply by the reciprocal,
round half to even (``torch.round``, like ``jnp.round``), clip to ±127.

Page layout: a quantized KV leaf keeps the ``[..., n_pages, page, Hkv, D]``
geometry of the bf16 cache but stores int8 codes, plus a sibling f32 scale
leaf ``[..., n_pages, Hkv]``. Dequantization is ``q.float() * scale``
broadcast over the (page, D) axes.

Scales grow monotonically (``new = max(old, amax/127)``): a page that is
dequantized and requantized unchanged keeps its codes and its scale bit for
bit. That keeps tier flush -> restore -> decode round trips byte-exact, and
it lets the serving path requantize only the pages a step wrote: every
other page would come back unchanged from the reference's whole-cache pass.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

# ServeConfig / RunConfig kv_quant spellings; "fp8" is reserved.
KV_QUANT_MODES: Tuple[str, ...] = ("none", "int8", "fp8")

# symmetric int8 code range [-127, 127]
QMAX = 127.0

# amax floor: an all-zero (or subnormal) page still gets a normal,
# positive f32 scale (1e-20 / 127 ~= 7.9e-23)
SCALE_FLOOR = 1e-20

# scale of a freshly initialised (all-zero) page
INIT_SCALE = SCALE_FLOOR / QMAX


def validate_mode(mode: str) -> str:
    """Validate a kv_quant mode string; returns it unchanged.

    Raises ValueError for unknown spellings and for the reserved "fp8".
    """
    if mode not in KV_QUANT_MODES:
        raise ValueError(
            f"kv_quant={mode!r} unknown (expected one of {KV_QUANT_MODES})")
    if mode == "fp8":
        raise ValueError(
            "kv_quant='fp8' is reserved but not implemented yet; "
            "use 'none' or 'int8'")
    return mode


def page_scales(x: torch.Tensor,
                prev_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-(page, head) symmetric scales for ``x``: [..., P, page, Hkv, D].

    Returns f32 ``[..., P, Hkv]``; with ``prev_scale`` the elementwise
    maximum of old and new (monotone growth).
    """
    amax = x.float().abs().amax(dim=(-3, -1))
    scale = torch.clamp_min(amax, SCALE_FLOOR) / QMAX
    if prev_scale is not None:
        scale = torch.maximum(scale, prev_scale.float())
    return scale


def quantize_pages(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize ``x`` [..., P, page, Hkv, D] to int8 with ``scale``
    [..., P, Hkv]: round to nearest even, clipped to [-127, 127]."""
    inv = (1.0 / scale)[..., :, None, :, None]
    q = torch.round(x.float() * inv)
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def dequantize_pages(q: torch.Tensor, scale: torch.Tensor,
                     dtype=torch.float32) -> torch.Tensor:
    """Dequantize int8 pages ``q`` [..., P, page, Hkv, D] to ``dtype``."""
    x = q.float() * scale.float()[..., :, None, :, None]
    return x.to(dtype)


def requantize_pages(x: torch.Tensor, prev_scale: torch.Tensor):
    """Quantize updated pages with monotone scale growth.

    Returns ``(q, scale)`` with ``scale = max(prev_scale, amax/127)`` per
    (page, head). Pages unchanged since their last quantization come back
    bit for bit.
    """
    scale = page_scales(x, prev_scale)
    return quantize_pages(x, scale), scale
