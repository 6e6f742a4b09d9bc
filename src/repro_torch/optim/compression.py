"""Gradient compression: int8 with per-block scales and error feedback.

On the reference's multi-pod mesh the pod-axis reduction crosses the slow
inter-pod links, so it may compress the gradient to int8 with one absmax
scale per block of 256 values and carry an error-feedback residual through
the optimizer loop (the residual restores unbiasedness over steps). The
arithmetic is the reference's (``repro/optim/compression.py``): f32
division, round half to even and the clip to [-127, 127] give the same
codes and scales bit for bit. Works leaf by leaf on a list of tensors.

The reference quantizes blocks of 256 over the whole leaf's flattened
(row-major) order. Over a rank mesh a rank holds an FSDP shard of the
gradient (and of its residual): a contiguous 1/F along one axis, which
along an inner axis (the embedding's ``("M", "F")``) is not contiguous in
that order, and whose start need not be a multiple of 256. So a shard is
quantized in the whole leaf's blocks: each of its elements finds its
block from its index in the whole leaf, each rank takes the absmax of its
elements of every block, and one max all-reduce over the FSDP group (the
blocks of every sharded leaf packed together) gives every block's absmax
-- the reference's scales exactly, since a max does not depend on the
order it is taken in; each rank then codes its own elements. A whole
leaf is quantized as it is.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import HOST_COPIED, host_target

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


def block_ids(shape, axis, rank: int = 0, n: int = 1,
              device=None) -> torch.Tensor:
    """The block of 256 (in the whole leaf's flattened order) of every
    element of a shard of a leaf of whole ``shape``: FSDP rank ``rank``'s
    (the contiguous 1/n along ``axis``), or with ``axis`` a dict ``{axis:
    (index, count)}`` the shard cut on each of those axes to its
    index-th contiguous 1/count (an (F, M) shard). int64, the shard's
    shape."""
    cuts = axis if isinstance(axis, dict) else {axis: (rank, n)}
    shape = tuple(shape)
    part = list(shape)
    for a, (_, count) in cuts.items():
        part[a] //= count
    stride, strides = 1, []
    for dim in reversed(shape):
        strides.append(stride)
        stride *= dim
    strides.reverse()
    idx = torch.zeros(part, dtype=torch.int64, device=device)
    for d, size in enumerate(part):
        off = cuts[d][0] * size if d in cuts else 0
        view = [1] * len(part)
        view[d] = size
        idx = idx + ((torch.arange(size, device=device) + off)
                     * strides[d]).view(view)
    return idx // BLOCK


def _shard_blocks(x: torch.Tensor, layout, group):
    """(the whole leaf's block of each element of the shard ``x``, whose
    layout is ``(whole shape, axis)`` -- FSDP rank ``group.rank``'s part
    -- or ``(whole shape, {axis: (index, count)})``; this rank's absmax of
    every block [n_blocks])."""
    shape, axis = layout
    b = block_ids(shape, axis, group.rank, group.size, x.device)
    m = torch.zeros(-(-math.prod(shape) // BLOCK), dtype=torch.float32,
                    device=x.device)
    m.scatter_reduce_(0, b.reshape(-1), x.abs().reshape(-1), "amax")
    return b, m


def _scales(maxes: Sequence[torch.Tensor], group,
            model=None) -> List[torch.Tensor]:
    """Every block's f32 scale, from the ranks' ``maxes`` (one tensor a
    leaf): one max all-reduce over ``group`` for them all (and one over
    ``model`` where leaves are cut on the model axis too)."""
    flat = torch.cat(list(maxes))
    for g in (group, model):
        if g is not None and g.size > 1:
            flat = g.all_reduce(flat, "max")
    return [torch.clamp(c / 127.0, min=1e-12)
            for c in flat.split([m.numel() for m in maxes])]


def _codes(x: torch.Tensor, scale: torch.Tensor, b: torch.Tensor):
    return torch.clamp(torch.round(x / scale[b]), -127, 127).to(torch.int8)


def quantize_shards(xs: Sequence[torch.Tensor], layouts, group,
                    model=None) -> List[Tuple[torch.Tensor, ...]]:
    """The reference's ``_quantize`` of whole leaves, for shards: per
    tensor of ``xs`` (f32), whose layout is ``(whole shape, axis)``, (its
    elements' int8 codes, shaped as the shard; every block's f32 scale
    [n_blocks] of the whole leaf; its elements' blocks, ``block_ids``).
    One max all-reduce over ``group`` for them all (and over ``model``:
    ``compress_grads``)."""
    blocks = [_shard_blocks(x, lay, group) for x, lay in zip(xs, layouts)]
    scales = _scales([m for _, m in blocks], group, model)
    return [(_codes(x, s, b), s, b)
            for x, (b, _), s in zip(xs, blocks, scales)]


def _load(r: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The residual ``r`` on its gradient's card: a HOST-tier one copied
    there (``r`` itself on the CPU)."""
    if host_target(r) is None:
        return r
    HOST_COPIED["h2d"] += r.numel() * r.element_size()
    return r.to(g.device, non_blocking=True)


def _keep(r: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """The new residual where ``r`` lives: written into a HOST-tier ``r``
    in place (which is kept), else ``new`` itself."""
    if host_target(r) is None:
        return new
    HOST_COPIED["d2h"] += r.numel() * r.element_size()
    r.copy_(new)
    return r


def compress_grads(grads: Sequence[torch.Tensor],
                   residuals: Sequence[torch.Tensor], *, group=None,
                   layouts=None, model=None
                   ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """int8-EF compression leaf by leaf: (grads', residuals'). Over a
    rank ``group``, ``layouts`` (aligned with ``grads``) gives each FSDP
    shard's whole shape and axis, None for a whole leaf: the shards are
    quantized in their whole leaves' blocks (``quantize_shards``). Over a
    ``model`` group too, a layout ``(whole shape, {axis: (index,
    count)})`` names a shard cut on the model axis, the FSDP axis or both
    (the embedding's ("M", "F") and ``wq``'s ("F", "M") at (2, 2)), and
    the blocks' absmax is taken over both groups. A
    residual on the HOST tier (``core.hdm``, pinned host memory) is copied
    onto the card for its own leaf only -- over a group twice, once for
    the blocks' absmax and once for the codes -- and its new value
    written back into it in place, so that at most one leaf's residual is
    on the card at a time."""
    multi = any(g is not None and g.size > 1 for g in (group, model))
    if not multi or layouts is None:
        layouts = [None] * len(grads)
    if group is None:
        group = model
    new_g, new_r = list(grads), list(residuals)
    idx = [i for i, lay in enumerate(layouts) if lay is not None]
    for i in (i for i, lay in enumerate(layouts) if lay is None):
        new_g[i], r = compress_leaf(grads[i], _load(residuals[i], grads[i]))
        new_r[i] = _keep(residuals[i], r)
    if not idx:
        return new_g, new_r

    def g32(i):
        return grads[i].float() + _load(residuals[i], grads[i])
    held, maxes = {}, []
    for i in idx:
        x = g32(i)
        b, m = _shard_blocks(x, layouts[i], group)
        maxes.append(m)
        if host_target(residuals[i]) is None:
            held[i] = (x, b)
    for i, scale in zip(idx, _scales(maxes, group,
                                     None if model is group else model)):
        x, b = held.pop(i) if i in held else (g32(i), block_ids(
            *layouts[i], group.rank, group.size, grads[i].device))
        deq = _codes(x, scale, b).float() * scale[b]
        new_g[i], new_r[i] = deq.to(grads[i].dtype), _keep(residuals[i],
                                                          x - deq)
    return new_g, new_r


def compressed_bytes(tensors: Sequence[torch.Tensor]) -> int:
    """Wire bytes per step under int8 codes plus one f32 scale a block."""
    total = 0
    for t in tensors:
        n = t.numel()
        total += n + 4 * (-(-n // BLOCK))
    return total
