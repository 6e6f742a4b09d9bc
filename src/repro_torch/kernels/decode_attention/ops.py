"""Wrapper of the paged flash-decode kernel (model layout).

On a CUDA tensor it launches ``csrc/paged_decode.cu`` (or raises); on a
CPU tensor it runs the plain version (``ref.paged_decode_ref``, or
``ref.paged_decode_int8_ref`` for int8 pages); on a meta tensor (the dry
run) it returns the outputs' shapes and charges ``cost`` to
``kernels.meta``. There is no fallback from one to the other. ``launches`` counts launches of the bf16/f32 mode,
``int8_launches`` those of the int8 mode; each call is one launch.
``kernel_launches`` counts them by instance and mode.

The launch plan (the instance, split and tile sizes, stages, the cut of
the query-head group over CTAs, shared memory, the workspace's shapes) is
``plan()``, a pure function of the shapes that the CPU tests check; the C
entries take it as given and reject a plan that does not match the kernel.
Two instances: "lanes" (a token row over a group of lanes, f32 FMAs; every
dtype and head dim) and "mma" (bf16 q over bf16 or int8 pages, the group's
query heads as the 16 rows of tensor-core products; D 128 and 256). plan()
routes a group of at least ``MMA_MIN_GROUP`` query heads at a head dim of
``MMA_HEAD_DIMS`` (gemma-2b's D 256; the VLM's, glm4-9b's and
starcoder2-15b's groups of 4, 16 and 12 at D 128) to "mma", where
``chip_smoke.py`` timed it faster than "lanes" in the same call
(PERF.md); it times both at every shape both take, the instance plan()
does not route there through ``launch`` / ``launch_int8``. The workspace
(per-split partials and the counters that find each (slot, kv head, group
chunk)'s last split) is allocated once per device and plan by
``_workspace`` and reused by every call: the kernel leaves the counters at
zero. Calls that share it run on one stream, as the serving path's do.

With ``return_ml`` a call returns ``(o, m, l)``: the output in f32 and each
(slot, query head)'s softmax max ``m`` (base 2: the log2 e-scaled logit)
and sum ``l``, [B, H] f32; a slot with no visible token gives m = -inf,
l = 0 and o = 0. These are a rank's partials for the cross-rank combine of
a page-sharded cache (``models.attention``).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import build, meta
from repro_torch.kernels.decode_attention.ref import (int8_rows,
                                                      paged_decode_int8_ref,
                                                      paged_decode_ref)

SPLIT_TOKENS = 256   # tokens per split, rounded to whole pages (one page
                     # at the path's shapes)
MAX_GROUP = 8        # query heads of one kv head a CTA takes; a larger
                     # group is split over CTAs
THREADS, WARPS = 128, 4
ROWS_PER_THREAD = 4  # tile rows a thread scores per tile
STAGES = 4           # cp.async ring depth
MAX_SMEM = 232448    # dynamic shared memory per block
# the tensor-core instance: q's rows padded to one 16-row M tile, 32-token
# K/V tiles in a ring of up to MMA_STAGES, splits halved from the lanes
# instance's until the grid has MMA_MIN_CTAS CTAs at the cache's length
MMA_ROWS, MMA_TILE, MMA_STAGES = 16, 32, 2
MMA_HEAD_DIMS = (128, 256)   # instantiated in csrc/paged_decode.cu
MMA_MIN_GROUP = 4            # query heads a kv head from which plan()
                             # takes it: gemma-2b, the VLM, glm4-9b and
                             # starcoder2-15b, whose serving phases in
                             # chip_smoke.py gate it; qwen3's G 2, timed
                             # faster on it too, is not routed yet
                             # (ROADMAP.md)
MMA_MIN_CTAS = 2 * 132       # two CTAs for each of the H100's SMs

launches = 0
int8_launches = 0
kernel_launches = {"lanes": 0, "lanes_int8": 0, "mma": 0, "mma_int8": 0}
_WORKSPACE = {}


@dataclasses.dataclass(frozen=True)
class Plan:
    split: int         # tokens per split, a whole number of pages
    n_splits: int      # grid (n_splits, kv heads x group_chunks, slots)
    tile: int          # tokens per K/V tile; divides the page
    stages: int
    lanes: int         # lanes that share one token row (0 on "mma")
    group_rows: int    # query heads of one kv head a CTA takes
    group_chunks: int  # CTAs over one kv head's group
    group_pad: int     # group_rows padded (2 or 8; 16 on "mma"): the
                       # kernel instance
    smem_bytes: int
    part_acc: tuple    # workspace shapes (f32, f32, int32)
    part_ml: tuple
    counters: tuple
    kernel: str = "lanes"  # "lanes" or "mma"


def split_tokens(page: int) -> int:
    """Tokens per split: ``SPLIT_TOKENS`` as a whole number of pages."""
    return page * max(1, SPLIT_TOKENS // page)


def split_count(smax: int, page: int = SPLIT_TOKENS) -> int:
    """Splits (CTAs) per (slot, kv head) for a cache of ``smax`` tokens."""
    return -(-smax // split_tokens(page))


def _check_shape(h: int, hkv: int, smax: int, page: int) -> int:
    g = h // hkv
    if g < 1 or h % hkv:
        raise ValueError(f"{h} query heads over {hkv} kv heads")
    if page < 1 or smax % page:
        raise ValueError(f"cache of {smax} tokens in pages of {page}")
    return g


def _q_dtype(kv_dtype: torch.dtype, q_dtype) -> torch.dtype:
    """q's dtype: given, or the pages' (bf16 over int8 pages)."""
    if q_dtype is not None:
        return q_dtype
    return torch.bfloat16 if kv_dtype == torch.int8 else kv_dtype


def mma_takes(h: int, hkv: int, page: int, d: int, kv_dtype: torch.dtype,
              q_dtype: torch.dtype = None) -> bool:
    """Whether the tensor-core instance takes the shape: bf16 q over bf16
    or int8 pages at ``MMA_HEAD_DIMS``, at most 16 query heads a kv head,
    pages of whole 32-token tiles."""
    return (_q_dtype(kv_dtype, q_dtype) == torch.bfloat16
            and kv_dtype in (torch.bfloat16, torch.int8)
            and d in MMA_HEAD_DIMS and 1 <= h // hkv <= MMA_ROWS
            and page % MMA_TILE == 0)


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, hkv: int, smax: int, page: int, d: int,
         kv_dtype: torch.dtype, q_dtype: torch.dtype = None) -> Plan:
    """The launch of ``csrc/paged_decode.cu`` for q [b,1,h,d] (of
    ``q_dtype``: bf16 over int8 pages where not given) against pages [b,
    smax/page, page, hkv, d] of ``kv_dtype`` (int8: the int8 mode): the
    tensor-core instance (``mma_plan``) for a group of at least
    ``MMA_MIN_GROUP`` query heads where it takes the shape, else the lanes
    instance (``lanes_plan``)."""
    _check_shape(h, hkv, smax, page)
    if (h // hkv >= MMA_MIN_GROUP
            and mma_takes(h, hkv, page, d, kv_dtype, q_dtype)):
        return mma_plan(b, h, hkv, smax, page, d, kv_dtype)
    return lanes_plan(b, h, hkv, smax, page, d, kv_dtype)


def mma_plan(b: int, h: int, hkv: int, smax: int, page: int, d: int,
             kv_dtype: torch.dtype) -> Plan:
    """The tensor-core instance's launch: one CTA per (split, kv head,
    slot) holding the whole group as the 16 rows of its products, 32-token
    tiles (inside a page, so the int8 mode reads one scale a tile); splits
    of the lanes instance's size, halved while they stay whole tiles and
    the grid has fewer than ``MMA_MIN_CTAS`` CTAs at ``smax``; a ring of up
    to ``MMA_STAGES`` tiles. Shared memory: q's 16 rows, the ring (bf16
    rows padded to d + 8; int8: the codes and one bf16 tile pair they are
    widened into), the four warps' S partials (the last split's merge
    reuses them for each split's m and l)."""
    g = _check_shape(h, hkv, smax, page)
    if not mma_takes(h, hkv, page, d, kv_dtype):
        raise ValueError(f"the tensor-core instance does not take G {g}, "
                         f"D {d}, pages of {page} in {kv_dtype}")
    split = split_tokens(page)
    while ((split // 2) % MMA_TILE == 0
           and b * hkv * -(-smax // split) < MMA_MIN_CTAS):
        split //= 2
    n_splits = -(-smax // split)
    stages = min(MMA_STAGES, split // MMA_TILE)
    row = (d + 8) * 2
    ring = (stages * 2 * MMA_TILE * d + 2 * MMA_TILE * row
            if kv_dtype == torch.int8 else stages * 2 * MMA_TILE * row)
    s_parts = 4 * (MMA_TILE // 2) * 32          # the warps' S partials
    merge = (2 * n_splits + 3) * MMA_ROWS         # each split's m and l
    smem = MMA_ROWS * row + ring + max(s_parts, merge) * 4
    return Plan(split=split, n_splits=n_splits, tile=MMA_TILE,
                stages=stages, lanes=0, group_rows=g, group_chunks=1,
                group_pad=MMA_ROWS, smem_bytes=smem,
                part_acc=(b, hkv, n_splits, g, d),
                part_ml=(b, hkv, n_splits, g, 2), counters=(b, hkv, 1),
                kernel="mma")


def lanes_plan(b: int, h: int, hkv: int, smax: int, page: int, d: int,
               kv_dtype: torch.dtype) -> Plan:
    """The lanes instance's launch. A token row is read as 16-byte chunks,
    one per lane of a group of ``lanes`` (a power of two); a tile is
    ``ROWS_PER_THREAD`` rows per row slot, cut to the largest power of two
    that divides the page. A group of more than ``MAX_GROUP`` query heads
    per kv head is split over ``ceil(G / MAX_GROUP)`` CTAs of equal rows
    (G 12: 6 + 6, G 16: 8 + 8), each of which reads the split's K/V."""
    g = _check_shape(h, hkv, smax, page)
    kv_bytes = kv_dtype.itemsize
    elems = 16 // kv_bytes
    if d % elems or not 1 <= d // elems <= 32:
        raise ValueError(f"head_dim {d} in {kv_dtype}: a row must be 1..32 "
                         f"chunks of 16 bytes")
    lanes = 1 << (d // elems - 1).bit_length()
    split = split_tokens(page)
    n_splits = split_count(smax, page)
    tile = min(ROWS_PER_THREAD * (THREADS // lanes), page & -page)
    chunks = -(-g // MAX_GROUP)
    rows = -(-g // chunks)
    gm = 2 if rows <= 2 else MAX_GROUP
    ring = STAGES * 2 * tile * d * kv_bytes
    merge = WARPS * gm * (d + 2) * 4
    q_smem = gm * d * 4 if gm * elems > 32 else 0
    return Plan(split=split, n_splits=n_splits, tile=tile, stages=STAGES,
                lanes=lanes, group_rows=rows, group_chunks=chunks,
                group_pad=gm, smem_bytes=q_smem + max(ring, merge),
                part_acc=(b, hkv, n_splits, g, d),
                part_ml=(b, hkv, n_splits, g, 2),
                counters=(b, hkv, chunks))


def check_plan(p: Plan, b: int, h: int, hkv: int, smax: int, page: int,
               d: int, kv_dtype: torch.dtype,
               q_dtype: torch.dtype = None) -> None:
    """Raise ValueError unless ``p`` is the launch its instance's plan
    function gives at these shapes (the tensor-core instance only where it
    takes them), inside the block's shared memory. The C entries check the
    launch again against the instance they run."""
    if p.kernel == "mma":
        if not mma_takes(h, hkv, page, d, kv_dtype, q_dtype):
            raise ValueError(f"the tensor-core instance does not take q "
                             f"{_q_dtype(kv_dtype, q_dtype)} over "
                             f"{kv_dtype} pages at G {h // hkv}, D {d}")
        made = mma_plan(b, h, hkv, smax, page, d, kv_dtype)
    elif p.kernel == "lanes":
        made = lanes_plan(b, h, hkv, smax, page, d, kv_dtype)
    else:
        raise ValueError(f"no decode instance {p.kernel!r}")
    if p != made or p.smem_bytes > MAX_SMEM:
        raise ValueError(f"plan {p} is not the {p.kernel} instance's {made}"
                         f" or does not fit {MAX_SMEM} bytes")


def cost(b: int, h: int, hkv: int, d: int, tokens: int, *, kv_bytes: int,
         q_bytes: int, out_bytes: int = None, pages_read: int = 0,
         int8: bool = False):
    """(flops, bytes) of one launch over ``b`` slots whose visible tokens
    sum to ``tokens``: Q K^T and P V, 2 flops a multiply-add each, for
    every query head; the visible keys and values read once
    (``kv_bytes`` an element), q read and the output written once, the
    lengths read. The int8 mode (``int8``) also reads the scales of the
    ``pages_read`` pages it visits and the new token's K/V rows."""
    out_bytes = q_bytes if out_bytes is None else out_bytes
    n_bytes = (2 * tokens * hkv * d * kv_bytes + b * h * d * q_bytes
               + b * h * d * out_bytes + b * 4)
    if int8:
        n_bytes += 2 * pages_read * hkv * 4 + 2 * b * hkv * d * q_bytes
    return 4 * tokens * h * d, n_bytes


def _meta(name, q, pages, return_ml, int8=False):
    """The meta branch: the outputs' shapes, and one launch's ``cost``
    charged, every slot over its whole cache (the lengths' values are
    not known on meta)."""
    b, _, h, d = q.shape
    _, p, page, hkv, _ = pages.shape
    outs = _outputs(q, return_ml)
    meta.charge(name, *cost(b, h, hkv, d, b * p * page,
                            kv_bytes=pages.element_size(),
                            q_bytes=q.element_size(),
                            out_bytes=4 if return_ml else None,
                            pages_read=b * p, int8=int8))
    return _result(*outs)


def _workspace(device: torch.device, p: Plan):
    """The partials and counters of ``p`` on ``device``, made once."""
    key = (device, p.part_acc, p.counters)
    ws = _WORKSPACE.get(key)
    if ws is None:
        ws = (torch.empty(p.part_acc, dtype=torch.float32, device=device),
              torch.empty(p.part_ml, dtype=torch.float32, device=device),
              torch.zeros(p.counters, dtype=torch.int32, device=device))
        _WORKSPACE[key] = ws
    return ws


def _outputs(q: torch.Tensor, return_ml: bool):
    """(out, out_f32, out_ml) for one call: out in q's dtype, or the f32
    output with its [B, H, 2] m and l."""
    if not return_ml:
        return torch.empty_like(q), None, None
    b, _, h, _ = q.shape
    return (None, torch.empty(q.shape, dtype=torch.float32, device=q.device),
            torch.empty((b, h, 2), dtype=torch.float32, device=q.device))


def _result(out, out_f32, out_ml):
    if out_f32 is None:
        return out
    return out_f32, out_ml[..., 0], out_ml[..., 1]


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, kv_len: torch.Tensor = None, *,
                 logit_softcap: float = 0.0, k_scale: torch.Tensor = None,
                 v_scale: torch.Tensor = None, new_k: torch.Tensor = None,
                 new_v: torch.Tensor = None, pos: torch.Tensor = None,
                 fresh: torch.Tensor = None, return_ml: bool = False):
    """q: [B,1,H,D]; pages [B,P,page,Hkv,D]; kv_len int32 [B] -> [B,1,H,D]
    (with ``return_ml``: ``(o f32, m, l)``, see the module).

    Row b attends to its first ``min(kv_len[b], P*page)`` positions.
    With ``k_scale`` the int8 mode runs instead (``_paged_decode_int8``):
    it takes ``pos``, or ``kv_len`` with ``fresh``.
    """
    if k_scale is not None:
        return _paged_decode_int8(q, k_pages, v_pages, k_scale, v_scale,
                                  new_k, new_v, pos, kv_len, fresh,
                                  logit_softcap, return_ml)
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
        return paged_decode_ref(q, k_pages, v_pages, kv_len, logit_softcap,
                                return_ml=return_ml)
    if q.device.type == "meta":
        return _meta("paged_decode", q, k_pages, return_ml)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in build.DTYPE_CODES:
        raise TypeError(f"unsupported dtype {q.dtype}")
    if kv_len.dtype != torch.int32:
        raise TypeError("kv_len must be int32")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("kv_len", kv_len)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return launch(q, k_pages, v_pages, kv_len, logit_softcap, return_ml,
                  plan(b, h, hkv, p * page, page, d, k_pages.dtype, q.dtype))


def launch(q, k_pages, v_pages, kv_len, logit_softcap: float,
           return_ml: bool, p: Plan):
    """One launch of the bf16/f32 mode at plan ``p`` on inputs that
    ``paged_decode`` has checked (``chip_smoke.py`` also times the instance
    plan() does not route a shape to through it)."""
    global launches
    b, _, h, d = q.shape
    _, n_pages, page, hkv, _ = k_pages.shape
    smax = n_pages * page
    check_plan(p, b, h, hkv, smax, page, d, k_pages.dtype, q.dtype)
    part_acc, part_ml, counters = _workspace(q.device, p)
    outs = _outputs(q, return_ml)
    lib = build.library()
    rc = lib.repro_paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        kv_len.data_ptr(), *map(_ptr, outs), part_acc.data_ptr(),
        part_ml.data_ptr(), counters.data_ptr(), b, h, hkv, smax, page, d,
        p.split, p.n_splits, p.tile, p.stages, p.lanes, p.group_pad,
        p.group_rows, p.smem_bytes,
        build.DTYPE_CODES[q.dtype], 1.0 / (d ** 0.5), float(logit_softcap),
        build.stream_ptr(q.device))
    launches += 1
    kernel_launches[p.kernel] += 1
    build.check(rc, "paged_decode")
    return _result(*outs)


def _paged_decode_int8(q, k_codes, v_codes, k_scale, v_scale, new_k, new_v,
                       pos, kv_len, fresh, logit_softcap, return_ml):
    """The int8 mode. Codes int8 [B,P,page,Hkv,D] and f32 scales
    [B,P,Hkv] are read in place (code x its page's scale); the new token's
    K/V [B,1,Hkv,D] (q's dtype) stands at row ``fresh[b]`` in place of that
    row's code, at full precision (none where ``fresh[b] < 0``), and row b
    attends over ``[0, kv_len[b])``. One rank passes ``pos`` instead
    (``int8_rows``); a rank of a page-sharded cache passes its local
    ``kv_len`` and ``fresh``. Nothing is written to the pages: the caller
    requantizes the page it wrote (``models.attention``)."""
    if q.dim() != 4 or q.shape[1] != 1 or k_codes.dim() != 5:
        raise ValueError(f"expected q [B,1,H,D] and codes [B,P,page,Hkv,D]"
                         f", got {tuple(q.shape)} / {tuple(k_codes.shape)}")
    b, _, h, d = q.shape
    _, p, page, hkv, dk = k_codes.shape
    if any(t is None for t in (v_scale, new_k, new_v)):
        raise ValueError("the int8 mode needs k_scale, v_scale, new_k and "
                         "new_v")
    if (pos is None) == (kv_len is None) or (kv_len is None) != (
            fresh is None):
        raise ValueError("the int8 mode takes pos, or kv_len with fresh")
    if pos is not None:
        if pos.shape != (b,):
            raise ValueError(f"pos {tuple(pos.shape)} for {b} slots")
        kv_len, fresh = int8_rows(pos, p * page)
    if (k_codes.shape != v_codes.shape or k_codes.shape[0] != b or dk != d
            or h % hkv or k_scale.shape != (b, p, hkv)
            or v_scale.shape != (b, p, hkv)
            or new_k.shape != (b, 1, hkv, d)
            or new_v.shape != (b, 1, hkv, d) or kv_len.shape != (b,)
            or fresh.shape != (b,)):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, codes "
                         f"{tuple(k_codes.shape)}/{tuple(v_codes.shape)}, "
                         f"scales {tuple(k_scale.shape)}/"
                         f"{tuple(v_scale.shape)}, new "
                         f"{tuple(new_k.shape)}/{tuple(new_v.shape)}, "
                         f"kv_len {tuple(kv_len.shape)}, fresh "
                         f"{tuple(fresh.shape)}")
    if not (k_codes.dtype == v_codes.dtype == torch.int8):
        raise TypeError("the int8 mode takes int8 codes")
    if not (k_scale.dtype == v_scale.dtype == torch.float32):
        raise TypeError("the scales must be float32")
    if not (q.dtype == new_k.dtype == new_v.dtype):
        raise TypeError("q and the new K/V must share one dtype")
    inputs = (("q", q), ("k_codes", k_codes), ("v_codes", v_codes),
              ("k_scale", k_scale), ("v_scale", v_scale), ("new_k", new_k),
              ("new_v", new_v), ("kv_len", kv_len), ("fresh", fresh))
    devices = {t.device for _, t in inputs}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {devices}")
    if q.device.type == "cpu":
        return paged_decode_int8_ref(q, k_codes, v_codes, k_scale, v_scale,
                                     new_k, new_v, None, logit_softcap,
                                     kv_len=kv_len, fresh=fresh,
                                     return_ml=return_ml)
    if q.device.type == "meta":
        return _meta("paged_decode_int8", q, k_codes, return_ml, int8=True)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in build.DTYPE_CODES:
        raise TypeError(f"unsupported dtype {q.dtype}")
    if kv_len.dtype != torch.int32 or fresh.dtype != torch.int32:
        raise TypeError("kv_len and fresh must be int32")
    for name, t in inputs:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return launch_int8(q, k_codes, v_codes, k_scale, v_scale, new_k, new_v,
                       kv_len, fresh, logit_softcap, return_ml,
                       plan(b, h, hkv, p * page, page, d, torch.int8,
                            q.dtype))


def launch_int8(q, k_codes, v_codes, k_scale, v_scale, new_k, new_v, kv_len,
                fresh, logit_softcap: float, return_ml: bool, p: Plan):
    """One launch of the int8 mode at plan ``p`` on inputs that
    ``paged_decode`` has checked (``kv_len`` and ``fresh`` given)."""
    global int8_launches
    b, _, h, d = q.shape
    _, n_pages, page, hkv, _ = k_codes.shape
    smax = n_pages * page
    check_plan(p, b, h, hkv, smax, page, d, torch.int8, q.dtype)
    part_acc, part_ml, counters = _workspace(q.device, p)
    outs = _outputs(q, return_ml)
    lib = build.library()
    rc = lib.repro_paged_decode_int8(
        q.data_ptr(), k_codes.data_ptr(), v_codes.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), new_k.data_ptr(),
        new_v.data_ptr(), kv_len.data_ptr(), fresh.data_ptr(),
        *map(_ptr, outs), part_acc.data_ptr(), part_ml.data_ptr(),
        counters.data_ptr(), b, h, hkv, smax, page, d, p.split,
        p.n_splits, p.tile, p.stages, p.lanes, p.group_pad,
        p.group_rows, p.smem_bytes,
        build.DTYPE_CODES[q.dtype], 1.0 / (d ** 0.5), float(logit_softcap),
        build.stream_ptr(q.device))
    int8_launches += 1
    kernel_launches[p.kernel + "_int8"] += 1
    build.check(rc, "paged_decode_int8")
    return _result(*outs)
