"""Wrapper of the paged weight-streaming matmul kernel.

On a CUDA tensor it launches ``csrc/paged_matmul.cu`` (or raises); on a
CPU tensor it runs the plain version (``ref.paged_matmul_ref``); on a meta
tensor (the dry run) it returns the output's shape and charges ``cost``
to ``kernels.meta``. There is no fallback from one to the other. ``launches`` counts kernel launches,
``instance_launches`` the same by the plan's instance.

The launch plan (the instance, its tiles, ring stages, K-splits, shared
memory and workspace) is ``plan()``, a pure function of the shapes that
the CPU tests check; the C entry takes it as given and refuses a plan that
its instance cannot run. Each dtype has two instances: one for the decode
batch (M <= 16; split-K over 64-column strips of N, merged in split order
by the last CTA of a strip) and one for block tiles above it (chosen by
``chip_smoke.py``'s sweep, PERF.md). bf16 runs both on tensor cores
("skinny", W^T x^T on mma.sync; "tile"); f32 runs "skinny_f32" on FFMA
(the weight's bytes bound it) and "tile_f32" on tensor cores in 3xTF32.
Shapes neither takes (N not a whole number of 16-byte chunks, pages that
are not whole 64-deep K tiles) run the scalar instance, and only those.

No serving or training path of the reference calls this op: its serving
engine drops the speculative-read weight prefetch on one device, and only
the kernel tests call ``stream_matmul``. It is ported as that op.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import build, meta
from repro_torch.kernels.hdm_stream.ref import paged_matmul_ref

N_SMS = 132                              # H100 SXM
MAX_SMEM = 232448                        # dynamic shared memory per block
SKINNY_M = 16                            # the skinny instance's largest M
SKINNY_N, SKINNY_K = 64, 64              # a CTA's strip of N, a K tile
SKINNY_STAGES = 4
SKINNY_CTAS = 2 * N_SMS                  # CTAs (strips x K-splits) to reach
SKINNY_SPLITS = (1, 2, 4, 8)             # K-splits tried, fewest first
TILE_K = 64
TILE_STAGES = 3
# block tiles (tile_m, tile_n) of the tile instance, most preferred first
TILE_SHAPES = ((128, 64), (64, 128), (128, 128))
# the f32 instances (chip_smoke.py's sweeps, PERF.md): skinny_f32's ring
# depth; tile_f32's block tiles, most preferred first (64 x 64: 384 CTAs,
# three a SM at 2 stages), and ring depth
SKINNY_F32_STAGES = 2
TILE_F32_SHAPES = ((64, 64), (128, 96), (128, 64), (128, 128))
TILE_F32_STAGES = 2
SCALAR_TILE = (64, 64, 32)
INSTANCE_CODES = {"scalar": 0, "skinny": 1, "tile": 2, "skinny_f32": 3,
                  "tile_f32": 4}
# the instances of each dtype: (skinny, tile) and the N multiple they take
INSTANCES = {torch.bfloat16: (("skinny", "tile"), 8),
             torch.float32: (("skinny_f32", "tile_f32"), 4)}

launches = 0
instance_launches = dict.fromkeys(INSTANCE_CODES, 0)
_WORKSPACE = {}


@dataclasses.dataclass(frozen=True)
class Plan:
    instance: str      # "skinny", "tile" (bf16 tensor cores), "skinny_f32"
                       # (f32 FMA), "tile_f32" (3xTF32) or "scalar"
    grid: tuple        # (N strips or tiles, K-splits or M tiles)
    tile_m: int        # rows of x per CTA (skinny: 16, the padded M)
    tile_n: int        # columns of N per CTA
    tile_k: int        # K rows per staged tile; divides the page
    stages: int        # tiles in flight (1: the scalar kernel)
    splits: int        # K-splits; each covers tiles_per_split K tiles
    tiles_per_split: int
    threads: int
    smem_bytes: int    # dynamic shared memory (0: the scalar kernel's is
                       # static)
    workspace: tuple   # f32 partials [splits, M, N] ((): none)
    counters: int      # int32 per-strip counters (0: none)


def skinny_plan(m: int, k: int, n: int, splits: int,
                stages: int = SKINNY_STAGES,
                dtype: torch.dtype = torch.bfloat16) -> Plan:
    """The skinny instance of ``dtype`` at ``splits`` K-splits: 64-column
    strips of N, 64-deep K tiles, each split a contiguous run of whole
    tiles. bf16 stages W tiles padded to 72 elements and 16 rows of x
    (ldmatrix); f32 ("skinny_f32") unpadded 64-float rows of both."""
    n_t = k // SKINNY_K
    per = -(-n_t // splits)
    splits = -(-n_t // per)
    strips = -(-n // SKINNY_N)
    if dtype == torch.float32:
        name = "skinny_f32"
        smem = 4 * stages * (SKINNY_K * SKINNY_N + 16 * SKINNY_K)
    else:
        name = "skinny"
        smem = 2 * stages * (SKINNY_K * (SKINNY_N + 8) + 16 * (SKINNY_K + 8))
    ws = (splits, m, n) if splits > 1 else ()
    return Plan(name, (strips, splits), 16, SKINNY_N, SKINNY_K, stages,
                splits, per, 128, smem, ws, strips if splits > 1 else 0)


def tile_plan(m: int, k: int, n: int, tile_m: int, tile_n: int,
              stages: int = TILE_STAGES,
              dtype: torch.dtype = torch.bfloat16) -> Plan:
    """The tile instance of ``dtype`` at block tiles of ``tile_m`` x
    ``tile_n`` (warp tiles of 64 x 32; 32 x 32 in the 64-row blocks; f32's
    128 x 96 block 32 x 48) and
    64-deep K tiles: bf16 rows padded by 8 elements; f32 ("tile_f32") x's
    rows padded to 68 floats, W's to tile_n + 8."""
    if dtype == torch.float32 and tile_n == 96:     # warps of 32 x 48
        threads = tile_m // 32 * (tile_n // 48) * 32
    else:
        threads = tile_m // (32 if tile_m == 64 else 64) * (tile_n // 32) * 32
    if dtype == torch.float32:
        name = "tile_f32"
        smem = 4 * stages * (tile_m * (TILE_K + 4) + TILE_K * (tile_n + 8))
    else:
        name = "tile"
        smem = 2 * stages * (tile_m * (TILE_K + 8) + TILE_K * (tile_n + 8))
    return Plan(name, (-(-n // tile_n), -(-m // tile_m)), tile_m, tile_n,
                TILE_K, stages, 1, k // TILE_K, threads, smem, (), 0)


def scalar_plan(m: int, k: int, n: int, page_k: int) -> Plan:
    """The scalar instance: 64 x 64 output tiles, 32-deep K slices."""
    bm, bn, bk = SCALAR_TILE
    return Plan("scalar", (-(-n // bn), -(-m // bm)), bm, bn, bk, 1, 1,
                k // page_k, 256, 0, (), 0)


def _takes(n: int, page_k: int, dtype: torch.dtype) -> bool:
    """Whether ``dtype``'s skinny and tile instances take the shape: N in
    whole 16-byte chunks and pages of whole 64-deep K tiles."""
    return (dtype in INSTANCES and n % INSTANCES[dtype][1] == 0
            and page_k % TILE_K == 0)


@functools.lru_cache(maxsize=None)
def plan(m: int, k: int, n: int, page_k: int, dtype: torch.dtype) -> Plan:
    """The launch of ``csrc/paged_matmul.cu`` for x [m, k] and pages of
    ``page_k`` rows of width ``n``. Where ``dtype``'s instances take the
    shape: at m <= 16 its skinny instance with the fewest K-splits in
    ``SKINNY_SPLITS`` that give ``SKINNY_CTAS`` CTAs; above it its tile
    instance at the first of its shapes (``TILE_SHAPES``,
    ``TILE_F32_SHAPES``) whose grid has ``N_SMS`` CTAs, else the one with
    the most. The scalar instance otherwise."""
    if not _takes(n, page_k, dtype):
        return scalar_plan(m, k, n, page_k)
    f32 = dtype == torch.float32
    if m <= SKINNY_M:
        n_t = k // SKINNY_K
        stages = SKINNY_F32_STAGES if f32 else SKINNY_STAGES
        for s in SKINNY_SPLITS:
            p = skinny_plan(m, k, n, min(s, n_t), stages, dtype)
            if p.grid[0] * p.grid[1] >= SKINNY_CTAS:
                break
        return p
    shapes, stages = ((TILE_F32_SHAPES, TILE_F32_STAGES) if f32
                      else (TILE_SHAPES, TILE_STAGES))
    plans = [tile_plan(m, k, n, *t, stages, dtype) for t in shapes]
    full = [p for p in plans if p.grid[0] * p.grid[1] >= N_SMS]
    return full[0] if full else max(plans,
                                    key=lambda p: p.grid[0] * p.grid[1])


def check_plan(p: Plan, m: int, k: int, n: int, page_k: int,
               dtype: torch.dtype) -> None:
    """Raise ValueError unless ``p`` is what its instance's plan function
    gives at its tiles, stages and splits, on an instance that takes
    (m, dtype) -- the scalar one only where neither of the dtype's others
    takes the shape -- with K tiles inside a page and within the block's
    shared memory. The C entry checks the launch again."""
    if p.instance == "scalar":
        if _takes(n, page_k, dtype):
            raise ValueError(f"{dtype} at N {n}, pages of {page_k} runs on "
                             f"{INSTANCES[dtype][0]}, not the scalar "
                             f"instance")
        made = scalar_plan(m, k, n, page_k)
    else:
        names, chunk = INSTANCES.get(dtype, ((), 1))
        if p.instance not in names or n % chunk:
            own = next((f"{'bf16' if t == torch.bfloat16 else 'f32'} with "
                        f"N % {c} == 0" for t, (ns, c) in INSTANCES.items()
                        if p.instance in ns), "nothing")
            raise ValueError(f"the {p.instance} instance takes {own}, not "
                             f"{dtype} at N {n}")
        if page_k % p.tile_k:
            raise ValueError(f"K tiles of {p.tile_k} cross pages of "
                             f"{page_k}")
        if not 2 <= p.stages <= 4:
            raise ValueError(f"the {p.instance} instance refuses plan {p}")
        if p.instance == names[0]:
            if m > SKINNY_M:
                raise ValueError(f"{p.instance} takes M <= {SKINNY_M}, "
                                 f"not {m}")
            made = skinny_plan(m, k, n, p.splits, p.stages, dtype)
        else:
            shapes = (TILE_F32_SHAPES if dtype == torch.float32
                      else TILE_SHAPES)
            if m <= SKINNY_M or (p.tile_m, p.tile_n) not in shapes:
                raise ValueError(f"the {p.instance} instance refuses plan "
                                 f"{p}")
            made = tile_plan(m, k, n, p.tile_m, p.tile_n, p.stages, dtype)
    if p != made or p.smem_bytes > MAX_SMEM:
        raise ValueError(f"plan {p} is not the {p.instance} instance's "
                         f"{made} or does not fit {MAX_SMEM} bytes")


def _workspace(device: torch.device, p: Plan):
    """The partials and zeroed counters of ``p`` on ``device``, made once
    (the kernel leaves the counters at zero). Calls that share them run
    on one stream."""
    if not p.workspace:
        return None, None
    key = (device, p.workspace)
    ws = _WORKSPACE.get(key)
    if ws is None:
        ws = (torch.empty(p.workspace, dtype=torch.float32, device=device),
              torch.zeros(p.counters, dtype=torch.int32, device=device))
        _WORKSPACE[key] = ws
    return ws


def cost(m: int, k: int, n: int, n_ids: int, elem_bytes: int):
    """(flops, bytes) of one launch: the [m, k] x [k, n] product, 2 flops
    a multiply-add; x and the K/page_k gathered pages read once, y
    written once (``elem_bytes`` an element), the ``n_ids`` page ids
    read."""
    return 2 * m * k * n, elem_bytes * (m * k + k * n + m * n) + 4 * n_ids


def stream_matmul(x: torch.Tensor, w_pages: torch.Tensor,
                  page_ids: torch.Tensor) -> torch.Tensor:
    """y = x @ vstack(w_pages[page_ids]).

    x: [M, K]; w_pages: [n_pages, page_k, N] in x's dtype; page_ids int32
    [K // page_k], each in [0, n_pages). Returns [M, N] in x's dtype, f32
    accumulation. M and N need not divide any tile.
    """
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
    if x.device.type == "meta":
        meta.charge("paged_matmul", *cost(m, k, n, page_ids.shape[0],
                                          x.element_size()))
        return torch.empty((m, n), dtype=x.dtype, device=x.device)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in build.DTYPE_CODES:
        raise TypeError(f"unsupported dtype {x.dtype}")
    if page_ids.dtype != torch.int32:
        raise TypeError("page_ids must be int32")
    for name, t in (("x", x), ("w_pages", w_pages), ("page_ids", page_ids)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return launch(x, w_pages, page_ids, plan(m, k, n, page_k, x.dtype))


def launch(x, w_pages, page_ids, p: Plan) -> torch.Tensor:
    """One launch of the kernel at plan ``p`` on inputs that
    ``stream_matmul`` has checked (``chip_smoke.py`` also times other
    plans through it)."""
    global launches
    m, k = x.shape
    n_pages, page_k, n = w_pages.shape
    check_plan(p, m, k, n, page_k, x.dtype)
    part, counters = _workspace(x.device, p)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    rc = build.library().repro_paged_matmul(
        x.data_ptr(), w_pages.data_ptr(), page_ids.data_ptr(), y.data_ptr(),
        0 if part is None else part.data_ptr(),
        0 if counters is None else counters.data_ptr(),
        m, k, n, page_k, n_pages, build.DTYPE_CODES[x.dtype],
        INSTANCE_CODES[p.instance], p.tile_m, p.tile_n, p.tile_k, p.stages,
        p.splits, p.smem_bytes, build.stream_ptr(x.device))
    launches += 1
    instance_launches[p.instance] += 1
    build.check(rc, "paged_matmul")
    return y
