"""Wrapper of the chunked-prefill flash attention kernel (model layout).

On a CUDA tensor it launches ``csrc/flash_prefill.cu`` (or raises); on a
CPU tensor it runs the plain version (``ref.flash_prefill_ref``). There is
no fallback from one to the other. ``launches`` counts kernel launches,
``kernel_launches`` the same by the plan's kernel.

The launch plan (which of the file's five kernels, the grid, rows per
CTA, pipeline stages and dynamic shared memory) is ``plan()``, a pure function of the shapes that the CPU tests check; the C
entry takes it as given and rejects a plan that does not match its kernel.
The kernel follows from (dtype, head_dim): bf16 at ``MMA_HEAD_DIMS`` on
tensor cores ("mma"), bf16 at D 256 on tensor cores with two warps per 16
rows, each on half of the head dim ("mma256", gemma-2b), f32 at
``MMA_HEAD_DIMS`` on tensor cores in 3xTF32 ("tf32"), f32 at D 256 in
3xTF32 with four warps per 16 rows, each on a quarter of the head dim
("tf32_256", gemma-2b with int8 pages), and the rest -- D 16 and 32 in both
dtypes -- on the scalar kernel. Rows per CTA and stages were chosen by
timing the candidates on the H100 (``chip_smoke.py``'s plan sweeps,
PERF.md).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_prefill_ref

HEAD_DIMS = (16, 32, 64, 80, 128, 256)   # instantiated in csrc/flash_prefill.cu
MMA_HEAD_DIMS = (64, 80, 128)            # on tensor cores, bf16 and f32
MMA_KEYS = 64                            # keys per K/V tile
MMA_STAGES = 3                           # cp.async ring depth
MMA_ROWS = (64, 32, 16)                  # rows per CTA, most first
TF32_KEYS = 64                           # keys per f32 K/V tile
TF32_ROWS, TF32_STAGES = 32, 2           # the f32 plan (chip_smoke.py's sweep)
D256 = 256                               # bf16 "mma256" head dim
D256_KEYS = 64                           # keys per K/V tile
D256_ROWS, D256_STAGES = 32, 3           # the D 256 plan (chip_smoke.py's sweep)
# the f32 D 256 kernel: 16 rows per CTA (two key groups of four warps),
# 32-key K/V tiles; its stages (chip_smoke.py's sweep)
TQ_ROWS, TQ_KEYS, TQ_STAGES = 16, 32, 2
SCALAR_ROWS, SCALAR_KEYS = 64, 64
N_SMS = 132                              # H100 SXM
MAX_SMEM = 232448                        # dynamic shared memory per block
# rows per CTA and stages each kernel is written for
PLAN_RANGE = {"mma": ((16, 32, 64), (2, 3, 4)),
              "tf32": ((16, 32, 64), (2, 3)),
              "mma256": ((16, 32, 64), (2, 3)),
              "tf32_256": ((TQ_ROWS,), (2, 3)),
              "scalar": ((SCALAR_ROWS,), (1,))}

launches = 0
kernel_launches = dict.fromkeys(PLAN_RANGE, 0)


@dataclasses.dataclass(frozen=True)
class Plan:
    kernel: str        # "mma" (bf16 tensor cores), "mma256" (bf16 at D
                       # 256), "tf32" (f32 tensor cores, 3xTF32),
                       # "tf32_256" (f32 at D 256, 3xTF32) or "scalar"
    grid: tuple        # (row tiles, kv heads, batch)
    rows: int          # (query, head) rows per CTA; 32 threads per 16 rows
                       # on bf16 tensor cores, 64 at D 256 (two warps split
                       # the head dim) and in 3xTF32 (two warps share the
                       # keys), 128 in f32 at D 256 (two key groups of four
                       # warps on the head dim's quarters), 256 threads in
                       # the scalar kernel
    stages: int        # K/V tiles in flight (1: the scalar kernel's one)
    smem_bytes: int


def mma_plan(b: int, c: int, h: int, hkv: int, d: int, rows: int,
             stages: int = MMA_STAGES) -> Plan:
    """The tensor-core kernel's launch at ``rows`` rows per CTA and a ring
    of ``stages`` K/V tiles: q's rows, then the ring, as bf16 rows padded
    to d + 8 elements."""
    gx = -(-c * (h // hkv) // rows)
    smem = 2 * (d + 8) * (rows + stages * 2 * MMA_KEYS)
    return Plan("mma", (gx, hkv, b), rows, stages, smem)


def tf32_plan(b: int, c: int, h: int, hkv: int, d: int, rows: int,
              stages: int) -> Plan:
    """The 3xTF32 kernel's launch at ``rows`` rows per CTA (two warps per
    16 rows, each taking half of every tile's keys) and a ring of
    ``stages`` K/V tiles of ``TF32_KEYS`` keys, f32 rows padded to d + 4
    floats (q is read into registers, not staged)."""
    gx = -(-c * (h // hkv) // rows)
    smem = 4 * (d + 4) * stages * 2 * TF32_KEYS
    return Plan("tf32", (gx, hkv, b), rows, stages, smem)


def d256_plan(b: int, c: int, h: int, hkv: int, rows: int,
              stages: int) -> Plan:
    """The D 256 tensor-core kernel's launch at ``rows`` rows per CTA (two
    warps per 16 rows, one per half of the head dim) and a ring of
    ``stages`` K/V tiles of ``D256_KEYS`` keys: q's rows (which then hold
    the pairs' S partials), then the ring, as bf16 rows padded to 264
    elements."""
    gx = -(-c * (h // hkv) // rows)
    smem = 2 * (D256 + 8) * (rows + stages * 2 * D256_KEYS)
    return Plan("mma256", (gx, hkv, b), rows, stages, smem)


def tf32_256_plan(b: int, c: int, h: int, hkv: int, rows: int,
                  stages: int) -> Plan:
    """The f32 D 256 kernel's launch at ``rows`` rows per CTA (two key
    groups of four warps per 16 rows, a warp per quarter of the head dim)
    and a ring of ``stages`` K/V tiles of ``TQ_KEYS`` keys, f32 rows padded
    to 260 floats, then each group's four S partials (q is read into
    registers)."""
    gx = -(-c * (h // hkv) // rows)
    smem = 4 * (stages * 2 * TQ_KEYS * (D256 + 4) + rows * 4 * TQ_KEYS)
    return Plan("tf32_256", (gx, hkv, b), rows, stages, smem)


def scalar_plan(b: int, c: int, h: int, hkv: int, d: int) -> Plan:
    """The scalar kernel's launch: 64-row CTAs, f32 tiles of q, K, V and
    the scores in shared memory."""
    n_rows = c * (h // hkv)
    smem = (3 * SCALAR_ROWS * (d + 1) + SCALAR_ROWS * (SCALAR_KEYS + 1)) * 4
    return Plan("scalar", (-(-n_rows // SCALAR_ROWS), hkv, b), SCALAR_ROWS,
                1, smem)


def kernel_for(d: int, dtype: torch.dtype) -> str:
    """The kernel that (dtype, head_dim) runs."""
    if d == D256:
        return "mma256" if dtype == torch.bfloat16 else "tf32_256"
    if d in MMA_HEAD_DIMS:
        return "mma" if dtype == torch.bfloat16 else "tf32"
    return "scalar"


@functools.lru_cache(maxsize=None)
def plan(b: int, c: int, h: int, hkv: int, d: int,
         dtype: torch.dtype) -> Plan:
    """The launch of ``csrc/flash_prefill.cu`` for q [b,c,h,d] (the cache
    length does not change it). bf16 at ``MMA_HEAD_DIMS`` runs the
    tensor-core kernel with the most rows per CTA (64, 32, 16) that still
    give ``N_SMS`` CTAs, else 16; f32 there the 3xTF32 kernel at
    ``TF32_ROWS`` rows and ``TF32_STAGES`` stages, the fastest of the
    sweep at the int8 path's chunk; bf16 at D 256 the "mma256" kernel at
    ``D256_ROWS`` rows and ``D256_STAGES`` stages and f32 there the
    "tf32_256" one at ``TQ_ROWS`` rows and ``TQ_STAGES`` stages, the
    fastest of their sweeps at gemma-2b's chunk;
    D 16 and 32 the scalar kernel's 64-row CTAs."""
    kernel = kernel_for(d, dtype)
    if kernel == "tf32":
        return tf32_plan(b, c, h, hkv, d, TF32_ROWS, TF32_STAGES)
    if kernel == "mma256":
        return d256_plan(b, c, h, hkv, D256_ROWS, D256_STAGES)
    if kernel == "tf32_256":
        return tf32_256_plan(b, c, h, hkv, TQ_ROWS, TQ_STAGES)
    if kernel == "mma":
        for rows in MMA_ROWS:
            p = mma_plan(b, c, h, hkv, d, rows)
            if p.grid[0] * hkv * b >= N_SMS:
                break
        return p
    return scalar_plan(b, c, h, hkv, d)


def check_plan(p: Plan, b: int, c: int, h: int, hkv: int, d: int,
               dtype: torch.dtype) -> None:
    """Raise ValueError unless ``p`` is what its kernel's plan function
    gives at its rows and stages (grid and shared memory included), on the
    kernel that (dtype, d) names, at rows and stages that kernel takes,
    inside the block's shared memory. The C entry checks the launch again
    against the kernel it instantiates."""
    if d not in HEAD_DIMS or dtype not in build.DTYPE_CODES:
        raise ValueError(f"no instance for head_dim {d} in {dtype}")
    want = kernel_for(d, dtype)
    if p.kernel != want:
        raise ValueError(f"plan names the {p.kernel} kernel; {dtype} at "
                         f"head_dim {d} runs the {want} kernel")
    rows, stages = PLAN_RANGE[want]
    if p.rows not in rows or p.stages not in stages:
        raise ValueError(f"the {want} kernel refuses plan {p}")
    made = (scalar_plan(b, c, h, hkv, d) if want == "scalar"
            else d256_plan(b, c, h, hkv, p.rows, p.stages)
            if want == "mma256"
            else tf32_256_plan(b, c, h, hkv, p.rows, p.stages)
            if want == "tf32_256"
            else (mma_plan if want == "mma" else tf32_plan)(
                b, c, h, hkv, d, p.rows, p.stages))
    if p != made or p.smem_bytes > MAX_SMEM:
        raise ValueError(f"plan {p} is not the {want} kernel's {made} or "
                         f"does not fit {MAX_SMEM} bytes")


def flash_prefill(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, pos: torch.Tensor, *,
                  logit_softcap: float = 0.0) -> torch.Tensor:
    """q: [B,C,H,D]; caches [B,Smax,Hkv,D]; pos int32 [B] -> [B,C,H,D].

    Query i of row b attends to cache positions ``<= pos[b] + i``; the
    chunk's own K/V must already be written at ``[pos[b], pos[b] + C)``.
    The kernel has no backward: under grad, inputs that require grad are
    refused on both devices (the reference cannot differentiate through
    its Pallas kernel either).
    """
    build.refuse_grad("flash_prefill", q, k_cache, v_cache)
    if q.dim() != 4 or k_cache.dim() != 4:
        raise ValueError(f"expected q [B,C,H,D] and caches [B,Smax,Hkv,D], "
                         f"got {tuple(q.shape)} / {tuple(k_cache.shape)}")
    b, c, h, d = q.shape
    _, smax, hkv, dk = k_cache.shape
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != b or dk != d
            or h % hkv or pos.shape != (b,)):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}, "
                         f"pos {tuple(pos.shape)}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError("q and the caches must share one dtype")
    devices = {q.device, k_cache.device, v_cache.device, pos.device}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {devices}")
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k_cache, v_cache, pos, logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in build.DTYPE_CODES:
        raise TypeError(f"unsupported dtype {q.dtype}")
    if pos.dtype != torch.int32:
        raise TypeError("pos must be int32")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return launch(q, k_cache, v_cache, pos, logit_softcap,
                  plan(b, c, h, hkv, d, q.dtype))


def launch(q, k_cache, v_cache, pos, logit_softcap: float,
           p: Plan) -> torch.Tensor:
    """One launch of the kernel at plan ``p`` on inputs that
    ``flash_prefill`` has checked (``chip_smoke.py`` also times other
    plans of the tensor-core kernels through it)."""
    global launches
    b, c, h, d = q.shape
    _, smax, hkv, _ = k_cache.shape
    check_plan(p, b, c, h, hkv, d, q.dtype)
    out = torch.empty_like(q)
    lib = build.library()
    rc = lib.repro_flash_prefill(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        out.data_ptr(), b, c, h, hkv, smax, d, build.DTYPE_CODES[q.dtype],
        1.0 / (d ** 0.5), float(logit_softcap), p.grid[0], p.rows, p.stages,
        p.smem_bytes, build.stream_ptr(q.device))
    launches += 1
    kernel_launches[p.kernel] += 1
    build.check(rc, "flash_prefill")
    return out
