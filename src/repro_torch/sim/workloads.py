"""Table-1b workload traces for the simulator.

Each workload is characterized by its (compute_ratio, load_ratio) from the
paper's Table 1b plus an address-pattern class:

  Seq    — monotonically advancing addresses (1D vector / 2D row-major
           kernels: vadd, saxpy, gemm, conv3, rsum, stencil);
  Around — spatially local but direction-changing (binary-tree sort,
           Gaussian elimination backsubstitution);
  Rand   — pointer-chasing over the working set (path, bfs).

Real-world workloads are composites, exactly as the paper builds them:
gnn = bfs + vadd + gemm, mri = sort + conv3.

A trace is a numpy record array of ops: kind (0 compute, 1 load, 2 store)
and byte address. Input sizes follow the paper's setup: the working set is
10x the GPU's local memory.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

MEM_REQ = 64  # CXL.mem granule


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """One Table 1b workload: instruction-mix ratios (fractions of the
    trace) and its dominant access pattern class."""

    name: str
    category: str        # compute | load | store | real
    compute_ratio: float
    load_ratio: float
    pattern: str         # Seq | Around | Rand | composite
    parts: Tuple[str, ...] = ()


TABLE_1B: Dict[str, WorkloadSpec] = {s.name: s for s in [
    WorkloadSpec("rsum",    "compute", .314, .533, "SeqL"),
    WorkloadSpec("stencil", "compute", .375, .725, "SeqL"),
    WorkloadSpec("sort",    "compute", .381, .987, "Around"),
    WorkloadSpec("gemm",    "load",    .116, .999, "Seq"),
    WorkloadSpec("vadd",    "load",    .156, .691, "Seq"),
    WorkloadSpec("saxpy",   "load",    .162, .692, "Seq"),
    WorkloadSpec("conv3",   "load",    .218, .786, "Seq"),
    WorkloadSpec("path",    "load",    .270, .927, "Rand"),
    WorkloadSpec("cfd",     "store",   .209, .426, "Seq"),
    WorkloadSpec("gauss",   "store",   .235, .485, "Around"),
    WorkloadSpec("bfs",     "store",   .293, .432, "Rand"),
    WorkloadSpec("gnn",     "real",    .274, .738, "composite",
                 ("bfs", "vadd", "gemm")),
    WorkloadSpec("mri",     "real",    .292, .533, "composite",
                 ("sort", "conv3")),
]}

CATEGORY = {n: s.category for n, s in TABLE_1B.items()}
ORDER = list(TABLE_1B)  # paper order (ascending memory-access ratio)


def _pattern_addresses(pattern: str, n: int, working_set: int,
                       rng: np.random.Generator) -> np.ndarray:
    ws_blocks = working_set // MEM_REQ
    if pattern == "Seq":
        # several parallel sequential streams (vector operands)
        n_streams = 3
        base = (rng.integers(0, ws_blocks, n_streams)
                * np.ones((n // n_streams + 1, n_streams), np.int64))
        step = np.arange(n // n_streams + 1)[:, None]
        addr = ((base + step) % ws_blocks).reshape(-1)[:n]
        return addr * MEM_REQ
    if pattern == "SeqL":
        # sequential with window reuse (stencil neighbourhoods, rolling
        # reductions): the LLC absorbs most accesses
        front = np.arange(n) // 6
        jitter = rng.integers(-2, 3, n)
        return ((front + jitter) % ws_blocks) * MEM_REQ
    if pattern == "Around":
        # local walk that reverses direction (sort/gauss): next access is
        # +/- a small stride around a slowly advancing front
        front = np.cumsum(rng.integers(0, 2, n)) % ws_blocks
        jitter = rng.integers(-8, 9, n)
        return ((front + jitter) % ws_blocks) * MEM_REQ
    if pattern == "Rand":
        # graph traversal: hot structures (frontier, offsets, visited) are
        # re-touched constantly; neighbour expansions hit cold pages
        hot_blocks = max(ws_blocks // 32, 1)
        hot = rng.integers(0, hot_blocks, n)
        cold = rng.integers(0, ws_blocks, n)
        pick_cold = rng.random(n) < 0.05
        return np.where(pick_cold, cold, hot) * MEM_REQ
    raise ValueError(pattern)


def generate(name: str, n_ops: int = 60_000,
             working_set: int = 640 << 20, seed: int = 0) -> np.ndarray:
    """Build the op trace: structured array (kind: u1, addr: i8)."""
    spec = TABLE_1B[name]
    rng = np.random.default_rng(seed + hash(name) % (1 << 16))
    if spec.pattern == "composite":
        parts = [generate(p, n_ops // len(spec.parts), working_set,
                          seed + 1) for p in spec.parts]
        out = np.concatenate(parts)
        # the paper characterizes the WHOLE application (Table 1b): keep
        # the parts' address locality, resample op kinds to the app's
        # measured compute/load ratios
        n = len(out)
        out["kind"] = np.where(
            rng.random(n) < spec.compute_ratio, 0,
            np.where(rng.random(n) < spec.load_ratio, 1, 2)
        ).astype(np.uint8)
        return out

    kind = np.where(
        rng.random(n_ops) < spec.compute_ratio, 0,
        np.where(rng.random(n_ops) < spec.load_ratio, 1, 2)).astype(np.uint8)
    addr = _pattern_addresses(spec.pattern, n_ops, working_set, rng)
    out = np.zeros(n_ops, dtype=[("kind", "u1"), ("addr", "i8")])
    out["kind"] = kind
    out["addr"] = addr
    return out


def pattern_class(name: str) -> str:
    """Access-pattern class of a workload ("Seq"/"Around"/... or
    "mixed" for composites)."""
    p = TABLE_1B[name].pattern
    if p == "composite":
        return "mixed"
    return p


# --------------------------------------------------------------------- cache
# Traces are deterministic in (name, n_ops, working_set, seed); a sweep
# replays the same trace against many config x media scenarios, so both
# engines share one generation per key. Treat cached traces as read-only.

_TRACE_CACHE: Dict[Tuple[str, int, int, int], np.ndarray] = {}
_TRACE_CACHE_MAX = 64


def generate_cached(name: str, n_ops: int = 60_000,
                    working_set: int = 640 << 20,
                    seed: int = 0) -> np.ndarray:
    """Memoized :func:`generate`: one trace per key, shared across the
    sweep's engines/configs. Returned arrays are read-only by contract."""
    key = (name, n_ops, working_set, seed)
    tr = _TRACE_CACHE.get(key)
    if tr is None:
        if len(_TRACE_CACHE) >= _TRACE_CACHE_MAX:
            _TRACE_CACHE.pop(next(iter(_TRACE_CACHE)))
        tr = _TRACE_CACHE[key] = generate(name, n_ops, working_set, seed)
    return tr
