"""Declarative scenario sweeps over the CXL-GPU simulator.

A :class:`Scenario` names one simulator run (config x workload x media x
GPU queue shape); :func:`matrix` builds cross products, :func:`fig9_matrix`
reproduces the paper's Figure-9 evaluation set, and :func:`run_sweep` fans
a scenario list out over the vectorized engine (optionally across worker
processes) with trace/LLC-mask precomputation shared per workload.

:func:`bench` is the perf/accuracy harness behind ``benchmarks/sweep.py``:
it replays a matrix on both engines, verifies the vectorized engine
against the scalar oracle per scenario, and emits the ``BENCH_sim.json``
artifact consumed by CI.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.sim import engine as scalar_engine
from repro_torch.sim import vector as vector_engine
from repro_torch.sim.engine import MLP, STORE_Q, RunResult
from repro_torch.sim.workloads import ORDER

DEFAULT_N_OPS = int(os.environ.get("REPRO_SIM_OPS", "12000"))


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One simulator run. ``media`` accepts scaled variants ("znand@2" =
    a 2x-latency tail bin — the media-latency-distribution axis)."""

    config: str
    workload: str
    media: str = "dram"
    n_ops: int = DEFAULT_N_OPS
    mlp: int = MLP
    store_q: int = STORE_Q
    seed: int = 0

    @property
    def key(self) -> str:
        """Stable scenario id ("config/workload/media[/...]") for results
        tables and artifact keys."""
        tail = f"/n{self.n_ops}"
        if (self.mlp, self.store_q) != (MLP, STORE_Q):
            tail += f"/mlp{self.mlp}sq{self.store_q}"
        if self.seed:
            tail += f"/s{self.seed}"
        return f"{self.config}/{self.workload}/{self.media}{tail}"


def matrix(configs: Sequence[str], workloads: Sequence[str],
           media: Sequence[str] = ("dram",), *,
           n_ops: int = DEFAULT_N_OPS, mlps: Sequence[int] = (MLP,),
           store_qs: Sequence[int] = (STORE_Q,),
           seeds: Sequence[int] = (0,)) -> List[Scenario]:
    """Cross-product scenario matrix, de-duplicated, in stable order."""
    out = []
    for w, m, cfg, mlp, sq, seed in itertools.product(
            workloads, media, configs, mlps, store_qs, seeds):
        out.append(Scenario(cfg, w, m, n_ops=n_ops, mlp=mlp, store_q=sq,
                            seed=seed))
    return list(dict.fromkeys(out))


def fig9_matrix(n_ops: int = DEFAULT_N_OPS) -> List[Scenario]:
    """The paper's Figure 9 evaluation set (9a-9e), grouped by workload so
    per-trace precomputation amortizes across configs/media."""
    out: List[Scenario] = []
    for w in ORDER:
        # 9a: DRAM expander vs ideal / UVM
        out += matrix(("gpu-dram", "uvm", "cxl"), (w,), ("dram",),
                      n_ops=n_ops)
        # 9b: SSD expander, SR/DS ladder
        out += matrix(("cxl", "cxl-sr", "cxl-ds"), (w,), ("znand",),
                      n_ops=n_ops)
    # 9c: backend-media sweep
    out += matrix(("cxl", "cxl-sr", "cxl-ds"), ("vadd", "path", "bfs"),
                  ("optane", "znand", "nand"), n_ops=n_ops)
    # 9d: SR ablation ladder per access pattern
    out += matrix(("cxl", "cxl-naive", "cxl-dyn", "cxl-sr"),
                  ("vadd", "sort", "path"), ("znand",), n_ops=n_ops)
    return list(dict.fromkeys(out))


def smoke_matrix(n_ops: int = 4000) -> List[Scenario]:
    """CI smoke set: all eight configs, all four media classes, a scaled
    media-latency bin and a narrow GPU queue shape — small but covering
    every engine path."""
    out: List[Scenario] = []
    out += matrix(("gpu-dram", "uvm", "gds"), ("vadd", "bfs"), ("dram",),
                  n_ops=n_ops)
    out += matrix(("gds",), ("vadd",), ("znand",), n_ops=n_ops)
    out += matrix(("cxl", "cxl-naive", "cxl-dyn", "cxl-sr", "cxl-ds"),
                  ("vadd", "bfs"), ("dram", "znand"), n_ops=n_ops)
    out += matrix(("cxl-sr", "cxl-ds"), ("rsum",),
                  ("optane", "nand", "znand@2"), n_ops=n_ops)
    out += matrix(("cxl-sr",), ("vadd",), ("znand",), n_ops=n_ops,
                  mlps=(16,), store_qs=(4,))
    return list(dict.fromkeys(out))


_ENGINES = {"vector": vector_engine.run, "scalar": scalar_engine.run}


def run_scenario(s: Scenario, engine: str = "vector") -> RunResult:
    """Run one scenario on the named engine ("vector" or "scalar")."""
    return _ENGINES[engine](s.config, s.workload, s.media, n_ops=s.n_ops,
                            mlp=s.mlp, store_q=s.store_q, seed=s.seed)


def _result_row(s: Scenario, r: RunResult) -> Dict:
    return {"config": s.config, "workload": s.workload, "media": s.media,
            "n_ops": s.n_ops, "mlp": s.mlp, "store_q": s.store_q,
            "exec_ns": float(r.exec_ns),
            "latency_per_op": float(r.latency_per_op),
            "ep_hit_rate": float(r.ep_hit_rate), "sr": r.sr, "ds": r.ds}


def _worker(args: Tuple[Scenario, str]) -> Tuple[str, Dict]:
    s, engine = args
    return s.key, _result_row(s, run_scenario(s, engine))


def run_sweep(scenarios: Iterable[Scenario], engine: str = "vector",
              workers: int = 0) -> Dict[str, Dict]:
    """Fan a scenario list out; returns {scenario.key: result row}.

    workers=0 runs in-process (traces/LLC masks shared via the bundle
    cache); workers>1 uses a process pool, with scenarios grouped by
    workload so each worker still amortizes precomputation.
    """
    scenarios = list(scenarios)
    if workers and workers > 1:
        import multiprocessing as mp

        grouped = sorted(scenarios,
                         key=lambda s: (s.workload, s.n_ops, s.seed))
        with mp.Pool(workers) as pool:
            chunk = max(1, len(grouped) // (workers * 4))
            pairs = pool.map(_worker, [(s, engine) for s in grouped],
                             chunksize=chunk)
        rows = dict(pairs)
        return {s.key: rows[s.key] for s in scenarios}
    return dict(_worker((s, engine)) for s in scenarios)


def bench(scenarios: Iterable[Scenario], *, compare: bool = True,
          equivalence_sample: Optional[int] = None,
          workers: int = 0) -> Dict:
    """Perf/accuracy harness -> BENCH_sim.json payload.

    Replays the matrix on the vectorized engine (timed), optionally on
    the scalar oracle (timed), and checks per-scenario cycle-total
    equivalence. ``equivalence_sample`` limits the oracle replay to the
    first N scenarios (CI smoke); ``compare=False`` skips it entirely.
    """
    scenarios = list(scenarios)

    t0 = time.perf_counter()
    rows = run_sweep(scenarios, engine="vector")
    vector_s = time.perf_counter() - t0

    fanout_s = None
    workers = workers or (os.cpu_count() or 1)
    if workers > 1:
        t0 = time.perf_counter()
        run_sweep(scenarios, engine="vector", workers=workers)
        fanout_s = time.perf_counter() - t0

    scalar_s = None
    eq: Dict[str, float] = {}
    if compare:
        sample = scenarios if equivalence_sample is None \
            else scenarios[:equivalence_sample]
        t0 = time.perf_counter()
        for s in sample:
            r = run_scenario(s, engine="scalar")
            ref = float(r.exec_ns)
            got = rows[s.key]["exec_ns"]
            eq[s.key] = float(abs(got - ref) / max(abs(ref), 1e-12))
        scalar_s = time.perf_counter() - t0

    out = {
        "matrix": {"n_scenarios": len(scenarios),
                   "n_ops": scenarios[0].n_ops if scenarios else 0,
                   "cpu_count": os.cpu_count()},
        "perf": {
            "vector_s": round(vector_s, 4),
            "vector_fanout_s": (round(fanout_s, 4)
                                if fanout_s is not None else None),
            "fanout_workers": workers if fanout_s is not None else None,
            "scalar_s": (round(scalar_s, 4)
                         if scalar_s is not None else None),
            "engine_speedup": (round(scalar_s / vector_s, 2)
                               if scalar_s and len(eq) == len(scenarios)
                               else None),
        },
        "accuracy": {
            "compared": len(eq),
            "max_rel_err": float(max(eq.values())) if eq else None,
            "tolerance": 0.01,
            "pass": bool(max(eq.values()) <= 0.01) if eq else None,
        },
        "results": rows,
    }
    if eq:
        worst = sorted(eq.items(), key=lambda kv: -kv[1])[:5]
        out["accuracy"]["worst"] = [
            {"scenario": k, "rel_err": v} for k, v in worst]
    return out


# page-trace closed-form scenarios (the ``page_trace`` section of
# BENCH_sim.json): synthetic tier-style op traces priced by both the
# vectorized closed form and the scalar oracle. The async configs are
# the ones the in-flight-cap issue-stall recurrence vectorizes; they
# carry the >= 5x wall-time speedup gate.
PAGE_TRACE_SCENARIOS = {
    "blocking-1port": {"ports": ("dram",), "async_frac": 0.0},
    "async-1port": {"ports": ("dram",), "async_frac": 0.6},
    "async-3port": {"ports": ("dram", "dram@2", "dram@4"),
                    "async_frac": 0.6},
}


def _synth_page_trace(ports: Sequence[str], n_ops: int,
                      async_frac: float, seed: int = 0) -> List[tuple]:
    """Deterministic synthetic page trace in ``CxlTier.ops`` format:
    ``(kind, addr, nbytes)`` tuples, port-tagged 4-tuples when more than
    one port is given (advance records use port -1, dt in nbytes)."""
    import random
    rng = random.Random(seed)
    tagged = len(ports) > 1
    ops: List[tuple] = []
    base = [0] * len(ports)
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.10:
            rec = (scalar_engine.PAGE_ADVANCE, 0, rng.randrange(500, 3000))
            ops.append((-1,) + rec if tagged else rec)
            continue
        port = rng.randrange(len(ports))
        nbytes = rng.randrange(1 << 10, 48 << 10)
        if r < 0.15:
            kind = scalar_engine.PAGE_PREFETCH
        elif r < 0.55:
            kind = scalar_engine.PAGE_READ_ASYNC \
                if rng.random() < async_frac else scalar_engine.PAGE_READ
        else:
            kind = scalar_engine.PAGE_WRITE_ASYNC \
                if rng.random() < async_frac else scalar_engine.PAGE_WRITE
        addr = base[port]
        base[port] += -(-nbytes // 4096) * 4096
        rec = (kind, addr, nbytes)
        ops.append((port,) + rec if tagged else rec)
    return ops


def page_trace_bench(n_ops: int = 4000) -> Dict:
    """Closed-form vs scalar-oracle page-trace replay (``page_trace``
    section of BENCH_sim.json).

    Per scenario: both engines price one synthetic trace; gates per-op
    max rel err <= 1% everywhere and a >= 5x wall-time speedup on the
    async configs (the blocking config collapses to pure algebra, so
    its speedup is reported but not gated).
    """
    scens = {}
    for name, spec in PAGE_TRACE_SCENARIOS.items():
        ports = spec["ports"]
        ops = _synth_page_trace(ports, n_ops, spec["async_frac"])
        tagged = len(ports) > 1
        t0 = time.perf_counter()
        vec = vector_engine.page_trace_closed_form(
            ops, list(ports) if tagged else ports[0])
        vector_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        oracle = scalar_engine.replay_page_trace(
            ops, media=ports[0], topology=list(ports) if tagged else None)
        scalar_s = time.perf_counter() - t0
        rel = float(np.max(np.abs(vec - oracle)
                           / np.maximum(np.abs(oracle), 1e-9)))
        speedup = scalar_s / max(vector_s, 1e-9)
        is_async = spec["async_frac"] > 0
        scens[name] = {
            "n_ops": len(ops),
            "ports": list(ports),
            "async": is_async,
            "max_rel_err": rel,
            "vector_s": round(vector_s, 5),
            "scalar_s": round(scalar_s, 5),
            "speedup": round(speedup, 1),
            "pass": bool(rel <= 0.01
                         and (speedup >= 5.0 if is_async else True)),
        }
    return {"scenarios": scens, "tolerance": 0.01, "speedup_floor": 5.0,
            "pass": all(s["pass"] for s in scens.values())}


def category_means(rows: Dict[str, Dict], baseline_config: str = "gpu-dram"
                   ) -> Dict[str, Dict[str, float]]:
    """Per-config mean slowdown vs the baseline config, by workload
    category (the aggregation Fig. 9's bar groups use)."""
    from repro_torch.sim.workloads import CATEGORY

    base: Dict[Tuple[str, str], float] = {}
    for row in rows.values():
        if row["config"] == baseline_config:
            base[(row["workload"], row["media"])] = row["exec_ns"]
    agg: Dict[str, Dict[str, List[float]]] = {}
    for row in rows.values():
        b = base.get((row["workload"], "dram"))
        if not b or row["config"] == baseline_config:
            continue
        cat = CATEGORY.get(row["workload"], "other")
        agg.setdefault(row["config"], {}).setdefault(cat, []).append(
            row["exec_ns"] / b)
    return {cfg: {cat: float(np.mean(v)) for cat, v in cats.items()}
            for cfg, cats in agg.items()}
