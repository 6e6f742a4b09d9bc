"""Design-space exploration with the paper's simulator, on the port's
copy of it (``repro_torch.sim``).

The port's counterpart of ``examples/cxl_sim_explore.py``: sweeps backend
media and controller features for one workload and prints the latency
landscape. Runs on the vectorized sweep engine; ``--engine scalar``
replays on the per-access reference oracle instead (same numbers,
slower). The simulator runs on the host: no card needed.

  python examples/cxl_sim_explore_torch.py --workload bfs
  python examples/cxl_sim_explore_torch.py --media-scale 2 --mlp 16
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.sim import run, run_vectorized  # noqa: E402
from repro_torch.sim.workloads import TABLE_1B  # noqa: E402

CONFIGS = ("uvm", "gds", "cxl", "cxl-naive", "cxl-dyn", "cxl-sr", "cxl-ds")


def explore(workload: str = "bfs", *, ops: int = 8000,
            engine: str = "vector", media_scale: float = 1.0, mlp: int = 64,
            store_q: int = 16, log=print) -> dict:
    """The example's work: every config's slowdown over the ideal GPU-DRAM
    baseline on each medium (None where a config has no such medium),
    printed as the reference's table. Returns ``{config: {medium:
    slowdown}}``."""
    sim_fn = run_vectorized if engine == "vector" else run

    def sim(cfg, med):
        return sim_fn(cfg, workload, med, n_ops=ops, mlp=mlp,
                      store_q=store_q).exec_ns

    t0 = time.perf_counter()
    base = sim("gpu-dram", "dram")
    media = ["dram"] + [m if media_scale == 1.0 else f"{m}@{media_scale:g}"
                        for m in ("optane", "znand", "nand")]
    log(f"workload={workload} (pattern {TABLE_1B[workload].pattern}), "
        f"ideal GPU-DRAM baseline normalized to 1.0  [engine={engine}, "
        f"mlp={mlp}, store_q={store_q}]\n")
    log(f"{'config':10s} " + " ".join(f"{m:>10s}" for m in media))
    table = {}
    for cfg in CONFIGS:
        table[cfg], row = {}, []
        for med in media:
            if cfg == "uvm" and med != "dram":
                table[cfg][med] = None
                row.append("      -")
                continue
            table[cfg][med] = sim(cfg, med) / base
            row.append(f"{table[cfg][med]:9.1f}x")
        log(f"{cfg:10s} " + " ".join(f"{v:>10s}" for v in row))
    log(f"\n(x = slowdown vs GPU-DRAM; lower is better. SR recovers the "
        f"read gap, DS the write/GC tail — Fig. 9 in the paper. "
        f"{time.perf_counter() - t0:.2f}s)")
    return table


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="bfs", choices=sorted(TABLE_1B))
    ap.add_argument("--ops", type=int, default=8000)
    ap.add_argument("--engine", default="vector",
                    choices=("vector", "scalar"))
    ap.add_argument("--media-scale", type=float, default=1.0,
                    help="latency multiplier for the SSD media bins "
                         "(the sweep's media-latency axis)")
    ap.add_argument("--mlp", type=int, default=64,
                    help="GPU outstanding-load (MLP) depth")
    ap.add_argument("--store-q", type=int, default=16,
                    help="GPU store-queue depth")
    args = ap.parse_args(argv)
    explore(args.workload, ops=args.ops, engine=args.engine,
            media_scale=args.media_scale, mlp=args.mlp, store_q=args.store_q)


if __name__ == "__main__":
    main()
