"""Cycle-approximate CXL-GPU simulator (copies of the reference package's
``sim`` modules, imports rewritten to ``repro_torch``).

Scalar oracle (``engine``), vectorized sweep engine (``vector``),
root-port controller (``controller``), media/endpoint models (``media``),
Table 1b trace generators (``workloads``) and scenario matrices
(``sweep``). ``engine`` also hosts the page-granular timing surface the
serving tier charges against (``PageStream`` / ``Topology``).
"""
from repro_torch.sim.engine import (OpHandle, PageStream, RunResult,
                                    Topology, replay_page_trace, run,
                                    slowdown_vs_ideal)
from repro_torch.sim.media import (DRAM, MEDIA, NAND, OPTANE, ZNAND,
                                   Endpoint, resolve_media)
from repro_torch.sim.controller import RootPortController
from repro_torch.sim.vector import run as run_vectorized
from repro_torch.sim import sweep, workloads

__all__ = ["RunResult", "run", "run_vectorized", "slowdown_vs_ideal",
           "OpHandle", "PageStream", "Topology", "replay_page_trace",
           "DRAM", "MEDIA", "NAND", "OPTANE", "ZNAND", "Endpoint",
           "RootPortController", "resolve_media", "sweep", "workloads"]
