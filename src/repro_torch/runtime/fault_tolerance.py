"""Fault tolerance: heartbeats, straggler mitigation, restart policy.

At thousand-node scale the framework assumes failures are routine:

 * ``Heartbeat`` — every worker stamps a monotonic (step, time) record; a
   monitor flags nodes whose stamp lags (dead) or whose step durations
   drift above the fleet median (straggler). On TPU pods the stamps ride
   the coordination service; here they are a local table with the same
   interface.
 * ``StragglerMitigator`` — the paper's DevLoad discipline applied to the
   fleet: the fleet-relative slowdown of a worker maps to a DevLoad state
   and the same controller that throttles SR throttles the offending
   host's input prefetch depth / triggers its eviction, instead of letting
   one slow HBM or NIC gate every all-reduce. :meth:`~StragglerMitigator.
   assess_ports` applies the identical discipline to a CXL tier's root
   ports (``CxlTier.port_stats()``): a hot-removed port is evicted, a
   degraded or DevLoad-pressured port is throttled.
 * ``RestartPolicy`` — crash-consistent resume: (checkpoint step, data
   step, rng) define the restart point; elastic resize re-shards through
   Checkpointer.restore(shardings=new_mesh_shardings).

Every wall-clock read goes through an injectable ``now`` callable
(default ``time.time``): wiring ``lambda: engine.clock_ns / 1e9`` puts
heartbeat liveness on the serving engine's simulated clock, which is
what makes the fault-injection tests deterministic.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.qos import DevLoad, QoSController


@dataclasses.dataclass
class HeartbeatRecord:
    worker: int
    step: int
    t: float
    step_time: float


class Heartbeat:
    """Worker liveness + progress table.

    ``now`` injects the clock every default timestamp is read from
    (seconds; default wall ``time.time``). Pass the serving engine's
    simulated clock — ``lambda: engine.clock_ns / 1e9`` — and liveness
    becomes a pure function of simulated time. Explicit ``now=`` args on
    the methods still override per call.
    """

    def __init__(self, n_workers: int, *, dead_after_s: float = 60.0,
                 now: Optional[Callable[[], float]] = None):
        self.n_workers = n_workers
        self.dead_after_s = dead_after_s
        self.now = now if now is not None else time.time
        self.records: Dict[int, HeartbeatRecord] = {}

    def stamp(self, worker: int, step: int, step_time: float,
              now: Optional[float] = None) -> None:
        self.records[worker] = HeartbeatRecord(
            worker, step, now if now is not None else self.now(),
            step_time)

    def dead_workers(self, now: Optional[float] = None) -> List[int]:
        now = now if now is not None else self.now()
        out = [w for w in range(self.n_workers)
               if w not in self.records
               or now - self.records[w].t > self.dead_after_s]
        return out

    def step_times(self) -> Dict[int, float]:
        return {w: r.step_time for w, r in self.records.items()}


class StragglerMitigator:
    """Fleet-relative slowdown -> DevLoad -> mitigation action."""

    def __init__(self, *, evict_threshold: float = 2.0):
        self.evict_threshold = evict_threshold
        self.controllers: Dict[int, QoSController] = {}

    def assess(self, step_times: Dict[int, float]) -> Dict[int, str]:
        """Returns worker -> action in {ok, throttle, evict}."""
        if not step_times:
            return {}
        med = statistics.median(step_times.values())
        actions: Dict[int, str] = {}
        for w, t in step_times.items():
            ratio = t / med if med > 0 else 1.0
            ctl = self.controllers.setdefault(w, QoSController())
            dl = ctl.classify(occupancy=0.0, service_ratio=ratio)
            ctl.update(dl)
            if ratio >= self.evict_threshold:
                actions[w] = "evict"
            elif dl >= DevLoad.MODERATE:
                actions[w] = "throttle"
            else:
                actions[w] = "ok"
        return actions

    def assess_ports(self, port_stats: List[Dict[str, object]]) \
            -> Dict[int, str]:
        """Map a CXL tier's per-port state onto the same action set.

        Takes ``CxlTier.port_stats()`` rows and returns port -> action:
        a hot-removed port is ``evict`` (its pages are already lost —
        placement must never target it again), a port whose media is
        degraded past ``evict_threshold`` or whose announced DevLoad is
        at/above MODERATE is ``throttle`` (hotness placement demotes
        away from it; the flusher narrows its admission window), and a
        healthy port is ``ok`` — the fleet straggler discipline and the
        endpoint fault discipline reduced to one policy.
        """
        actions: Dict[int, str] = {}
        for row in port_stats:
            port = int(row["port"])  # type: ignore[arg-type]
            if row.get("down"):
                actions[port] = "evict"
            elif (float(row.get("degrade_mult", 1.0))  # type: ignore
                  >= self.evict_threshold
                  or int(row.get("devload", 0))  # type: ignore
                  >= DevLoad.MODERATE):
                actions[port] = "throttle"
            else:
                actions[port] = "ok"
        return actions


@dataclasses.dataclass
class RestartPoint:
    checkpoint_step: int
    data_step: int
    seed: int


class RestartPolicy:
    """Decides resume point + mesh shape after failures."""

    def __init__(self, *, min_workers: int):
        self.min_workers = min_workers

    def plan(self, n_alive: int, latest_ckpt: Optional[int],
             data_step: int, seed: int) -> Tuple[str, RestartPoint]:
        """Returns (action, restart_point); action in {continue, resize,
        halt}."""
        point = RestartPoint(latest_ckpt if latest_ckpt is not None else -1,
                             data_step, seed)
        if n_alive < self.min_workers:
            return "halt", point
        if latest_ckpt is None:
            return "halt", point
        return "resize", point
