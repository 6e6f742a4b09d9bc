"""Execution engine: replay a workload trace against a GPU configuration.

Configurations (paper §EVALUATION):
  gpu-dram  — ideal: everything fits in local GPU memory.
  uvm       — unified virtual memory: on-demand page migration from host
              DRAM with ~500us host-runtime fault handling (ref. 11).
  gds       — GPUDirect storage: faults resolved from the SSD, same host
              runtime cost per fault.
  cxl       — the proposed CXL root complex (direct 64B loads/stores).
  cxl-naive — + naive SR (64B MemSpecRd per queued request)   [Fig. 9d]
  cxl-dyn   — + DevLoad-sized SR from the request address      [Fig. 9d]
  cxl-sr    — + address-window control (full SR)               [Fig. 9b-d]
  cxl-ds    — cxl-sr + deterministic store                     [Fig. 9b-e]

GPU model: a rolling timeline with memory-level parallelism — loads issue
into a 32-deep queue and only block when the queue is full or a value is
needed LOOKAHEAD ops later; stores block only when the 32-deep store
queue is full. An LLC (4 MiB, 64B lines, LRU) filters the trace exactly as
the paper's cache hierarchy does (compute-intensive workloads mostly hit).
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.sim import workloads as wl
from repro_torch.sim.controller import (CXL_RTT_NS, GPU_MEM_NS,
                                  RootPortController)
from repro_torch.sim.media import (MEDIA, DRAM, Endpoint, MediaModel,
                             resolve_media)

COMPUTE_NS = 8.0
LLC_NS = 4.0
FAULT_NS = 12_000.0           # UVM/GDS host-runtime fault service (ref. 11
                              # measures tens of us per fault; the paper's
                              # ~500us figure amortizes batched groups)
PCIE_NS_PER_B = 1.0 / 32.0    # PCIe 5.0 x8 ~ 32 GB/s
PAGE = 4 << 10                # UVM base migration granule
LLC_LINES = (4 << 20) // 64
MLP = 64                      # outstanding loads (8 cores x 8 threads with
                              # warp switching: issue continues until the
                              # scoreboard is exhausted)
STORE_Q = 16
WARMUP_FRAC = 0.33            # caches/pages warm before timing starts


class LRU:
    """Bounded LRU set of keys (LLC lines / UVM pages), capacity in keys."""

    __slots__ = ("cap", "d")

    def __init__(self, cap: int):
        self.cap = cap
        self.d: OrderedDict = OrderedDict()

    def hit(self, key) -> bool:
        """Probe + refresh recency; True iff ``key`` is resident."""
        if key in self.d:
            self.d.move_to_end(key)
            return True
        return False

    def fill(self, key) -> None:
        """Insert ``key``, evicting the least recently used past ``cap``."""
        if key in self.d:
            self.d.move_to_end(key)
            return
        if len(self.d) >= self.cap:
            self.d.popitem(last=False)
        self.d[key] = True


@dataclasses.dataclass
class RunResult:
    """One engine run's outcome: timed window + controller telemetry.

    ``exec_ns`` is the post-warmup simulated execution time in ns over
    ``n_ops`` trace entries; ``sr``/``ds`` hold the controller's SR and
    deterministic-store counters when a CXL config ran.
    """

    config: str
    workload: str
    media: str
    exec_ns: float
    n_ops: int
    ep_hit_rate: float
    sr: Optional[dict] = None
    ds: Optional[dict] = None
    samples: Optional[list] = None    # (t, latency, kind) for Fig. 9e

    @property
    def latency_per_op(self) -> float:
        """Mean simulated ns per (post-warmup) trace op."""
        return self.exec_ns / self.n_ops


def run(config: str, workload: str, media_name: str = "dram", *,
        n_ops: int = 60_000, gpu_mem_frac: float = 0.1,
        working_set: int = 640 << 20, seed: int = 0,
        record_samples: bool = False, mlp: int = MLP,
        store_q: int = STORE_Q,
        trace: Optional[np.ndarray] = None) -> RunResult:
    """Scalar reference engine (per-access event loop) — the oracle the
    vectorized engine in ``repro_torch.sim.vector`` is validated against.

    mlp / store_q are the GPU's outstanding-load and store-queue depths
    (sweepable); ``media_name`` accepts scaled variants ("znand@2"); an
    explicit ``trace`` (structured kind/addr array) overrides the named
    workload's generated trace.
    """
    if trace is None:
        trace = wl.generate_cached(workload, n_ops, working_set, seed)
    media = resolve_media(media_name)
    llc = LRU(LLC_LINES)
    gpu_mem = int(working_set * gpu_mem_frac)

    t = 0.0
    loads_q: List[Tuple[float, int]] = []   # (completion, op_idx) heap
    stores_q: List[float] = []
    samples: List[Tuple[float, float, int]] = []
    hbm = [0.0] * 8                         # local-memory banks (finite BW)

    def hbm_access(now: float) -> float:
        b = min(range(8), key=lambda i: hbm[i])
        done = max(now, hbm[b]) + GPU_MEM_NS
        hbm[b] = max(now, hbm[b]) + GPU_MEM_NS / 4   # pipelined banks
        return done

    ep: Optional[Endpoint] = None
    ctl: Optional[RootPortController] = None
    pages: Optional[LRU] = None

    if config == "gpu-dram":
        pass
    elif config in ("uvm", "gds"):
        pages = LRU(max(gpu_mem // PAGE, 1))
    else:
        ep = Endpoint(media, dram_cache_bytes=gpu_mem // 4)
        sr_mode = {"cxl": "off", "cxl-naive": "naive", "cxl-dyn": "dyn",
                   "cxl-sr": "sr", "cxl-ds": "sr"}[config]
        ctl = RootPortController(ep, sr_mode=sr_mode,
                                 ds_enabled=(config == "cxl-ds"))

    def drain_loads() -> None:
        nonlocal t
        while loads_q and len(loads_q) >= mlp:
            done, _ = heapq.heappop(loads_q)
            t = max(t, done)

    def fault(addr: int) -> float:
        """UVM/GDS page fault: host runtime + page move."""
        page = addr // PAGE
        if pages.hit(page):
            return GPU_MEM_NS
        pages.fill(page)
        move = PAGE * PCIE_NS_PER_B
        if config == "gds":
            move += media.read_ns + PAGE / media.bw_gbps
        else:
            move += DRAM.read_ns
        return FAULT_NS + move

    kinds = trace["kind"]
    addrs = trace["addr"]
    warm_i = int(len(trace) * WARMUP_FRAC)
    t_warm = 0.0
    for i in range(len(trace)):
        if i == warm_i:
            t_warm = t
        kind = int(kinds[i])
        if kind == 0:
            t += COMPUTE_NS
            if ctl is not None and i % 16 == 0:
                ctl.background_flush(t)
            continue
        addr = int(addrs[i])
        line = addr // 64
        if llc.hit(line):
            t += LLC_NS
            continue
        llc.fill(line)
        if kind == 1:                                   # ---- load
            drain_loads()
            if config == "gpu-dram":
                done = hbm_access(t)
            elif config in ("uvm", "gds"):
                lat = fault(addr)
                if lat > GPU_MEM_NS:                    # blocking fault
                    t += lat
                    done = t
                else:
                    done = t + lat
            else:
                done = ctl.load(t, addr)
            heapq.heappush(loads_q, (done, i))
            if record_samples:
                samples.append((t, done - t, 1))
            t += LLC_NS
        else:                                           # ---- store
            while stores_q and (len(stores_q) >= store_q):
                t = max(t, heapq.heappop(stores_q))
            if config == "gpu-dram":
                done = hbm_access(t)
            elif config in ("uvm", "gds"):
                lat = fault(addr)
                if lat > GPU_MEM_NS:
                    t += lat
                    done = t
                else:
                    done = t + lat
            else:
                done = ctl.store(t, addr)
            heapq.heappush(stores_q, done)
            if record_samples:
                samples.append((t, done - t, 2))
            t += LLC_NS

    while loads_q:
        done, _ = heapq.heappop(loads_q)
        t = max(t, done)
    while stores_q:
        t = max(t, heapq.heappop(stores_q))

    return RunResult(
        config=config, workload=workload,
        media=getattr(media_name, "name", media_name),
        exec_ns=t - t_warm, n_ops=len(trace) - warm_i,
        ep_hit_rate=ep.hit_rate() if ep else 0.0,
        sr=dataclasses.asdict(ctl.sr_stats) if ctl else None,
        ds=dict(ctl.ds_stats) if ctl else None,
        samples=samples if record_samples else None)


def slowdown_vs_ideal(config: str, workload: str, media: str = "dram",
                      **kw) -> float:
    """Execution-time ratio of ``config`` vs the gpu-dram ideal (Fig. 9)."""
    base = run("gpu-dram", workload, media, **kw).exec_ns
    return run(config, workload, media, **kw).exec_ns / base


def category_mean(results: Dict[str, float], category: str) -> float:
    """Mean of per-workload ``results`` over one Table 1b category."""
    names = [n for n, s in wl.TABLE_1B.items() if s.category == category]
    vals = [results[n] for n in names if n in results]
    return float(np.mean(vals)) if vals else float("nan")


# ---------------------------------------------------------------------------
# Single-stream page timing (the serving tier's front-end)
# ---------------------------------------------------------------------------
#
# The serving engine moves KV pages, not 64B cache lines: a retired slot's
# pages flush to the expansion tier, a prefix restore pulls them back. The
# PageStream below is the reusable timing API both sides of that traffic
# share — one root port + EP (the same silicon model the trace engine
# drives). Two disciplines coexist on one port clock:
#
#  * blocking ops (``read``/``write``) stall the caller until the pages
#    land — the slot-synchronous model the serving tier started with;
#  * non-blocking ops (``issue``/``poll``) start the media work on the
#    port's service cursor and hand back an :class:`OpHandle` carrying the
#    completion timestamp; the caller's clock only moves when the per-port
#    in-flight cap forces an issue stall. Completions retire as simulated
#    time (``advance``) passes the handle's ``done_ns`` — the paper's
#    latency hiding: media work overlaps the decode ticks in between.

PAGE_ADVANCE = 0      # idle time passing between engine ticks (nbytes = ns)
PAGE_READ = 1         # demand page read (restore fetch)
PAGE_WRITE = 2        # page writeback (flush to the cold tier)
PAGE_PREFETCH = 3     # MemSpecRd stream for an upcoming restore
PAGE_READ_ASYNC = 4   # non-blocking demand read (charged = issue wait only)
PAGE_WRITE_ASYNC = 5  # non-blocking writeback (charged = issue wait only)

# fault-annotated variants: same timing discipline as their base kind but
# the op crossed the fault path (retried under a transient window, or hit
# a downed port). Replaying them requires the recording run's
# FaultSchedule — PageStream.op refuses them without one, and the
# closed-form engine (sim.vector.page_trace_closed_form) rejects them
# outright, exactly like the async kinds.
PAGE_READ_FAULT = 6         # blocking read that crossed the fault path
PAGE_WRITE_FAULT = 7        # blocking write that crossed the fault path
PAGE_READ_ASYNC_FAULT = 8   # non-blocking read, fault-annotated
PAGE_WRITE_ASYNC_FAULT = 9  # non-blocking write, fault-annotated

PAGE_FAULT_KINDS = (PAGE_READ_FAULT, PAGE_WRITE_FAULT,
                    PAGE_READ_ASYNC_FAULT, PAGE_WRITE_ASYNC_FAULT)
# fault kind -> the base kind whose timing discipline it replays with
_FAULT_BASE_KIND = {PAGE_READ_FAULT: PAGE_READ,
                    PAGE_WRITE_FAULT: PAGE_WRITE,
                    PAGE_READ_ASYNC_FAULT: PAGE_READ_ASYNC,
                    PAGE_WRITE_ASYNC_FAULT: PAGE_WRITE_ASYNC}

MAX_INFLIGHT_OPS = 4  # default per-port cap on outstanding async page ops

MAX_OP_RETRIES = 4         # bounded retry budget per page op (no livelock)
RETRY_BACKOFF_NS = 2_000.0  # first retry backoff; doubles per retry


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled endpoint fault, keyed to simulated ns.

    ``kind`` is ``"degrade"`` (media service time multiplied by ``mult``
    while the window ``[t_ns, until_ns)`` is active), ``"transient"``
    (each CXL.mem page-op attempt on the port fails with probability
    ``p_err`` inside the window, charged a bounded retry-with-backoff) or
    ``"hot_remove"`` (the port is down from ``t_ns`` on — permanent;
    ``until_ns`` is ignored). Use the :func:`degrade` / :func:`transient`
    / :func:`hot_remove` helpers rather than building events by hand.
    """

    t_ns: float
    port: int
    kind: str
    mult: float = 1.0
    p_err: float = 0.0
    until_ns: float = float("inf")


def degrade(t_ns: float, port: int, mult: float,
            until_ns: float = float("inf")) -> FaultEvent:
    """A latency-spike window: ``port``'s media service time is scaled by
    ``mult`` while ``t_ns <= now < until_ns``."""
    if mult <= 0:
        raise ValueError(f"degrade mult must be > 0 (got {mult})")
    return FaultEvent(t_ns=float(t_ns), port=int(port), kind="degrade",
                      mult=float(mult), until_ns=float(until_ns))


def transient(t_ns: float, port: int, p_err: float,
              until_ns: float = float("inf")) -> FaultEvent:
    """A transient-error window: page-op attempts on ``port`` fail with
    probability ``p_err`` while ``t_ns <= now < until_ns`` (decided by a
    seeded hash, so live runs and oracle replays agree exactly)."""
    if not 0.0 <= p_err <= 1.0:
        raise ValueError(f"transient p_err must be in [0, 1] (got {p_err})")
    return FaultEvent(t_ns=float(t_ns), port=int(port), kind="transient",
                      p_err=float(p_err), until_ns=float(until_ns))


def hot_remove(t_ns: float, port: int) -> FaultEvent:
    """A permanent endpoint removal: ``port`` is down from ``t_ns`` on;
    every page op on it fails instantly and costs nothing."""
    return FaultEvent(t_ns=float(t_ns), port=int(port), kind="hot_remove")


@dataclasses.dataclass(frozen=True)
class PortFaultState:
    """The folded fault state of one port at one instant of simulated
    time: ``down`` (and since when), the product of active degrade
    multipliers, and the max active transient error probability."""

    down: bool = False
    down_since: float = float("inf")
    mult: float = 1.0
    p_err: float = 0.0


class FaultSchedule:
    """A deterministic, replayable schedule of endpoint faults.

    The schedule is pure: :meth:`state` is a function of (port, time)
    alone and :meth:`op_fails` of (seed, port, attempt-ordinal) alone, so
    a live tier run and a fresh :func:`replay_page_trace` of its recorded
    trace — which walk identical op sequences on identical clocks — see
    identical degrade windows, identical transient failures and identical
    retry counts. That is what keeps the scalar oracle within 1% under
    fault injection.
    """

    def __init__(self, events, seed: int = 0):
        events = tuple(sorted(events, key=lambda e: e.t_ns))
        for e in events:
            if e.kind not in ("degrade", "transient", "hot_remove"):
                raise ValueError(f"unknown fault kind {e.kind!r}")
            if e.until_ns <= e.t_ns:
                raise ValueError(f"empty fault window: {e.kind} on port "
                                 f"{e.port} ends at {e.until_ns} ns but "
                                 f"starts at {e.t_ns} ns")
        self.events = events
        self.seed = int(seed)

    def ports(self):
        """The sorted set of ports named by any event in the schedule."""
        return sorted({e.port for e in self.events})

    def state(self, port: int, t_ns: float) -> PortFaultState:
        """Fold every event active on ``port`` at ``t_ns`` into one
        :class:`PortFaultState` (pure; safe to call repeatedly)."""
        down, down_since, mult, p_err = False, float("inf"), 1.0, 0.0
        for e in self.events:
            if e.port != port or t_ns < e.t_ns:
                continue
            if e.kind == "hot_remove":
                down = True
                down_since = min(down_since, e.t_ns)
            elif t_ns < e.until_ns:
                if e.kind == "degrade":
                    mult *= e.mult
                else:
                    p_err = max(p_err, e.p_err)
        return PortFaultState(down=down, down_since=down_since,
                              mult=mult, p_err=p_err)

    def ports_down(self, t_ns: float):
        """Ports hot-removed at or before ``t_ns`` (sorted list)."""
        return sorted({e.port for e in self.events
                       if e.kind == "hot_remove" and e.t_ns <= t_ns})

    def op_fails(self, port: int, attempt: int, p_err: float) -> bool:
        """Deterministic transient-failure draw for one op attempt.

        ``attempt`` is the port's monotone attempt ordinal (each service
        attempt of each page op consumes one), so the draw sequence is
        identical between a live run and its trace replay. The draw
        hashes (seed, port, attempt) — not time — making it robust to
        float jitter at window edges.
        """
        if p_err <= 0.0:
            return False
        h = hashlib.blake2b(f"{self.seed}:{port}:{attempt}".encode(),
                            digest_size=8).digest()
        return int.from_bytes(h, "big") / 2.0 ** 64 < p_err


@dataclasses.dataclass
class OpHandle:
    """Completion handle for one non-blocking page op on one port.

    All timestamps are simulated ns on the issuing port's clock:
    ``issued_ns`` is the caller's clock when the op was issued (after any
    in-flight-cap stall), ``start_ns`` when the port began servicing it,
    ``done_ns`` its completion, and ``wait_ns`` the issue stall the
    in-flight cap charged the caller (0.0 when a slot was free). The op
    is complete once the port clock reaches ``done_ns`` (see
    :meth:`PageStream.poll`).
    """

    kind: int
    addr: int
    nbytes: int
    port: int
    issued_ns: float
    start_ns: float
    done_ns: float
    wait_ns: float
    retries: int = 0      # transient-error retries the op absorbed
    failed: bool = False  # retry budget exhausted, or port hot-removed

    @property
    def in_flight_ns(self) -> float:
        """Simulated ns the op was outstanding (issue -> completion)."""
        return self.done_ns - self.issued_ns


class PageStream:
    """Single-stream page timing over one root port + EP.

    ``repro_torch.core.tier.CxlTier`` charges the serving engine's page traffic
    against this API incrementally; :func:`replay_page_trace` replays a
    recorded page trace against a fresh instance — the scalar oracle the
    tier's online accounting is differentially tested against.

    Each page op is decomposed into ``req_bytes``-spaced CXL.mem requests
    issued back-to-back (the next request leaves when the previous one
    completes). Reads go through ``RootPortController.load`` — so SR
    window generation, ring dedup and DevLoad telemetry all engage;
    writes go through ``RootPortController.store`` — deterministic stores
    complete at GPU-memory speed and divert to staging under congestion;
    prefetches stream straight to the EP's internal DRAM (the MemSpecRd
    fill), off the critical path, honoring the QoS halt state.

    Blocking ops (``read``/``write``) advance ``now`` to the completion;
    non-blocking ops (``issue``) advance only the port's service cursor
    (``busy_until``) and return an :class:`OpHandle` — ``now`` moves just
    for the in-flight-cap stall, so media work overlaps whatever the
    caller does until it ``poll``\\ s the handle. Both disciplines share
    one cursor: a blocking op issued behind outstanding async work queues
    behind it.
    """

    def __init__(self, media: str = "znand", *, sr: bool = True,
                 ds: bool = True, req_bytes: int = 256,
                 dram_cache_bytes: int = 8 << 20,
                 max_inflight: int = MAX_INFLIGHT_OPS,
                 faults: Optional[FaultSchedule] = None, port_id: int = 0):
        self.ep = Endpoint(resolve_media(media),
                           dram_cache_bytes=dram_cache_bytes)
        self.ctl = RootPortController(self.ep,
                                      sr_mode="sr" if sr else "off",
                                      ds_enabled=ds)
        self.req_bytes = int(req_bytes)
        self.now = 0.0
        self.busy_until = 0.0           # port service cursor (>= now only
        if int(max_inflight) < 1:       # while async ops are out)
            raise ValueError("max_inflight must be >= 1 "
                             f"(got {max_inflight})")
        self.max_inflight = int(max_inflight)
        self.inflight: List[OpHandle] = []
        self.prefetch_pages = 0
        self.prefetch_halted = 0
        # ---- fault injection (None = healthy port, zero overhead)
        self.faults = faults
        self.port_id = int(port_id)
        self.down = False               # hot-removed (permanent)
        self.down_since = float("inf")
        self.fault_retries = 0          # transient retries absorbed
        self.fault_failures = 0         # ops that exhausted the budget
        self.fault_backoff_ns = 0.0     # total retry backoff charged
        self.last_op_retries = 0        # annotation of the latest read/write
        self.last_op_failed = False
        self._base_media = self.ep.media
        self._applied_mult = 1.0
        self._attempts = 0              # monotone per-port attempt ordinal

    @property
    def degrade_mult(self) -> float:
        """The degrade multiplier currently applied to the port's media
        (1.0 = healthy; updated at fault-window boundaries)."""
        return self._applied_mult

    def _service(self, kind: int, addr: int, nbytes: int,
                 start: float) -> float:
        """Walk one page op's CXL.mem requests from ``start``; returns the
        completion time (ns). ``kind`` is PAGE_READ or PAGE_WRITE."""
        t = start
        if kind == PAGE_READ:
            for a in range(addr, addr + nbytes, self.req_bytes):
                t = self.ctl.load(t, a)
        else:
            for a in range(addr, addr + nbytes, self.req_bytes):
                t = self.ctl.store(t, a)
        return t

    def _retire_completed(self) -> None:
        """Drop handles the stream clock has passed (pure function of
        ``now`` — polling early never changes subsequent timing)."""
        if self.inflight:
            self.inflight = [h for h in self.inflight
                             if h.done_ns > self.now]

    def _fault_state(self, t: float) -> Optional[PortFaultState]:
        """Fold the schedule at ``t`` and apply its side effects: swap in
        the degraded (scaled) media at window boundaries and latch
        hot-removal — failing any in-flight op whose completion lies past
        the removal instant. Pure in ``t``, so the live tier and the
        trace replay (identical clocks) apply identical transitions."""
        if self.faults is None:
            return None
        st = self.faults.state(self.port_id, t)
        if st.down and not self.down:
            self.down = True
            self.down_since = st.down_since
            for h in self.inflight:
                if h.done_ns > st.down_since:
                    h.failed = True
        if st.mult != self._applied_mult:
            self.ep.media = (self._base_media if st.mult == 1.0 else
                             self._base_media.scaled(latency=st.mult))
            self._applied_mult = st.mult
        return st

    def _service_faulted(self, kind: int, addr: int, nbytes: int,
                         start: float,
                         st: Optional[PortFaultState]):
        """Fault-aware service: walk the op, retrying with exponential
        backoff on transient failures. Returns ``(done_ns, retries,
        failed)`` — ``failed`` set once the bounded retry budget
        (:data:`MAX_OP_RETRIES`) is exhausted; the clock cost of the
        failed attempts and their backoff is still charged (no free
        failures, no livelock)."""
        if st is None:
            return self._service(kind, addr, nbytes, start), 0, False
        t = start
        retries = 0
        while True:
            self._attempts += 1
            done = self._service(kind, addr, nbytes, t)
            if not self.faults.op_fails(self.port_id, self._attempts,
                                        st.p_err):
                return done, retries, False
            retries += 1
            self.fault_retries += 1
            if retries > MAX_OP_RETRIES:
                self.fault_failures += 1
                return done, retries, True
            backoff = RETRY_BACKOFF_NS * (2.0 ** (retries - 1))
            self.fault_backoff_ns += backoff
            t = done + backoff

    def read(self, addr: int, nbytes: int) -> float:
        """Demand-read a page span; returns the stall (ns) until it lands.

        Under a :class:`FaultSchedule` the op may retry (transient
        window) — ``last_op_retries`` / ``last_op_failed`` annotate the
        outcome; on a hot-removed port it fails instantly at zero cost.
        """
        start = max(self.now, self.busy_until)
        st = self._fault_state(start)
        if self.down:
            self.last_op_retries, self.last_op_failed = 0, True
            return 0.0
        t, retries, failed = self._service_faulted(PAGE_READ, addr, nbytes,
                                                   start, st)
        lat = t - self.now
        self.now = t
        self.busy_until = t
        self.last_op_retries, self.last_op_failed = retries, failed
        self._retire_completed()
        return lat

    def write(self, addr: int, nbytes: int) -> float:
        """Write a page span; returns the time (ns) the writer is held.

        Fault semantics match :meth:`read` (retry under transient
        windows, instant zero-cost failure on a downed port)."""
        start = max(self.now, self.busy_until)
        st = self._fault_state(start)
        if self.down:
            self.last_op_retries, self.last_op_failed = 0, True
            return 0.0
        t, retries, failed = self._service_faulted(PAGE_WRITE, addr, nbytes,
                                                   start, st)
        lat = t - self.now
        self.now = t
        self.busy_until = t
        self.last_op_retries, self.last_op_failed = retries, failed
        self._retire_completed()
        return lat

    def issue(self, kind: int, addr: int, nbytes: int) -> OpHandle:
        """Issue a page op without blocking on its completion.

        ``kind`` is PAGE_READ_ASYNC / PAGE_WRITE_ASYNC (the blocking
        kinds are accepted and mapped). The op's requests are scheduled
        back-to-back on the port's service cursor starting at
        ``max(now, busy_until)``; the caller's clock advances only when
        the per-port in-flight cap is exhausted — then the issue stalls
        until the oldest outstanding op frees a slot, and that stall is
        the handle's ``wait_ns`` (the only latency charged at issue).
        """
        issued = self.now
        self._retire_completed()
        wait = 0.0
        if len(self.inflight) >= self.max_inflight:
            # stall until enough outstanding ops complete to free a slot
            free_at = sorted(h.done_ns for h in self.inflight)[
                len(self.inflight) - self.max_inflight]
            wait = max(0.0, free_at - self.now)
            self.now += wait
            self._retire_completed()
        start = max(self.now, self.busy_until)
        st = self._fault_state(start)
        if self.down:
            # downed port: the op completes immediately as a failure and
            # never occupies a service slot (nothing left to service it)
            return OpHandle(kind=kind, addr=addr, nbytes=nbytes, port=0,
                            issued_ns=issued, start_ns=start,
                            done_ns=self.now, wait_ns=wait, failed=True)
        base = PAGE_READ if kind in (PAGE_READ, PAGE_READ_ASYNC) \
            else PAGE_WRITE
        done, retries, failed = self._service_faulted(base, addr, nbytes,
                                                      start, st)
        self.busy_until = done
        handle = OpHandle(kind=kind, addr=addr, nbytes=nbytes, port=0,
                          issued_ns=issued, start_ns=start, done_ns=done,
                          wait_ns=wait, retries=retries, failed=failed)
        self.inflight.append(handle)
        return handle

    def poll(self, handle: OpHandle) -> bool:
        """True once the stream clock has reached the op's completion.

        Pure observation: retiring a completed handle early never changes
        later timing (the in-flight set is a function of ``now`` alone).
        """
        self._retire_completed()
        return self.now >= handle.done_ns

    def inflight_depth(self) -> int:
        """Number of async ops still outstanding at the current clock."""
        self._retire_completed()
        return len(self.inflight)

    def prefetch(self, addr: int, nbytes: int) -> float:
        """Issue the MemSpecRd stream for a span; free on the demand path."""
        if self.down or self.ctl.sr_mode == "off" or self.ep.is_dram:
            return 0.0
        if self.ctl.qos.sr_halted:
            self.prefetch_halted += 1
            return 0.0
        self.prefetch_pages += 1
        self.ep.prefetch(self.now, addr, nbytes)
        return 0.0

    def advance(self, dt_ns: float) -> float:
        """Idle time between engine ticks: background flush windows open,
        announced internal tasks (GC) get their quiet window, and the
        periodic DevLoad sample keeps the QoS ladder live — without it a
        closed flush window could never reopen (no stores -> no response
        flits -> no telemetry), deadlocking the divert discipline."""
        self.now += dt_ns
        self._retire_completed()
        self._fault_state(self.now)
        if self.down:
            return 0.0
        self.ctl.qos.update(self.ep.devload(self.now))
        self.ctl.background_flush(self.now)
        return 0.0

    def op(self, kind: int, addr: int, nbytes: int) -> float:
        """Dispatch one recorded page op (the replay entry point).

        Async kinds replay as fresh issues — the returned latency is the
        in-flight-cap stall charged at issue, exactly what the online
        accounting recorded; the op's media work lands on the service
        cursor as it did live."""
        if kind in PAGE_FAULT_KINDS:
            # fault-annotated records carry the fault path's timing —
            # retries, backoff, or a downed port's zero-cost failure —
            # which only the recording run's schedule can reproduce
            if self.faults is None:
                raise ValueError(
                    f"fault-annotated page-op kind {kind} cannot replay "
                    "without the recording run's FaultSchedule; pass "
                    "faults= to replay_page_trace / PageStream")
            kind = _FAULT_BASE_KIND[kind]
        if kind == PAGE_READ:
            return self.read(addr, nbytes)
        if kind == PAGE_WRITE:
            return self.write(addr, nbytes)
        if kind == PAGE_PREFETCH:
            return self.prefetch(addr, nbytes)
        if kind == PAGE_ADVANCE:
            return self.advance(float(nbytes))
        if kind in (PAGE_READ_ASYNC, PAGE_WRITE_ASYNC):
            return self.issue(kind, addr, nbytes).wait_ns
        raise ValueError(f"unknown page-op kind {kind}")


class Topology:
    """N root ports, each fronting its own endpoint, with per-port clocks.

    The paper's headline system design: "multiple CXL root ports for
    integrating diverse storage media (DRAMs and/or SSDs)". Each port is
    one :class:`PageStream` (root port + EP + QoS state) with its *own*
    simulated clock (``ports[p].now``, ns), so page ops issued on
    different ports overlap in simulated time — the cross-port **issue**
    half. :meth:`sync` is the **drain** half: a barrier that realigns
    every port clock to the topology-wide maximum, called at engine-tick
    boundaries (:meth:`advance`) and wherever the caller needs blocking
    completions settled. Non-blocking ops (:meth:`issue`/:meth:`poll`)
    additionally overlap *within* a port: their media work rides the
    port's service cursor past the barrier and retires only when
    simulated time reaches the handle's completion timestamp.

    With one port this degenerates exactly to the single blocking
    ``PageStream`` (``sync`` is a no-op), which is what keeps the 1-port
    topology bit-identical to the pre-topology serving tier.

    Args:
        medias: per-port media specs (names, bins already resolved, or
            scaled variants like ``"znand@2"``); one EP per entry.
        sr/ds/req_bytes/dram_cache_bytes: per-port ``PageStream`` knobs
            (shared by every port).
    """

    def __init__(self, medias, *, sr: bool = True, ds: bool = True,
                 req_bytes: int = 256, dram_cache_bytes: int = 8 << 20,
                 max_inflight: int = MAX_INFLIGHT_OPS,
                 faults: Optional[FaultSchedule] = None):
        if not medias:
            raise ValueError("a Topology needs at least one port")
        self.faults = faults
        self.ports = [PageStream(m, sr=sr, ds=ds, req_bytes=req_bytes,
                                 dram_cache_bytes=dram_cache_bytes,
                                 max_inflight=max_inflight,
                                 faults=faults, port_id=i)
                      for i, m in enumerate(medias)]

    @property
    def n_ports(self) -> int:
        """Number of root ports (== EPs) in the topology."""
        return len(self.ports)

    @property
    def now(self) -> float:
        """Topology-wide simulated time (ns): the furthest port clock."""
        return max(p.now for p in self.ports)

    def sync(self) -> float:
        """Drain barrier: realign every port clock to the max; returns it.

        This is where completions from overlapped per-port ops are
        settled — after ``sync`` all ports agree on "now" (ns).
        """
        t = max(p.now for p in self.ports)
        for p in self.ports:
            p.now = t
        return t

    def advance(self, dt_ns: float) -> float:
        """Tick boundary: drain all ports, then pass ``dt_ns`` of idle
        time to each (QoS DevLoad samples + background flush windows, as
        ``PageStream.advance``). Returns 0.0 (free on the demand path)."""
        self.sync()
        for p in self.ports:
            p.advance(dt_ns)
        return 0.0

    def ports_down(self):
        """Ports whose endpoints are hot-removed so far (sorted list)."""
        return sorted(i for i, p in enumerate(self.ports) if p.down)

    def issue(self, port: int, kind: int, addr: int,
              nbytes: int) -> OpHandle:
        """Issue a non-blocking op on ``port``; returns its handle with
        ``handle.port`` stamped so :meth:`poll` can route back."""
        handle = self.ports[port].issue(kind, addr, nbytes)
        handle.port = port
        return handle

    def poll(self, handle: OpHandle) -> bool:
        """True once the handle's port clock reached its completion."""
        return self.ports[handle.port].poll(handle)

    def inflight_depth(self, port: Optional[int] = None) -> int:
        """Outstanding async ops on ``port`` (or topology-wide when
        ``port`` is None)."""
        if port is not None:
            return self.ports[port].inflight_depth()
        return sum(p.inflight_depth() for p in self.ports)

    def op(self, port: int, kind: int, addr: int, nbytes: int) -> float:
        """Dispatch one port-tagged page op; returns its latency (ns).

        ``port < 0`` (used for ``PAGE_ADVANCE`` records) broadcasts to the
        whole topology through :meth:`advance`.
        """
        if kind == PAGE_ADVANCE:
            return self.advance(float(nbytes))
        return self.ports[port].op(kind, addr, nbytes)


def replay_page_trace(ops, *, media: str = "znand", sr: bool = True,
                      ds: bool = True, req_bytes: int = 256,
                      dram_cache_bytes: int = 8 << 20,
                      max_inflight: int = MAX_INFLIGHT_OPS,
                      topology=None,
                      faults: Optional[FaultSchedule] = None) -> np.ndarray:
    """Scalar-oracle replay of a recorded page trace.

    ``ops`` is the ``CxlTier.ops`` recording: ``(kind, addr, nbytes)``
    tuples for a single-port tier, or port-tagged
    ``(port, kind, addr, nbytes)`` tuples when ``topology`` (a sequence
    of per-port media specs) is given. Returns the per-op latencies (ns)
    of a fresh :class:`PageStream` / :class:`Topology` walking the same
    trace — the cross-validation oracle for the tier's incremental
    accounting. Async op kinds replay too: the interleaved PAGE_ADVANCE
    records carry the simulated time that let them complete, so a replay
    reproduces issue stalls (``max_inflight`` must match the recording
    tier's cap) and service-cursor queueing exactly. Fault-annotated
    traces (kinds in :data:`PAGE_FAULT_KINDS`) additionally need the
    recording run's ``faults`` schedule — with it the replay reproduces
    every degrade window, transient retry and hot-removal at identical
    simulated instants; without it the replay raises rather than
    silently mis-charging.
    """
    if topology is not None:
        topo = Topology(topology, sr=sr, ds=ds, req_bytes=req_bytes,
                        dram_cache_bytes=dram_cache_bytes,
                        max_inflight=max_inflight, faults=faults)
        return np.asarray([topo.op(p, k, a, n) for p, k, a, n in ops],
                          np.float64)
    stream = PageStream(media, sr=sr, ds=ds, req_bytes=req_bytes,
                        dram_cache_bytes=dram_cache_bytes,
                        max_inflight=max_inflight, faults=faults)
    return np.asarray([stream.op(k, a, n) for k, a, n in ops], np.float64)
