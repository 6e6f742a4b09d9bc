"""Root-port queue logic — the paper's CXL controller, cycle-approximate.

Implements (OPTIMIZATION OF CXL CONTROLLER FOR GPUs):
  * SR queue + memory queue (32 entries each) under the root port;
  * MemSpecRd aggregation: 2 repurposed LSBs encode 1-4 x 256B, so one SR
    covers 256B..1KB (granularity from the DevLoad ladder);
  * ring buffer of issued SRs — a request matching a previously issued SR
    is forwarded as a standard memory read (no duplicate SR);
  * DevLoad-driven load control (ll/ol/mo/so -> grow/hold/shrink/halt) via
    the shared ``repro_torch.core.qos.QoSController`` (the same state machine the
    JAX runtime uses);
  * address-window control (Fig. 7) via ``repro_torch.core.qos.address_window``;
  * deterministic store (Fig. 8): fire-and-forget dual write, stack-
    organized staging in reserved GPU memory with an SRAM-resident index,
    divert-on-congestion, background flush, read-through.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.core.qos import (DevLoad, QoSController, SR_GRANULARITIES,
                            address_window, MEM_REQ_BYTES, SR_OFFSET_UNIT)
from repro_torch.sim.media import Endpoint

CXL_RTT_NS = 80.0          # silicon controller round trip (two-digit ns)
GPU_MEM_NS = 120.0         # local GPU memory access
QUEUE_DEPTH = 32
TXN_SLOTS = 32             # outstanding CXL.mem transactions per root port
#   Demand reads occupy a transaction slot until the response returns, so
#   under a slow EP they QUEUE at the root port. MemSpecRd flits are
#   fire-and-forget and bypass the wait — that head start is precisely the
#   paper's speculative-read lead ("SR requests for requests waiting in
#   the GPU's memory queue").


@dataclasses.dataclass
class SRStats:
    """Speculative-read engine counters (windows issued / deduped /
    halted by QoS, and total MemSpecRd bytes requested)."""

    issued: int = 0
    deduped: int = 0
    halted: int = 0
    bytes: int = 0


class RootPortController:
    """One root port + CXL controller in front of one EP."""

    def __init__(self, ep: Endpoint, *, sr_mode: str = "off",
                 ds_enabled: bool = False,
                 staging_capacity: int = 16384):
        assert sr_mode in ("off", "naive", "dyn", "sr")
        self.ep = ep
        self.sr_mode = sr_mode
        self.ds_enabled = ds_enabled
        self.qos = QoSController()
        self.memory_queue: Deque[int] = deque(maxlen=QUEUE_DEPTH)
        self.sr_queue: Deque[int] = deque(maxlen=QUEUE_DEPTH)
        # ring buffer of issued SR windows (start, end), newest last.
        # _cov is its inverted index: covered unit -> number of live ring
        # windows containing it, so coverage tests are O(1) instead of an
        # O(ring) interval scan (the simulator's hottest path). NAIVE
        # windows are single 64B requests; DYN/SR windows are always
        # SR_OFFSET_UNIT-aligned multiples of it, so the unit size is
        # per-mode and membership stays exactly "any(s <= a0 < e)".
        self.sr_ring: Deque[Tuple[int, int]] = deque(maxlen=64)
        self._cov: Dict[int, int] = {}
        self._cov_shift = 6 if sr_mode == "naive" else 8
        self.sr_stats = SRStats()
        # DS staging: stack + address index (the paper keeps the index in
        # the system bus SRAM as a red-black tree; a dict is our stand-in)
        self.staging: List[int] = []
        self.staging_index: Dict[int, int] = {}
        self.staging_capacity = staging_capacity
        self.txn: List[float] = [0.0] * TXN_SLOTS   # slot-free times (heap)
        self._last_addr: Optional[int] = None
        self._dir_ewma = 0.0        # smoothed access direction (Fig. 7)
        self.ds_stats = {"fire_and_forget": 0, "diverted": 0, "flushed": 0,
                         "read_through": 0, "blocked": 0}

    def _acquire_txn(self, now: float) -> float:
        """Wait for a transaction slot; returns the request's EP arrival."""
        free = heapq.heappop(self.txn)
        return max(now, free) + CXL_RTT_NS / 2

    def _release_txn(self, done: float) -> None:
        heapq.heappush(self.txn, done)

    # ---------------------------------------------------------------- SR
    def _covered(self, addr: int) -> bool:
        # ring windows are unions of whole units (64B in naive mode, 256B
        # otherwise), so unit membership in the inverted index is exactly
        # "any(s <= a0 < e)" over the ring
        return addr >> self._cov_shift in self._cov

    def _ring_append(self, start: int, end: int) -> None:
        ring, cov, sh = self.sr_ring, self._cov, self._cov_shift
        if len(ring) == ring.maxlen:            # evict oldest window
            s0, e0 = ring.popleft()
            for u in range(s0 >> sh, e0 >> sh):
                n = cov[u] - 1
                if n:
                    cov[u] = n
                else:
                    del cov[u]
        ring.append((start, end))
        for u in range(start >> sh, end >> sh):
            cov[u] = cov.get(u, 0) + 1

    def _first_uncovered(self, addr: int, limit: int = 16) -> int:
        a = addr - addr % SR_OFFSET_UNIT
        for _ in range(limit):
            if not self._covered(a):
                return a
            a += SR_OFFSET_UNIT
        return a

    def on_load_issue(self, now: float, addr: int) -> None:
        """Queue-side SR generation at load-issue time.

        CXL-DYN sizes the window by DevLoad but keeps "the starting
        address of the original memory request" (forward, run-ahead from
        the first uncovered offset unit). CXL-SR additionally decides
        "whether to send MemSpecRd requests for addresses before or after
        the current one" from the queue-derived window (Fig. 7) — here
        realized with the recent-request direction as the queue signal."""
        if self.sr_mode == "off" or self.ep.is_dram:
            return
        last = self._last_addr
        self._last_addr = addr
        if self.qos.sr_halted and self.sr_mode in ("dyn", "sr"):
            self.sr_stats.halted += 1
            return
        g = self.qos.granularity
        if self.sr_mode == "naive":
            if self._covered(addr):
                self.sr_stats.deduped += 1
                return
            start = addr - addr % MEM_REQ_BYTES
            end = start + MEM_REQ_BYTES
        elif self.sr_mode == "dyn":
            if self._covered(addr) and self._covered(addr + g // 2):
                self.sr_stats.deduped += 1
                return
            start = self._first_uncovered(addr)
            end = start + g
        else:  # "sr"
            if last is not None and addr != last:
                self._dir_ewma = 0.9 * self._dir_ewma \
                    + 0.1 * (1.0 if addr > last else -1.0)
            d = self._dir_ewma
            if d < -0.3:            # backward run: window ends at addr
                probe = max(addr - g // 2, 0)
                if self._covered(addr) and self._covered(probe):
                    self.sr_stats.deduped += 1
                    return
                start = max(addr - addr % SR_OFFSET_UNIT - g
                            + SR_OFFSET_UNIT, 0)
                end = start + g
            elif d > 0.3:           # forward run: run ahead of coverage
                if self._covered(addr) and self._covered(addr + g // 2):
                    self.sr_stats.deduped += 1
                    return
                start = self._first_uncovered(addr)
                end = start + g
            else:                   # Around: centre the window (Fig. 7)
                lo = max(addr - g // 2, 0)
                if self._covered(lo) and self._covered(addr) and \
                        self._covered(addr + g // 2):
                    self.sr_stats.deduped += 1
                    return
                start = max((addr - g // 2) - (addr - g // 2)
                            % SR_OFFSET_UNIT, 0)
                end = start + g
        self.sr_queue.append(addr)
        self.ep.prefetch(now, start, end - start)
        self._ring_append(start, end)
        self.sr_stats.issued += 1
        self.sr_stats.bytes += end - start
        if self.sr_queue:
            self.sr_queue.popleft()

    # -------------------------------------------------------------- load
    def load(self, now: float, addr: int) -> float:
        """Service a load; returns completion time."""
        if self.ds_enabled and addr in self.staging_index:
            self.ds_stats["read_through"] += 1
            return now + GPU_MEM_NS
        self.memory_queue.append(addr)
        self.on_load_issue(now, addr)           # SR flit leaves immediately
        arrival = self._acquire_txn(now)        # demand read waits for a slot
        done = self.ep.read(arrival, addr) + CXL_RTT_NS / 2
        self._release_txn(done)
        if self.memory_queue:
            self.memory_queue.popleft()
        # profiler: DevLoad telemetry rides the response flit
        self.qos.update(self.ep.devload(done))
        return done

    # ------------------------------------------------------------- store
    def store(self, now: float, addr: int) -> float:
        """Service a store; returns the time the GPU may proceed."""
        if not self.ds_enabled:
            arrival = self._acquire_txn(now)
            done = self.ep.write(arrival, addr) + CXL_RTT_NS / 2
            self._release_txn(done)
            self.qos.update(self.ep.devload(done))
            return done
        # deterministic store: immediate completion into GPU memory
        congested = (not self.qos.flush_enabled) or self.ep.gc_pending() \
            or self.ep.devload(now) >= DevLoad.MODERATE
        if congested:
            if len(self.staging) >= self.staging_capacity:
                # staging exhausted: block like a plain CXL store
                self.ds_stats["blocked"] += 1
                arrival = self._acquire_txn(now)
                done = self.ep.write(arrival, addr) + CXL_RTT_NS / 2
                self._release_txn(done)
                self.qos.update(self.ep.devload(done))
                return done
            self.staging.append(addr)
            self.staging_index[addr] = len(self.staging) - 1
            self.ds_stats["diverted"] += 1
            return now + GPU_MEM_NS
        # dual write: GPU memory completes the request; EP write rides along
        self.ds_stats["fire_and_forget"] += 1
        self.ep.write(now + CXL_RTT_NS / 2, addr)
        self.qos.update(self.ep.devload(now))
        return now + GPU_MEM_NS

    # ------------------------------------------------------------- flush
    def background_flush(self, now: float, max_items: int = 16) -> None:
        """Drain the staging stack while the QoS state allows (Fig. 8 (3))."""
        if not self.ds_enabled or not self.staging:
            return
        if not self.qos.flush_enabled or \
                self.ep.devload(now) >= DevLoad.MODERATE:
            return
        for _ in range(min(max_items, len(self.staging))):
            addr = self.staging.pop()
            self.staging_index.pop(addr, None)
            self.ep.write(now, addr)
            self.ds_stats["flushed"] += 1
