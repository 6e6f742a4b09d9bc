"""Backend media + endpoint models for the CXL-GPU simulator.

Latency/bandwidth constants follow Table 1a's parts (DDR5-5600 via a
DRAMSim3-style closed-page approximation; Optane P5800X; Samsung 983 ZET
Z-NAND; Samsung 980 Pro TLC NAND) at the 64B-4KB request sizes the
controller issues. NAND-family media carry a garbage-collection model
(periodic block reclaim that stalls the media — the paper's tail-latency
source); PRAM (Optane) models fine-grained wear-leveling as a smaller,
more frequent stall.

The endpoint (EP) couples a media model with the internal DRAM cache that
SSD-based expanders are expected to ship (paper §CXL with an SSD
integration). Fidelity points that matter for reproducing Fig. 9:

 * the cache tracks a per-block **ready time** — a read arriving while its
   block is still in flight merges with the fill (MSHR semantics) and
   waits out the remainder; it does not refetch. This is what makes the
   naive SR variant (64B MemSpecRd per request) a ~2x win, not a wash:
   the fetch starts at *issue* time instead of head-of-queue time.
 * SSD media have **channel parallelism** (multi-die): independent fetches
   overlap across channels; a single sequential demand stream without SR
   mostly serializes on one fetch at a time (the next miss is issued only
   after the GPU advances), while SR keeps all channels busy.
 * internal tasks (GC / wear-leveling) stall the whole device and are
   pre-announced via DevLoad (the paper's fine control for writes).
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Optional, Union

import numpy as np

from repro_torch.core.qos import DevLoad

NS = 1.0
US = 1000.0


@dataclasses.dataclass(frozen=True)
class MediaModel:
    """One backend media part (Table 1a): service latencies in ns, per-
    channel bandwidth in GB/s (== bytes/ns), and the internal-task (GC /
    wear-leveling) cadence. ``gc_every_bytes == 0`` marks DRAM-class
    media with no internal tasks."""

    name: str
    read_ns: float            # base access latency, one internal granule
    write_ns: float
    bw_gbps: float            # per-channel transfer bandwidth (GB/s)
    channels: int = 1
    gc_every_bytes: int = 0   # 0 = no internal tasks
    gc_ns: float = 0.0        # stall per internal task

    def xfer_ns(self, nbytes: int) -> float:
        """Transfer time (ns) of ``nbytes`` on one channel."""
        return nbytes / self.bw_gbps  # GB/s == bytes/ns

    def scaled(self, latency: float = 1.0, bw: float = 1.0) -> "MediaModel":
        """Derived part with scaled service latencies / bandwidth — the
        sweep's media-latency-distribution axis (e.g. a 2x-slower Z-NAND
        bin, or a next-gen part at 0.5x)."""
        return dataclasses.replace(
            self, name=f"{self.name}@{latency:g}x",
            read_ns=self.read_ns * latency, write_ns=self.write_ns * latency,
            gc_ns=self.gc_ns * latency, bw_gbps=self.bw_gbps * bw)


# Table 1a media. DRAM numbers approximate DDR5-5600 closed-page access;
# SSD numbers are small-read/-write service times of the named parts.
DRAM = MediaModel("DRAM", read_ns=55.0, write_ns=55.0, bw_gbps=44.8,
                  channels=16)
# gc_every_bytes is calibrated to the simulated trace length (tens of
# thousands of requests, vs billions on real hardware) so each run sees
# several internal-task windows, as the paper's Fig. 9e does.
OPTANE = MediaModel("Optane", read_ns=1_600.0, write_ns=2_600.0,
                    bw_gbps=3.2, channels=8,
                    gc_every_bytes=256 << 10, gc_ns=60 * US)
ZNAND = MediaModel("Z-NAND", read_ns=9_000.0, write_ns=14_000.0,
                   bw_gbps=1.6, channels=8,
                   gc_every_bytes=128 << 10, gc_ns=500 * US)
NAND = MediaModel("NAND", read_ns=45_000.0, write_ns=90_000.0,
                  bw_gbps=0.8, channels=8,
                  gc_every_bytes=64 << 10, gc_ns=2_000 * US)

MEDIA = {"dram": DRAM, "optane": OPTANE, "znand": ZNAND, "nand": NAND}


def resolve_media(spec: Union[str, MediaModel]) -> MediaModel:
    """Resolve a media spec: a MediaModel, a name ("znand"), or a scaled
    variant "name@<latency-mult>" (e.g. "znand@2" = tail-bin Z-NAND with
    2x service latency)."""
    if isinstance(spec, MediaModel):
        return spec
    if "@" in spec:
        name, mult = spec.split("@", 1)
        return MEDIA[name].scaled(latency=float(mult))
    return MEDIA[spec]


def channel_timeline(arrivals: np.ndarray, channels: np.ndarray,
                     n_channels: int, service_ns: float) -> np.ndarray:
    """Vectorized FIFO service over parallel channels (constant service).

    For each channel the completion recurrence is
    ``done_i = max(a_i, done_{i-1}) + L``, whose closed form is
    ``done_i = (i+1)*L + cummax(a_j - j*L)`` — one cumulative-maximum pass
    per channel instead of a per-request Python loop. This is the
    miss-address-array form of ``Endpoint._media_fetch`` for media without
    internal tasks (DRAM expanders), used by the vectorized engine.
    """
    done = np.empty_like(arrivals)
    for c in range(n_channels):
        idx = np.nonzero(channels == c)[0]
        if idx.size == 0:
            continue
        a = arrivals[idx]
        i = np.arange(idx.size)
        done[idx] = (i + 1) * service_ns \
            + np.maximum.accumulate(a - i * service_ns)
    return done


class Endpoint:
    """A CXL EP: backend media + internal DRAM cache + ingress queue."""

    BLOCK = 256

    def __init__(self, media: MediaModel, dram_cache_bytes: int = 64 << 20,
                 ingress_depth: int = 64):
        self.media = media
        # DRAM-class = no internal tasks: scaled variants ("dram@2") stay
        # DRAM-class so the latency multiplier is charged on every access
        # instead of being silently dropped on internal-cache hits (the
        # cache path bills hits at the *unscaled* internal-DRAM speed).
        # repro_torch.sim.vector mirrors this classification — keep in lockstep.
        self.is_dram = media.gc_every_bytes == 0
        self.cache_capacity = max(dram_cache_bytes // self.BLOCK, 1)
        self.cache: "OrderedDict[int, float]" = OrderedDict()  # ready time
        self.ingress_depth = ingress_depth
        self.chan_busy = [0.0] * media.channels
        # demand-fetch MSHRs: the EP's transaction tracker admits few
        # concurrent demand fills; the SR prefetch engine streams straight
        # to the media channels. This asymmetry is what lets MemSpecRd run
        # ahead of the demand stream (paper Fig. 6).
        self.demand_mshr = [0.0] * 1
        self.demand_pressure = 0.0     # EWMA of demand-fetch queue wait
        self._pressure_t = 0.0
        self._write_accum = 0          # write-back coalescing buffer
        self.inflight = 0
        self.written_since_gc = 0
        self.gc_until = 0.0
        self._gc_start = 0.0
        self.last_write_t = 0.0
        self.stats = {"reads": 0, "writes": 0, "hits": 0, "prefetches": 0,
                      "gc_events": 0, "evictions": 0, "media_fetches": 0}

    # ------------------------------------------------------------- cache
    def _lookup(self, block: int) -> Optional[float]:
        if block in self.cache:
            self.cache.move_to_end(block)
            return self.cache[block]
        return None

    def _fill(self, block: int, ready: float) -> None:
        if block in self.cache:
            self.cache.move_to_end(block)
            self.cache[block] = min(self.cache[block], ready)
            return
        if len(self.cache) >= self.cache_capacity:
            self.cache.popitem(last=False)
            self.stats["evictions"] += 1
        self.cache[block] = ready

    # --------------------------------------------------------------- media
    def _channel(self, addr: int) -> int:
        return (addr // self.BLOCK) % self.media.channels

    def _media_fetch(self, now: float, addr: int, nbytes: int,
                     write: bool = False) -> float:
        """Issue one media op on the owning channel; returns completion."""
        self.stats["media_fetches"] += 1
        c = self._channel(addr)
        base = self.media.write_ns if write else self.media.read_ns
        start = max(now, self.chan_busy[c], self.gc_until)
        done = start + base + self.media.xfer_ns(nbytes)
        self.chan_busy[c] = done
        return done

    # ----------------------------------------------------------------- gc
    def _maybe_gc(self, now: float) -> None:
        if self.media.gc_every_bytes and \
                self.written_since_gc >= self.media.gc_every_bytes:
            self.written_since_gc = 0
            self.stats["gc_events"] += 1
            start = max(now, max(self.chan_busy))
            self._gc_start = start
            self.gc_until = start + self.media.gc_ns

    def gc_pending(self) -> bool:
        """The media pre-announces an imminent internal task via DevLoad."""
        return bool(self.media.gc_every_bytes) and \
            self.written_since_gc >= 0.97 * self.media.gc_every_bytes

    # ------------------------------------------------------------ requests
    def read(self, now: float, addr: int, nbytes: int = 64) -> float:
        """Returns completion time of a demand read arriving at ``now``."""
        self.stats["reads"] += 1
        if self.is_dram:
            return self._media_fetch(now, addr, nbytes)
        block = addr // self.BLOCK
        ready = self._lookup(block)
        if ready is not None:
            # hit (or merge with an in-flight fill)
            if ready <= now:
                self.stats["hits"] += 1
            return max(now, ready) + DRAM.read_ns + DRAM.xfer_ns(nbytes)
        # single-slot demand MSHR: the heap degenerates to one scalar
        slot = self.demand_mshr[0]
        start = max(now, slot)
        done = self._media_fetch(start, addr, self.BLOCK)
        self.demand_mshr[0] = done
        self._fill(block, done)
        wait = (start - now) / (self.media.read_ns + 1.0)
        self._decay_pressure(now)
        self.demand_pressure = 0.75 * self.demand_pressure + 0.25 * wait
        return done + DRAM.read_ns

    def _decay_pressure(self, now: float) -> None:
        """Pressure relaxes over ~10 service times so a halted SR engine
        can observe recovery (the paper resumes SR when DevLoad returns
        to light load)."""
        dt = max(0.0, now - self._pressure_t)
        self._pressure_t = now
        tau = 10.0 * (self.media.read_ns + 1.0)
        self.demand_pressure *= math.exp(-dt / tau)

    def prefetch(self, now: float, addr: int, nbytes: int) -> float:
        """SR fill: media -> internal DRAM, off the critical path. Blocks
        already cached or in flight are skipped (the ring-buffer dedup
        upstream catches most of these; this is the EP-side guard)."""
        if self.is_dram:
            return now
        first = addr // self.BLOCK
        last = (addr + max(nbytes, 1) - 1) // self.BLOCK
        missing = [b for b in range(first, last + 1)
                   if self._lookup(b) is None]
        if not missing:
            return now
        self.stats["prefetches"] += 1
        # one media op per contiguous missing span (aggregated fetch)
        span_start = missing[0]
        prev = missing[0]
        spans = []
        for b in missing[1:]:
            if b != prev + 1:
                spans.append((span_start, prev))
                span_start = b
            prev = b
        spans.append((span_start, prev))
        done = now
        for s0, s1 in spans:
            n = (s1 - s0 + 1) * self.BLOCK
            d = self._media_fetch(now, s0 * self.BLOCK, n)
            for b in range(s0, s1 + 1):
                self._fill(b, d)
            done = max(done, d)
        return done

    def write(self, now: float, addr: int, nbytes: int = 64) -> float:
        """SSD EPs absorb writes in internal DRAM (write-back) and flush
        to media asynchronously; the request completes at DRAM speed
        unless the ingress/write backlog is saturated or an internal task
        (GC) holds the device — the paper's Fig. 8/9e behaviour."""
        self.stats["writes"] += 1
        if self.is_dram:
            return self._media_fetch(now, addr, nbytes, write=True)
        self.last_write_t = now
        self.written_since_gc += nbytes
        if now < self.gc_until:
            # writes landing mid-reclaim thrash the task: the paper's
            # "accumulated write requests flood back ... triggering the
            # next GC" feedback. DS's divert avoids exactly this. Capped
            # at 3x the base task so a storm cannot become unbounded.
            self.gc_until = min(self.gc_until + self.media.write_ns,
                                self._gc_start + 3 * self.media.gc_ns)
        self._maybe_gc(now)
        self._fill(addr // self.BLOCK, now)            # write-back cache
        # coalesced flush: internal DRAM merges small writes into 4 KiB
        # media programs (one program per accumulated 4 KiB)
        self._write_accum += nbytes
        flush_done = now
        if self._write_accum >= 4096:
            self._write_accum -= 4096
            flush_done = self._media_fetch(now, addr, 4096, write=True)
        backlog = max(0.0, sum(self.chan_busy) / len(self.chan_busy) - now)
        if now < self.gc_until or \
                backlog > self.ingress_depth * self.media.write_ns / 8:
            return max(flush_done, self.gc_until)      # back-pressure
        return max(now, self.gc_until) + DRAM.write_ns

    # ------------------------------------------------------------ devload
    def devload(self, now: float) -> DevLoad:
        """QoS telemetry: DEMAND-read pressure + pending internal tasks.

        Channels busy with prefetch are the SR mechanism working as
        intended, not congestion — the device reports overload only when
        demand fetches queue up (ingress pressure) or an internal task is
        running/imminent (the write-side fine control)."""
        # an announced internal task runs once the write stream pauses
        # (DS's divert gives the device exactly that window — Fig. 8)
        if self.gc_pending() and not self.is_dram and \
                now - self.last_write_t > 8 * self.media.write_ns:
            self.written_since_gc = 0
            self.stats["gc_events"] += 1
            self._gc_start = now
            self.gc_until = now + self.media.gc_ns
        if now < self.gc_until or (self.gc_pending() and not self.is_dram):
            return DevLoad.SEVERE
        self._decay_pressure(now)
        p = self.demand_pressure
        if p > 3.0:
            return DevLoad.SEVERE
        if p > 1.0:
            return DevLoad.MODERATE
        if p > 0.25:
            return DevLoad.OPTIMAL
        return DevLoad.LIGHT

    def hit_rate(self) -> float:
        """Fraction of demand reads served ready from internal DRAM."""
        r = self.stats["reads"]
        return self.stats["hits"] / r if r else 0.0
