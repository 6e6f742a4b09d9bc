"""CXL-timed KV memory tier — serving page traffic through the simulator.

Until now the serving engine's host page tier (``HostPageStore`` + the
staging flusher) and the siliconized-controller simulator (``repro_torch.sim``)
lived in separate worlds: the engine moved real KV pages with no latency
model, the simulator timed synthetic traces with no real traffic. This
module bridges them: a :class:`CxlTier` owns a simulated CXL **topology**
— one or more root ports, each fronting its own endpoint (media bin +
internal DRAM cache) — and charges every page movement the serving
engine performs against it:

 * **flush** (retired pages -> cold tier): ``write_entry`` decomposes the
   entry into CXL.mem stores through each port controller's
   deterministic-store path — fire-and-forget at GPU-memory speed,
   diverted to staging under congestion, exactly Fig. 8;
 * **restore** (prefix reuse): ``read_entry`` is the demand fetch the
   restored slot stalls on; ``speculative_read`` is the MemSpecRd stream
   the engine issues at lookup time so the EP's internal DRAM already
   holds the pages when the demand reads arrive (Fig. 6);
 * **admission**: ``admit_store`` gates the engine's QoS flusher on the
   endpoints' announced state (DevLoad ladder + pending internal tasks) —
   the divert-on-congestion discipline applied at page granularity.

**Multi-root-port topology** (the paper's headline system design —
"multiple CXL root ports for integrating diverse storage media"): with
``TierConfig.topology`` set to N media bins, a *placement policy* maps
each entry onto the ports:

 * ``striped`` — pages round-robin across every port, so one entry's
   demand fetch fans out and the restore stalls only for the slowest
   lane (per-port clocks overlap in simulated time; the topology drains
   at engine-tick barriers);
 * ``hashed``  — whole entries pinned to one port by a stable key hash
   (overlap comes from concurrent entries landing on distinct ports);
 * ``hotness`` — restore-frequency-weighted: entries start on the
   capacity (SSD) ports and hot entries promote to the DRAM port, with
   budget-driven demotion of the coldest resident back to the slowest
   port;
 * ``learned`` — same promote/demote mechanics, but the hot/cold verdict
   comes from :class:`repro_torch.sim.policy.LearnedPlacement` — an
   ICGMM-style Gaussian mixture fit over per-entry reuse features
   (reuse distance, recency, restore frequency, entry bytes) instead of
   the fixed ``hot_promote_after`` counter; demotion victims rank by
   posterior hot-probability.

Both heat-driven policies optionally age their state
(``TierConfig.heat_half_life_ns``): restore counts decay with a
half-life, and fast-port residents whose decayed heat has cooled are
demoted even without budget pressure — a once-hot entry cannot pin the
DRAM port forever under churn.

The tier records every op it charges (``ops``/``op_ns``); replaying that
trace through ``repro_torch.sim.engine.replay_page_trace`` from a fresh stream
(or fresh :class:`~repro_torch.sim.engine.Topology` for port-tagged traces)
must reproduce the charged latencies — the differential harness in
``tests/test_tier.py`` / ``tests/test_topology.py``. Addresses come from
per-port append-only page-aligned bump allocators: entry keys map to
stable port segments, so a re-flushed entry overwrites its previous
ranges (warm EP caches) instead of migrating; only the ``hotness``
policy relocates entries, explicitly, charging the migration traffic.

All times are simulated nanoseconds.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

from repro_torch.sim.engine import (MAX_INFLIGHT_OPS, PAGE_ADVANCE, PAGE_PREFETCH,
                              PAGE_READ, PAGE_READ_ASYNC,
                              PAGE_READ_ASYNC_FAULT, PAGE_READ_FAULT,
                              PAGE_WRITE, PAGE_WRITE_ASYNC,
                              PAGE_WRITE_ASYNC_FAULT, PAGE_WRITE_FAULT,
                              FaultSchedule, OpHandle, Topology)
from repro_torch.sim.media import resolve_media
from repro_torch.sim.policy import LearnedPlacement

# Serving media bins -> simulator media parts (Table 1a). "ssd-fast" is the
# Z-NAND part, "ssd-slow" commodity TLC NAND; any resolve_media spec
# ("optane", "znand@2", ...) is also accepted verbatim.
MEDIA_BINS = {"dram": "dram", "ssd-fast": "znand", "ssd-slow": "nand"}

PLACEMENTS = ("striped", "hashed", "hotness", "learned")

# placements whose restores feed heat state and can trigger migration
HEAT_PLACEMENTS = ("hotness", "learned")


def resolve_bin(spec: str) -> str:
    """Map a serving bin name to a simulator media spec.

    Accepts a bin name (``"ssd-fast"``), a raw media spec (``"znand"``),
    or either with a latency multiplier (``"ssd-fast@2"`` -> ``"znand@2"``)
    — the multiplier survives the bin mapping so scaled bins time
    consistently end to end.
    """
    name, sep, mult = spec.partition("@")
    base = MEDIA_BINS.get(name, name)
    return f"{base}@{mult}" if sep else base


def _stable_hash(key) -> int:
    """Deterministic (cross-run) placement hash: blake2b of ``repr(key)``.

    Not the builtin ``hash`` (salted per process — placement would move
    between runs) and not crc32 (badly biased modulo small port counts
    for short keys like small ints).
    """
    return int.from_bytes(
        hashlib.blake2b(repr(key).encode(), digest_size=8).digest(), "big")


@dataclasses.dataclass(frozen=True)
class TierConfig:
    """Configuration for a :class:`CxlTier` (all latencies simulated ns).

    ``media`` names the single-port media bin; setting ``topology`` to a
    tuple of bins instead builds a multi-root-port tier and activates the
    ``placement`` policy. An empty ``topology`` is exactly the
    pre-topology single-port tier (same op trace format, same timing).
    """

    media: str = "ssd-fast"          # single-port bin name or media spec
    sr_enabled: bool = True          # speculative read (MemSpecRd prefetch)
    ds_enabled: bool = True          # deterministic store (divert + flush)
    req_bytes: int = 256             # bytes per CXL.mem request in a page op
    # EP internal DRAM cache. Like media.gc_every_bytes, calibrated to the
    # simulated working set (a serving run flushes tens-hundreds of KB, vs
    # GBs through a real EP): small enough that flushed entries age out
    # before their restore — the regime where SR matters, per the paper.
    dram_cache_bytes: int = 64 << 10
    page_bytes: int = 4 << 10        # allocation + striping granule
    # op-trace bound: the recorded trace exists for differential replay
    # (tests/benches, ~100s of ops); a long-lived serving process charges
    # one advance op per tick, so recording must not grow unboundedly.
    # Past the cap, ops are still charged but no longer recorded.
    trace_cap: int = 200_000
    # per-port cap on outstanding async page ops: an async entry op whose
    # port is saturated stalls at issue until a slot frees (the stall is
    # the only latency charged at issue — see read_entry_async)
    max_inflight: int = MAX_INFLIGHT_OPS
    # ---- multi-root-port topology -------------------------------------
    topology: Tuple[str, ...] = ()   # per-port media bins; () = single-port
    placement: str = "striped"       # striped | hashed | hotness | learned
    hot_promote_after: int = 2       # restores before promotion (hotness)
    hot_budget_bytes: int = 256 << 10   # fast-port residency budget
    # heat aging (hotness + learned): restore counts decay with this
    # half-life (simulated ns) and cooled fast-port residents demote even
    # without budget pressure. 0.0 = no aging (heat is a plain counter).
    heat_half_life_ns: float = 0.0
    # ---- fault injection ----------------------------------------------
    # a repro_torch.sim.engine.FaultSchedule the topology's ports consult:
    # degrade windows scale media service time, transient windows fail op
    # attempts into bounded retry-with-backoff, hot_remove kills a port
    # (every entry with a segment on it is lost — see CxlTier.poll_faults)
    faults: Optional[FaultSchedule] = None

    def __post_init__(self):
        """Validate the placement policy and async cap early."""
        if self.placement not in PLACEMENTS:
            raise ValueError(f"unknown placement {self.placement!r} "
                             f"(expected one of {PLACEMENTS})")
        if self.max_inflight < 1:
            raise ValueError("max_inflight must be >= 1 "
                             f"(got {self.max_inflight})")

    @property
    def media_name(self) -> str:
        """Resolved simulator media spec for the single-port bin."""
        return resolve_bin(self.media)

    @property
    def port_medias(self) -> Tuple[str, ...]:
        """Resolved per-port media specs (one entry per root port)."""
        return tuple(resolve_bin(m) for m in (self.topology or (self.media,)))

    @property
    def tagged(self) -> bool:
        """True when the op trace is port-tagged (multi-port mode)."""
        return bool(self.topology)


@dataclasses.dataclass
class TierHandle:
    """Completion handle for one async entry op (flush or restore fetch).

    ``lanes`` holds one :class:`repro_torch.sim.engine.OpHandle` per port
    segment the entry spans; the op is complete once *every* lane's port
    clock passes its completion (``CxlTier.poll``). ``issue_wait_ns`` is
    the total in-flight-cap stall charged to the issuer (usually 0.0);
    ``in_flight_ns`` the issue-to-slowest-lane-completion span — the
    latency the scheduler gets to hide behind decode.
    """

    key: object
    kind: int                     # PAGE_READ_ASYNC or PAGE_WRITE_ASYNC
    nbytes: int
    lanes: List[OpHandle]
    issued_ns: float
    done_ns: float                # slowest lane's completion timestamp
    issue_wait_ns: float
    retired: bool = False

    @property
    def in_flight_ns(self) -> float:
        """Simulated ns the entry op was outstanding (issue -> done)."""
        return self.done_ns - self.issued_ns

    @property
    def failed(self) -> bool:
        """True if any lane failed — its port was hot-removed or the
        transient-retry budget was exhausted. A failed fetch means the
        entry's pages never landed; the serving layer must recover."""
        return any(lane.failed for lane in self.lanes)


class CxlTier:
    """Per-page latency accounting for the serving engine's tiered pages.

    One instance owns a :class:`repro_torch.sim.engine.Topology` (a single port
    in legacy mode) plus the placement state mapping entry keys onto port
    segments. All returned latencies are simulated nanoseconds.

    Entry ops come in two disciplines: blocking (``read_entry`` /
    ``write_entry`` — the caller stalls for the slowest lane) and async
    (``read_entry_async`` / ``write_entry_async`` — the media work rides
    the port service cursors and the returned :class:`TierHandle` retires
    as :meth:`advance` passes simulated time; only in-flight-cap issue
    stalls are charged to the caller).
    """

    def __init__(self, config: TierConfig = TierConfig()):
        self.cfg = config
        self.topo = Topology(config.port_medias, sr=config.sr_enabled,
                             ds=config.ds_enabled,
                             req_bytes=config.req_bytes,
                             dram_cache_bytes=config.dram_cache_bytes,
                             max_inflight=config.max_inflight,
                             faults=config.faults)
        n = self.topo.n_ports
        # key -> [(port, base, capacity_bytes)] segments, striping order
        self._segments: Dict[object, List[Tuple[int, int, int]]] = {}
        self._base = [0] * n             # per-port bump allocators
        self._live_bytes = [0] * n       # bytes currently mapped per port
        # per-port exact-fit free lists: npages -> LIFO of reusable bases.
        # Only free_entry feeds these (relocations leak their old ranges,
        # as the bump allocator always did) — under open-loop load the
        # page store evicts constantly, and without recycling the bump
        # cursors run away while live_bytes stays flat.
        self._free: List[Dict[int, List[int]]] = [dict() for _ in range(n)]
        self._entry_counter = 0          # rotates the striping start port
        # heat-policy state (hotness + learned)
        self._heat: Dict[object, float] = {}         # (decayed) restores
        self._heat_t: Dict[object, float] = {}       # decay timestamps
        self._fast_resident: Dict[object, int] = {}  # key -> bytes, LRU-ish
        self._policy: Optional[LearnedPlacement] = (
            LearnedPlacement(half_life_ns=config.heat_half_life_ns)
            if config.placement == "learned" else None)
        self._down_ports: set = set()    # hot-removed (detected) ports
        self.lost_keys: List[object] = []  # invalidated, pending takeout
        self.last_entry_failed = False   # latest blocking entry op's fate
        self._port_mults: Tuple[float, ...] = (1.0,) * n
        self._fast_port = 0
        self._slow_port = 0
        self._recompute_hot_ports()
        self.ops: List[tuple] = []       # (kind,addr,nbytes) or port-tagged
        self.op_ns: List[float] = []     # charged latencies (ns)
        self.trace_truncated = False     # ops past trace_cap went unrecorded
        self._port_stat_dicts: Optional[List[Dict[str, object]]] = None
        self.counters = {"reads": 0, "writes": 0, "prefetches": 0,
                         "read_bytes": 0, "write_bytes": 0,
                         "prefetch_bytes": 0,
                         "read_ns": 0.0, "write_ns": 0.0,
                         "async_reads": 0, "async_writes": 0,
                         "async_read_ns": 0.0, "async_write_ns": 0.0,
                         "issue_wait_ns": 0.0,
                         "deferred_admits": 0,
                         "promotions": 0, "demotions": 0,
                         "migrate_ns": 0.0,
                         "frees": 0, "freed_bytes": 0,
                         "reused_segments": 0,
                         "fault_ops": 0,        # fault-annotated page ops
                         "lost_entries": 0,     # entries torn by hot-remove
                         "lost_bytes": 0,
                         "noop_frees": 0,       # double/unknown frees
                         "dead_segment_frees": 0}  # frees on removed ports

    # ------------------------------------------------------------ helpers
    @property
    def stream(self):
        """Port 0's :class:`PageStream` (the whole tier in legacy mode)."""
        return self.topo.ports[0]

    @staticmethod
    def entry_bytes(entry) -> int:
        """Payload bytes of a page-store entry: the summed ``nbytes`` of
        every tensor or array in a tree of dicts, lists and tuples (the
        leaves the reference counts through its pytree walk)."""
        if isinstance(entry, dict):
            return sum(CxlTier.entry_bytes(v) for v in entry.values())
        if isinstance(entry, (list, tuple)):
            return sum(CxlTier.entry_bytes(v) for v in entry)
        return int(getattr(entry, "nbytes", 0))

    def _alive_ports(self) -> List[int]:
        """Ports still serviceable (not hot-removed); raises once the
        whole topology is gone — there is nothing left to place on."""
        alive = [p for p in range(self.topo.n_ports)
                 if p not in self._down_ports]
        if not alive:
            raise RuntimeError("every root port has been hot-removed; "
                               "the tier has no serviceable media left")
        return alive

    def _recompute_hot_ports(self) -> None:
        """Pick the hotness policy's fast/slow ports among *alive* ports,
        weighting each media's read service time by its current degrade
        multiplier — a degraded DRAM port can lose fast status to a
        healthy SSD port, which is what steers placement away from it."""
        alive = [p for p in range(self.topo.n_ports)
                 if p not in self._down_ports]
        if not alive:
            return
        medias = self.cfg.port_medias

        def eff_read_ns(p: int) -> float:
            return (resolve_media(medias[p]).read_ns *
                    self.topo.ports[p].degrade_mult)

        self._fast_port = int(min(alive, key=eff_read_ns))
        self._slow_port = int(max(alive, key=eff_read_ns))

    # --------------------------------------------------------- placement
    def _stripe_order(self, key) -> List[int]:
        """Port visit order for a new entry under the active placement.

        Hot-removed ports never appear: striping, hashing and hotness all
        run over the alive set, so new and re-placed entries re-stripe
        around dead ports automatically.
        """
        alive = self._alive_ports()
        n = len(alive)
        if n == 1:
            return [alive[0]]
        if self.cfg.placement == "hashed":
            return [alive[_stable_hash(key) % n]]
        if self.cfg.placement in HEAT_PLACEMENTS:
            # entries start on the capacity ports; the fast (DRAM) port is
            # reserved for promoted-hot entries (unless it is the only one)
            cands = [p for p in alive if p != self._fast_port] or [alive[0]]
            return [cands[_stable_hash(key) % len(cands)]]
        start = self._entry_counter % n          # striped round-robin
        return [alive[(start + j) % n] for j in range(n)]

    def _allocate(self, key, nbytes: int,
                  ports: Optional[List[int]] = None
                  ) -> List[Tuple[int, int, int]]:
        """Bump-allocate page-aligned segments for ``key`` over ``ports``."""
        pg = self.cfg.page_bytes
        npages = -(-nbytes // pg)
        if ports is None:
            ports = self._stripe_order(key)
            self._entry_counter += 1
        pages = {p: 0 for p in ports}
        for j in range(npages):
            pages[ports[j % len(ports)]] += 1
        segs = []
        for p in ports:
            if not pages[p]:
                continue
            length = pages[p] * pg
            bucket = self._free[p].get(pages[p])
            if bucket:
                # exact-fit recycle of a freed segment: same port, same
                # page count — the EP sees a stable, bounded address space
                # instead of an ever-growing bump cursor
                base = bucket.pop()
                self.counters["reused_segments"] += 1
            else:
                base = self._base[p]
                self._base[p] += length
            segs.append((p, base, length))
            self._live_bytes[p] += length
        old = self._segments.get(key)
        if old is not None:
            for p, _, length in old:
                self._live_bytes[p] -= length
        self._segments[key] = segs
        # fast-port residency bookkeeping must follow the segments: a
        # grown entry relocating off the fast port (stripe order picks a
        # capacity port) is no longer resident there, and leaving it in
        # _fast_resident would make a later demotion charge its reads on
        # the wrong port's address space
        if any(p != self._fast_port for p, _, _ in segs):
            self._fast_resident.pop(key, None)
        return segs

    def _place(self, key, nbytes: int) -> List[Tuple[int, int, int]]:
        """Charged (port, addr, raw_bytes) splits for an entry access.

        Reuses the stored segments when their capacity still covers
        ``nbytes`` (stable ranges — a re-flushed entry overwrites, warm EP
        caches); a grown entry relocates. Raw bytes walk the segments in
        page-granule round-robin so the per-port split is deterministic.
        """
        nbytes = max(int(nbytes), 1)
        segs = self._segments.get(key)
        if segs is None or sum(c for _, _, c in segs) < nbytes:
            segs = self._allocate(key, nbytes)
        pg = self.cfg.page_bytes
        npages = -(-nbytes // pg)
        raw = {i: 0 for i in range(len(segs))}
        cap = {i: c // pg for i, (_, _, c) in enumerate(segs)}
        j = 0
        for page in range(npages):
            size = min(pg, nbytes - page * pg)
            for _ in range(len(segs)):           # next segment with room
                if cap[j % len(segs)]:
                    break
                j += 1
            i = j % len(segs)
            cap[i] -= 1
            raw[i] += size
            j += 1
        return [(p, a, raw[i]) for i, (p, a, _) in enumerate(segs)
                if raw[i]]

    # ----------------------------------------------------------- charging
    def _charge(self, port: int, kind: int, addr: int, nbytes: int) -> float:
        """Execute one op on its port and record it in the trace (ns).

        Blocking reads/writes that crossed the fault path (retried under
        a transient window, or failed on a downed port) are recorded
        under their fault-annotated kind, so the trace is self-describing
        — replaying it demands the run's :class:`FaultSchedule`."""
        lat = self.topo.op(port, kind, addr, nbytes)
        if kind in (PAGE_READ, PAGE_WRITE) and self.cfg.faults is not None:
            ps = self.topo.ports[max(port, 0)]
            self.last_entry_failed = (self.last_entry_failed
                                      or ps.last_op_failed)
            if ps.last_op_retries or ps.last_op_failed:
                kind = (PAGE_READ_FAULT if kind == PAGE_READ
                        else PAGE_WRITE_FAULT)
                self.counters["fault_ops"] += 1
        if len(self.ops) < self.cfg.trace_cap:
            self.ops.append((port, kind, addr, nbytes) if self.cfg.tagged
                            else (kind, addr, nbytes))
            self.op_ns.append(lat)
        else:
            self.trace_truncated = True   # replay would diverge: say so
        return lat

    def _charge_async(self, port: int, kind: int, addr: int,
                      nbytes: int) -> OpHandle:
        """Issue one async op on its port; the recorded latency is the
        issue-slot wait (what the caller actually paid at issue). Ops
        that crossed the fault path record under their fault-annotated
        kind, like :meth:`_charge`."""
        handle = self.topo.issue(port, kind, addr, nbytes)
        rec = kind
        if (handle.retries or handle.failed) and self.cfg.faults is not None:
            rec = (PAGE_READ_ASYNC_FAULT if kind == PAGE_READ_ASYNC
                   else PAGE_WRITE_ASYNC_FAULT)
            self.counters["fault_ops"] += 1
        if len(self.ops) < self.cfg.trace_cap:
            self.ops.append((port, rec, addr, nbytes) if self.cfg.tagged
                            else (rec, addr, nbytes))
            self.op_ns.append(handle.wait_ns)
        else:
            self.trace_truncated = True
        return handle

    def _issue_entry(self, key, nbytes: int, kind: int) -> TierHandle:
        """Issue one async entry op across the entry's port segments."""
        lanes = []
        for port, addr, n in self._place(key, nbytes):
            lanes.append(self._charge_async(port, kind, addr, n))
        handle = TierHandle(
            key=key, kind=kind, nbytes=int(nbytes), lanes=lanes,
            issued_ns=min(h.issued_ns for h in lanes),
            done_ns=max(h.done_ns for h in lanes),
            issue_wait_ns=sum(h.wait_ns for h in lanes))
        self.counters["issue_wait_ns"] += handle.issue_wait_ns
        return handle

    # ----------------------------------------------------------- page ops
    def write_entry(self, key, nbytes: int) -> float:
        """Flush an entry's pages to its port EPs; returns writer-held ns.

        Segments on distinct ports overlap in simulated time, so the hold
        is the *slowest lane's* time, not the sum — this is where flushes
        to distinct ports stop serializing.
        """
        self.last_entry_failed = False
        held = 0.0
        for port, addr, n in self._place(key, nbytes):
            held = max(held, self._charge(port, PAGE_WRITE, addr, n))
        self.counters["writes"] += 1
        self.counters["write_bytes"] += int(nbytes)
        self.counters["write_ns"] += held
        return held

    def read_entry(self, key, nbytes: int) -> float:
        """Demand-fetch an entry's pages; returns the restore stall (ns).

        The stall is the slowest lane's demand-read time (per-port lanes
        overlap; each lane serializes on its own port clock). Under the
        ``hotness`` policy the restore also bumps the entry's heat and may
        trigger promotion/demotion (charged separately, see
        :meth:`_rebalance`).
        """
        self.last_entry_failed = False
        stall = 0.0
        for port, addr, n in self._place(key, nbytes):
            stall = max(stall, self._charge(port, PAGE_READ, addr, n))
        self.counters["reads"] += 1
        self.counters["read_bytes"] += int(nbytes)
        self.counters["read_ns"] += stall
        failed = self.last_entry_failed
        if self._note_restore(key, nbytes):
            self._rebalance(key, nbytes)
        self.last_entry_failed = failed  # migration charges don't mask it
        return stall

    def write_entry_async(self, key, nbytes: int) -> TierHandle:
        """Background flush: issue the entry's page writes without holding
        the writer. Returns a :class:`TierHandle`; the writer is charged
        only the issue-slot wait (``handle.issue_wait_ns``), the media
        work completes on the port cursors as simulated time passes.
        """
        handle = self._issue_entry(key, nbytes, PAGE_WRITE_ASYNC)
        self.counters["async_writes"] += 1
        self.counters["write_bytes"] += int(nbytes)
        self.counters["async_write_ns"] += handle.in_flight_ns
        return handle

    def read_entry_async(self, key, nbytes: int) -> TierHandle:
        """Non-blocking demand fetch: issue the entry's lane reads and
        return the completion handle instead of stalling for them.

        The caller pays only the issue-slot wait; the fetch itself is
        outstanding until every lane's port clock passes its completion
        (:meth:`poll` after :meth:`advance` ticks) — the window a
        scheduler hides behind decode. Hotness heat/rebalancing applies
        exactly as for the blocking read.
        """
        handle = self._issue_entry(key, nbytes, PAGE_READ_ASYNC)
        self.counters["async_reads"] += 1
        self.counters["read_bytes"] += int(nbytes)
        self.counters["async_read_ns"] += handle.in_flight_ns
        if self._note_restore(key, nbytes):
            self._rebalance(key, nbytes)
        return handle

    def poll(self, handle: TierHandle) -> bool:
        """True once every lane of an async entry op has completed."""
        if handle.retired:
            return True
        done = True
        for lane in handle.lanes:
            if not self.topo.poll(lane):
                done = False
        handle.retired = done
        return done

    def inflight_ops(self) -> int:
        """Async page ops still outstanding across the topology."""
        return self.topo.inflight_depth()

    def free_entry(self, key) -> int:
        """Release ``key``'s port segments for reuse; returns freed bytes.

        The address ranges go back to their ports' exact-fit free lists
        (a later same-shape allocation recycles them — see
        :meth:`_allocate`), and the hotness state for the key is dropped.
        Freeing charges nothing: deallocation is metadata, only page
        *movement* costs simulated time. Unknown keys — including a
        second free of the same key, since the first pops its segments —
        are a counted no-op (``counters["noop_frees"]``, returns 0) so
        callers can free unconditionally on eviction without ever
        corrupting the free lists. Segments on a hot-removed port are
        dropped, not recycled (their address space died with the port —
        ``counters["dead_segment_frees"]``), and a base resurfacing in a
        bucket it already sits in raises rather than poisoning the
        allocator.
        """
        segs = self._segments.pop(key, None)
        if segs is None:
            self.counters["noop_frees"] += 1
            return 0
        pg = self.cfg.page_bytes
        freed = 0
        for p, base, length in segs:
            self._live_bytes[p] -= length
            if p in self._down_ports:
                self.counters["dead_segment_frees"] += 1
            else:
                bucket = self._free[p].setdefault(length // pg, [])
                if base in bucket:
                    raise RuntimeError(
                        f"free-list corruption: port {p} base {base:#x} "
                        "already sits in its free bucket")
                bucket.append(base)
            freed += length
        self._heat.pop(key, None)
        self._heat_t.pop(key, None)
        self._fast_resident.pop(key, None)
        if self._policy is not None:
            self._policy.forget(key)
        self.counters["frees"] += 1
        self.counters["freed_bytes"] += freed
        return freed

    def has_entry(self, key) -> bool:
        """True while ``key`` still maps to live segments on this tier.

        The serving layer's recovery path uses this to tell a transient
        fetch failure (entry intact — retry the read) apart from page
        loss (entry invalidated by a hot-remove — the copy is gone and
        the request must fall back to the host store or recompute).
        """
        return key in self._segments

    def speculative_read(self, key, nbytes: int) -> None:
        """MemSpecRd the entry's port ranges ahead of the demand fetch."""
        if not self.cfg.sr_enabled:
            return
        for port, addr, n in self._place(key, nbytes):
            self._charge(port, PAGE_PREFETCH, addr, n)
        self.counters["prefetches"] += 1
        self.counters["prefetch_bytes"] += int(nbytes)

    def advance(self, dt_ns: float) -> None:
        """Idle engine-tick time (ns): the topology drains (barrier) and
        every port sees the idle window — background flush / GC windows
        open, the QoS ladders stay live, and (under a fault schedule)
        newly-fired fault events are folded in via :meth:`poll_faults`."""
        if self.cfg.tagged:
            self._charge(-1, PAGE_ADVANCE, 0, int(dt_ns))
        else:
            self._charge(0, PAGE_ADVANCE, 0, int(dt_ns))
        if self.cfg.faults is not None:
            self.poll_faults()

    # ------------------------------------------------------ fault handling
    def _invalidate_port(self, port: int) -> List[object]:
        """Tear down every entry with a segment on a hot-removed port.

        A torn entry is a lost entry: partial lanes are useless for a
        restore, so the whole mapping goes. Segments on still-alive ports
        recycle through their free lists; the dead port's address space
        (segments, free lists, bump cursor) is abandoned wholesale.
        Returns the lost keys.
        """
        pg = self.cfg.page_bytes
        lost = []
        for key, segs in list(self._segments.items()):
            if not any(p == port for p, _, _ in segs):
                continue
            del self._segments[key]
            nbytes = 0
            for p, base, length in segs:
                self._live_bytes[p] -= length
                nbytes += length
                if p not in self._down_ports:
                    self._free[p].setdefault(length // pg, []).append(base)
            self._heat.pop(key, None)
            self._heat_t.pop(key, None)
            self._fast_resident.pop(key, None)
            if self._policy is not None:
                self._policy.forget(key)
            lost.append(key)
            self.counters["lost_entries"] += 1
            self.counters["lost_bytes"] += nbytes
        self._free[port] = {}
        self._live_bytes[port] = 0
        return lost

    def poll_faults(self) -> List[object]:
        """Fold newly-fired fault events into placement state.

        Newly hot-removed ports invalidate every entry mapped onto them
        (the lost keys are returned and queued on ``lost_keys`` until
        :meth:`take_lost_keys` drains them — the serving layer's recovery
        entry point), and any down/degrade change re-derives the hotness
        policy's fast/slow ports over the alive set. If the fast port
        loses its status to a degrade window, resident hot entries are
        demoted off it (charged migrations) — the DevLoad-visible latency
        spike steers future placement *and* evacuates current residents.
        """
        if self.cfg.faults is None:
            return []
        newly: List[object] = []
        for p in self.topo.ports_down():
            if p not in self._down_ports:
                self._down_ports.add(p)
                newly.extend(self._invalidate_port(p))
        mults = tuple(p.degrade_mult for p in self.topo.ports)
        if newly or mults != self._port_mults:
            self._port_mults = mults
            old_fast = self._fast_port
            self._recompute_hot_ports()
            if (self.cfg.placement in HEAT_PLACEMENTS
                    and self._fast_port != old_fast
                    and old_fast not in self._down_ports):
                self._demote_all_fast(old_fast)
        self.lost_keys.extend(newly)
        return newly

    def take_lost_keys(self) -> List[object]:
        """Drain the pending lost-entry queue (serving recovery hook)."""
        out, self.lost_keys = self.lost_keys, []
        return out

    def _demote_all_fast(self, old_fast: int) -> None:
        """Evacuate heat-policy residents off a demoted (degraded) fast
        port: each is read off its current segments and rewritten onto
        the (healthy) slow port — standard demotion, charged like any
        other migration; the entries re-earn promotion onto the new fast
        port through restore heat."""
        for victim in list(self._fast_resident):
            self._demote(victim)

    # --------------------------------------------- heat state (rebalancing)
    def _now_ns(self) -> float:
        """Topology-wide simulated clock (the slowest port's stream)."""
        return max(p.now for p in self.topo.ports)

    def _decayed_heat(self, key, now_ns: Optional[float] = None) -> float:
        """Restore heat aged by ``heat_half_life_ns`` (0 = plain count)."""
        h = self._heat.get(key, 0.0)
        hl = self.cfg.heat_half_life_ns
        if h <= 0.0 or hl <= 0.0:
            return h
        if now_ns is None:
            now_ns = self._now_ns()
        dt = max(0.0, now_ns - self._heat_t.get(key, 0.0))
        return h * 0.5 ** (dt / hl)

    def _note_restore(self, key, nbytes: int) -> bool:
        """Fold one restore into the heat state; True when the active
        placement rebalances on restores (hotness/learned, multi-port)."""
        if self.topo.n_ports <= 1 \
                or self.cfg.placement not in HEAT_PLACEMENTS:
            return False
        now = self._now_ns()
        self._heat[key] = self._decayed_heat(key, now) + 1.0
        self._heat_t[key] = now
        if self._policy is not None:
            self._policy.observe(key, now, int(nbytes))
        return True

    def _victim_rank(self, key, now_ns: float) -> float:
        """Demotion ranking — coldest first. Learned placement ranks by
        posterior hot-probability, the counter policy by decayed heat."""
        if self._policy is not None and self._policy.fitted:
            return self._policy.score(key, now_ns)
        return self._decayed_heat(key, now_ns)

    def _demote(self, victim) -> None:
        """Migrate one fast-port resident back to the slow port.

        Charges a read off the segments' actual ports (belt and braces
        with the ``_allocate`` bookkeeping: a segment address is only
        meaningful on its own port's bump space) plus a write onto the
        slowest port; the key keeps a valid mapping at all times."""
        vbytes = self._fast_resident.pop(victim)
        for p, addr, cap in self._segments.get(victim, []):
            self.counters["migrate_ns"] += self._charge(
                p, PAGE_READ, addr, min(cap, vbytes))
        moved = self._allocate(victim, vbytes, ports=[self._slow_port])
        for _, addr, cap in moved:
            self.counters["migrate_ns"] += self._charge(
                self._slow_port, PAGE_WRITE, addr, min(cap, vbytes))
        self._heat[victim] = 0.0         # demoted: re-earn promotion
        self.counters["demotions"] += 1

    def _cool_fast_residents(self, now_ns: float, exclude=None) -> None:
        """Aging sweep: demote fast residents whose heat has decayed cold
        — a once-hot entry cannot pin the fast port forever under churn.
        Only runs with ``heat_half_life_ns`` set (otherwise heat never
        cools and the sweep would be a per-restore no-op scan)."""
        if self.cfg.heat_half_life_ns <= 0.0:
            return
        for k in list(self._fast_resident):
            if k == exclude:
                continue
            cold = self._decayed_heat(k, now_ns) < 1.0
            if cold and self._policy is not None:
                cold = not self._policy.is_hot(k, now_ns)
            if cold:
                self._demote(k)

    def _rebalance(self, key, nbytes: int) -> None:
        """Promote a hot entry to the fast port; demote over-budget cold.

        The hot verdict is the active policy's: decayed heat against
        ``hot_promote_after`` (hotness) or the learned GMM's posterior
        (:meth:`repro_torch.sim.policy.LearnedPlacement.is_hot`). Promotion
        charges only the write onto the fast port (the entry's pages
        were just demand-read into GPU memory); each demotion charges a
        read off the fast port plus a write onto the slowest port.
        Segments are swapped atomically after the charges, so every key
        keeps a valid mapping at all times — no entry is ever stranded
        mid-migration. With heat aging enabled, every rebalance also
        sweeps cooled residents off the fast port.
        """
        if self._fast_port == self._slow_port:
            return                       # homogeneous topology: nothing to do
        now = self._now_ns()
        segs = self._segments.get(key, [])
        on_fast = all(p == self._fast_port for p, _, _ in segs)
        if on_fast:
            self._fast_resident[key] = max(self._fast_resident.get(key, 0),
                                           int(nbytes))
            self._cool_fast_residents(now, exclude=key)
            return
        if self._policy is not None:
            hot = self._policy.is_hot(key, now)
        else:
            hot = self._decayed_heat(key, now) >= self.cfg.hot_promote_after
        if not hot:
            self._cool_fast_residents(now, exclude=key)
            return
        new = self._allocate(key, nbytes, ports=[self._fast_port])
        for _, addr, cap in new:
            self.counters["migrate_ns"] += self._charge(
                self._fast_port, PAGE_WRITE, addr, min(cap, int(nbytes)))
        self.counters["promotions"] += 1
        self._fast_resident[key] = int(nbytes)
        budget = self.cfg.hot_budget_bytes
        while sum(self._fast_resident.values()) > budget \
                and len(self._fast_resident) > 1:
            victim = min((k for k in self._fast_resident if k != key),
                         key=lambda k: self._victim_rank(k, now))
            self._demote(victim)
        self._cool_fast_residents(now, exclude=key)

    # ---------------------------------------------------------------- QoS
    def admit_store(self) -> bool:
        """Deterministic-store admission for the engine's QoS flusher.

        Flushes wait while *any* endpoint has announced an imminent
        internal task or closed its flush window via the DevLoad ladder —
        placement may target any port, so admission is the conservative
        AND across the topology. The pages keep absorbing into the
        engine's staging ring (reads stay correct via the staging-index
        path) and drain once every EP recovers.
        """
        ok = all(p.ctl.qos.flush_enabled and not p.ep.gc_pending()
                 for p in self.topo.ports)
        if not ok:
            self.counters["deferred_admits"] += 1
        return ok

    # --------------------------------------------------------------- stats
    def sr_hit_rate(self) -> float:
        """Aggregate EP internal-DRAM hit rate over the topology's reads."""
        reads = sum(p.ep.stats["reads"] for p in self.topo.ports)
        hits = sum(p.ep.stats["hits"] for p in self.topo.ports)
        return hits / reads if reads else 0.0

    def store_occupancy(self) -> float:
        """Worst-port DS staging-stack fill fraction (0..1)."""
        return max(len(p.ctl.staging) / p.ctl.staging_capacity
                   for p in self.topo.ports)

    def port_stats(self) -> List[Dict[str, object]]:
        """Per-port telemetry: occupancy, queue depth, DevLoad, SR hits,
        async in-flight depth.

        Cheap and live: the per-port dicts are allocated once and updated
        in place, so this is safe to call every decode tick (no drain
        barrier, no per-tick allocation churn) — the scheduler and the
        ``launch/serve.py`` stats line read it mid-run.
        """
        if self._port_stat_dicts is None:
            self._port_stat_dicts = [{"port": i,
                                      "media": p.ep.media.name}
                                     for i, p in enumerate(self.topo.ports)]
        for i, p in enumerate(self.topo.ports):
            ep, ctl = p.ep, p.ctl
            reads = ep.stats["reads"]
            d = self._port_stat_dicts[i]
            d["now_ns"] = p.now
            d["live_bytes"] = self._live_bytes[i]
            d["free_bytes"] = self.cfg.page_bytes * sum(
                npg * len(bases) for npg, bases in self._free[i].items())
            d["ep_reads"] = reads
            d["ep_writes"] = ep.stats["writes"]
            d["ep_prefetches"] = ep.stats["prefetches"]
            d["sr_hit_rate"] = ep.stats["hits"] / reads if reads else 0.0
            d["gc_events"] = ep.stats["gc_events"]
            d["staging_occupancy"] = len(ctl.staging) / ctl.staging_capacity
            d["queue_depth"] = len(ctl.memory_queue)
            d["devload"] = int(ctl.qos.last_devload)
            d["inflight"] = p.inflight_depth()
            d["down"] = p.down
            d["degrade_mult"] = p.degrade_mult
            d["fault_retries"] = p.fault_retries
            d["fault_failures"] = p.fault_failures
        return self._port_stat_dicts

    def snapshot(self) -> Dict[str, object]:
        """One flat dict of tier state for stats lines / bench artifacts.

        Cheap and callable mid-run: reads live clocks and counters (via
        the in-place :meth:`port_stats` view) — no drain barrier.
        """
        ports = self.port_stats()
        return {
            "media": "+".join(p["media"] for p in ports)
            if self.cfg.tagged else ports[0]["media"],
            "topology": list(self.cfg.port_medias),
            "placement": self.cfg.placement if self.cfg.tagged else None,
            "sr_enabled": self.cfg.sr_enabled,
            "ds_enabled": self.cfg.ds_enabled,
            "now_ns": self.topo.now,
            "reads": self.counters["reads"],
            "writes": self.counters["writes"],
            "prefetches": self.counters["prefetches"],
            "read_ns": self.counters["read_ns"],
            "write_ns": self.counters["write_ns"],
            "deferred_admits": self.counters["deferred_admits"],
            "promotions": self.counters["promotions"],
            "demotions": self.counters["demotions"],
            "migrate_ns": self.counters["migrate_ns"],
            "frees": self.counters["frees"],
            "freed_bytes": self.counters["freed_bytes"],
            "segment_reuses": self.counters["reused_segments"],
            "async_reads": self.counters["async_reads"],
            "async_writes": self.counters["async_writes"],
            "issue_wait_ns": self.counters["issue_wait_ns"],
            "inflight_ops": self.inflight_ops(),
            "sr_hit_rate": self.sr_hit_rate(),
            "ep_prefetches": sum(p["ep_prefetches"] for p in ports),
            "gc_events": sum(p["gc_events"] for p in ports),
            "staging_occupancy": self.store_occupancy(),
            "ds": dict(self.stream.ctl.ds_stats) if not self.cfg.tagged
            else [dict(p.ctl.ds_stats) for p in self.topo.ports],
            "ports": ports,
            "trace_ops": len(self.ops),
            "trace_truncated": self.trace_truncated,
            "fault_ops": self.counters["fault_ops"],
            "fault_retries": sum(p.fault_retries for p in self.topo.ports),
            "fault_failures": sum(p.fault_failures
                                  for p in self.topo.ports),
            "fault_backoff_ns": sum(p.fault_backoff_ns
                                    for p in self.topo.ports),
            "lost_entries": self.counters["lost_entries"],
            "lost_bytes": self.counters["lost_bytes"],
            "ports_down": sorted(self._down_ports),
            "noop_frees": self.counters["noop_frees"],
            "dead_segment_frees": self.counters["dead_segment_frees"],
        }
