"""Per-rank CXL root-port sets for multi-rank (sharded) serving.

The paper's headline system design — multiple CXL root ports fronting
diverse media — composes with tensor-parallel serving by giving **each
mesh rank its own root-port set**: a :class:`ShardedTier` owns one
:class:`repro_torch.core.tier.CxlTier` (and therefore one
:class:`repro_torch.sim.engine.Topology`) per model-axis rank, plus one
dedicated **peer-link lane** per rank (a DRAM-class
:class:`repro_torch.sim.engine.PageStream`) modeling the inter-rank CXL
fabric hop.

Placement becomes a cross-rank decision:

 * **flush once, not N times** — an entry is written to its *home
   rank* (stable key hash modulo rank count), so a zipf-shared hot
   prefix lands on one rank's DRAM/SSD ports exactly once instead of
   being duplicated across every rank;
 * **peer fetch instead of duplicate cold restores** — when the entry
   is restored, the home rank performs the single media fetch and the
   other ``N - 1`` ranks receive their KV shards over the home rank's
   peer-link lane (charged ``nbytes * (N - 1) / N`` at DRAM-class
   link speed) — strictly cheaper than ``N`` independent SSD
   restores of the same pages;
 * **mirror on first share** — the first cross-rank restore also
   writes a mirror copy to the next rank over, so a later hot-remove
   of the home rank's port recovers from the peer's copy instead of
   losing the entry (see :meth:`ShardedTier.take_lost_keys`);
 * **learned re-homing** (``placement="learned"``) — a shared
   :class:`repro_torch.sim.policy.LearnedPlacement` watches per-rank restore
   demand (callers tag restores with the requesting rank). Hot shared
   entries with more than one live copy serve **multi-source**: every
   holder rank fetches locally and the missing shards split across the
   holders' outbound lanes in parallel (two holders of a 2-rank tier
   move *zero* peer bytes), and on the next flush the entry *re-homes*
   to the rank whose requests restore it most — a restore-frequency-
   weighted override on top of the blake2b hash home, charged as the
   flush write onto the new rank with the stale copies freed
   (``shard_counters["rehomes"]``). Faults stay consistent: the
   override target falls over to the next live rank, dead holders drop
   out of the multi-source set, and mirror bookkeeping is unchanged.

Every rank's page trace stays independently replayable: rank ``r``'s
``CxlTier`` records its own (port-tagged) op trace against its own
topology, and the rank's peer lane records a single-stream trace —
both must replay within 1% of the scalar oracle
(``repro_torch.sim.engine.replay_page_trace``), exactly like the single-rank
tier. The serving engine consumes a ``ShardedTier`` through the same
surface as a ``CxlTier`` (``write_entry`` / ``read_entry`` / async
handles / ``advance`` / ``port_stats`` / ``counters``), so the
scheduler, flusher and fault-recovery paths compose unchanged.

All times are simulated nanoseconds.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.tier import CxlTier, TierConfig, TierHandle, _stable_hash
from repro_torch.sim.engine import (PAGE_ADVANCE, PAGE_READ, PAGE_READ_ASYNC,
                              FaultSchedule, OpHandle, PageStream)
from repro_torch.sim.policy import LearnedPlacement

# media spec for the inter-rank peer-link lane: the hop crosses the CXL
# fabric into the owning rank's memory, so it times like a DRAM-class
# endpoint, not like the backing SSD media the fetch avoids
PEER_LINK_MEDIA = "dram"


class _ShardedTopoView:
    """Read-only topology facade over every rank's ports + peer lanes.

    The serving engine reads ``tier.topo.now`` / ``tier.topo.ports`` /
    ``tier.topo.ports_down()`` for telemetry; this view aggregates the
    per-rank topologies (and the peer-link lanes) behind the same three
    names so the engine's tick loop works unchanged on a sharded tier.
    """

    def __init__(self, tiers: List[CxlTier], peers: List[PageStream]):
        self._tiers = tiers
        self._peers = peers

    @property
    def ports(self) -> List[PageStream]:
        """Every rank's ports (rank-major) followed by the peer lanes."""
        out = [p for t in self._tiers for p in t.topo.ports]
        out.extend(self._peers)
        return out

    @property
    def now(self) -> float:
        """Furthest simulated clock across all ranks and peer lanes."""
        t = max(t.topo.now for t in self._tiers)
        if self._peers:
            t = max(t, max(p.now for p in self._peers))
        return t

    def ports_down(self) -> List[int]:
        """Globally-indexed down ports (rank-major port numbering)."""
        out, base = [], 0
        for t in self._tiers:
            out.extend(base + p for p in t.topo.ports_down())
            base += t.topo.n_ports
        return out


class ShardedTier:
    """N per-rank ``CxlTier`` port sets + peer-link lanes, one facade.

    Implements the ``CxlTier`` surface the serving engine and scheduler
    consume, with entry placement lifted to a cross-rank decision: each
    entry has a *home rank* (stable hash), is flushed once to that
    rank's ports, and is served to the other ranks over the home rank's
    peer-link lane on restore. The first cross-rank restore mirrors the
    entry to the neighboring rank, so losing the home copy (fault
    hot-remove) recovers from the mirror instead of reporting the key
    lost.

    Args:
        n_ranks: model-axis size (>= 2; use a plain ``CxlTier`` for 1).
        config: the per-rank :class:`TierConfig` (every rank gets an
            identical port set; the fault schedule is stripped and
            re-applied to ``fault_rank`` only).
        faults: optional :class:`FaultSchedule` applied to
            ``fault_rank``'s port set (port indices are rank-local).
        fault_rank: which rank's ports the schedule hits (default 0).
        peer_media: media spec for the peer-link lanes.
    """

    def __init__(self, n_ranks: int, config: TierConfig = TierConfig(),
                 *, faults: Optional[FaultSchedule] = None,
                 fault_rank: int = 0, peer_media: str = PEER_LINK_MEDIA):
        if n_ranks < 2:
            raise ValueError(f"ShardedTier needs n_ranks >= 2 (got "
                             f"{n_ranks}); use CxlTier for a single rank")
        if not 0 <= fault_rank < n_ranks:
            raise ValueError(f"fault_rank {fault_rank} out of range for "
                             f"{n_ranks} ranks")
        if faults is None:
            faults = config.faults
        self.n_ranks = int(n_ranks)
        self.fault_rank = int(fault_rank)
        base_cfg = dataclasses.replace(config, faults=None)
        self.ranks: List[CxlTier] = [
            CxlTier(dataclasses.replace(
                base_cfg, faults=faults if r == fault_rank else None))
            for r in range(n_ranks)]
        self.cfg = self.ranks[0].cfg   # replay params (media, sr, ...)
        self.peer_media = peer_media
        # one outbound peer-link lane per rank: rank r's lane carries the
        # KV shards r serves to the other ranks on a cross-rank restore
        self.peer: List[PageStream] = [
            PageStream(peer_media, sr=False, ds=False,
                       req_bytes=config.req_bytes,
                       dram_cache_bytes=config.dram_cache_bytes,
                       max_inflight=config.max_inflight)
            for _ in range(n_ranks)]
        # per-lane single-stream traces (replayable via replay_page_trace
        # with media=peer_media, sr=False, ds=False)
        self.peer_ops: List[List[tuple]] = [[] for _ in range(n_ranks)]
        self.peer_op_ns: List[List[float]] = [[] for _ in range(n_ranks)]
        self._peer_base: List[int] = [0] * n_ranks   # lane bump allocators
        self._peer_addr: List[Dict[object, Tuple[int, int]]] = [
            dict() for _ in range(n_ranks)]
        self._owner: Dict[object, int] = {}        # key -> primary rank
        self._holders: Dict[object, Set[int]] = {}  # key -> ranks w/ copy
        self._peer_pending: Dict[int, Tuple[int, OpHandle]] = {}
        # async multi-source companions: extra holder fetches + their
        # lane transfers riding one handle ("tier"/"link", rank, handle)
        self._companions: Dict[int, List[Tuple[str, int, object]]] = {}
        self.last_entry_failed = False
        self.topo = _ShardedTopoView(self.ranks, self.peer)
        # learned cross-rank homing state (placement="learned" only): the
        # shared policy classifies hot shared entries; per-rank restore
        # weights pick the re-home target (decayed like tier heat)
        self._policy: Optional[LearnedPlacement] = (
            LearnedPlacement(half_life_ns=config.heat_half_life_ns)
            if config.placement == "learned" else None)
        self._rank_weight: Dict[object, List[float]] = {}
        self._rank_weight_t: Dict[object, float] = {}
        self.shard_counters = {"peer_fetches": 0, "peer_fetch_ns": 0.0,
                               "peer_bytes": 0, "mirror_writes": 0,
                               "rank_remaps": 0, "peer_recoveries": 0,
                               "rehomes": 0, "multi_source_reads": 0}

    # ------------------------------------------------------------ helpers
    @staticmethod
    def entry_bytes(entry) -> int:
        """Payload bytes of a page-store entry (delegates to CxlTier)."""
        return CxlTier.entry_bytes(entry)

    def home_rank(self, key) -> int:
        """Stable home rank for ``key`` (cross-run-deterministic hash)."""
        return _stable_hash(key) % self.n_ranks

    def _resolve_owner(self, key) -> Optional[int]:
        """Rank currently serving ``key`` (remaps off dead copies).

        The recorded owner wins while its copy is live; when a
        hot-remove tears it, ownership migrates to any surviving holder
        (counted as a ``rank_remaps``) — the peer's mirror copy is what
        keeps the entry alive. Returns None when no rank holds it.
        """
        owner = self._owner.get(key)
        if owner is not None and self.ranks[owner].has_entry(key):
            return owner
        held = self._holders.get(key)
        candidates = sorted(held) if held is not None \
            else range(self.n_ranks)
        for r in candidates:
            if r != owner and self.ranks[r].has_entry(key):
                if owner is not None:
                    self.shard_counters["rank_remaps"] += 1
                self._owner[key] = r
                self._holders.setdefault(key, set()).add(r)
                return r
        return None

    def _live_rank(self, start: int) -> int:
        """First rank at/after ``start`` whose port set can still place.

        A rank whose whole topology was hot-removed has no serviceable
        media; placement falls over to the next live rank (rank-striped
        fallback). With every rank dead, returns ``start`` and lets the
        rank tier raise its own no-media error.
        """
        for step in range(self.n_ranks):
            cand = (start + step) % self.n_ranks
            t = self.ranks[cand]
            if len(t._down_ports) < t.topo.n_ports:
                return cand
        return start

    def _peer_span(self, rank: int, key, pbytes: int) -> Tuple[int, int]:
        """Lane address span for ``pbytes`` of ``key`` on ``rank``'s lane.

        Each lane has its own page-aligned bump allocator so repeated
        restores of the same hot entry re-cover the same lane range
        (warm link-side buffering), mirroring the per-port allocators of
        the rank tiers.
        """
        pbytes = max(int(pbytes), 1)
        cached = self._peer_addr[rank].get(key)
        if cached is not None and cached[1] == pbytes:
            return cached
        pg = self.cfg.page_bytes
        span = -(-pbytes // pg) * pg
        addr = self._peer_base[rank]
        self._peer_base[rank] += span
        self._peer_addr[rank][key] = (addr, pbytes)
        return addr, pbytes

    def _charge_peer(self, rank: int, kind: int, addr: int,
                     nbytes: int, ns: float) -> None:
        """Record one op on ``rank``'s peer-lane single-stream trace."""
        if len(self.peer_ops[rank]) < self.cfg.trace_cap:
            self.peer_ops[rank].append((kind, addr, nbytes))
            self.peer_op_ns[rank].append(float(ns))

    def _mirror(self, key, nbytes: int, owner: int) -> None:
        """Write the peer mirror copy (first cross-rank share only).

        The target is the nearest rank after the owner that still has a
        live port; ranks whose whole port set was hot-removed are
        skipped (no serviceable media to mirror onto).
        """
        holders = self._holders.setdefault(key, {owner})
        if len(holders) > 1:
            return
        for step in range(1, self.n_ranks):
            mirror = (owner + step) % self.n_ranks
            t = self.ranks[mirror]
            if len(t._down_ports) < t.topo.n_ports:
                t.write_entry(key, nbytes)
                holders.add(mirror)
                self.shard_counters["mirror_writes"] += 1
                return

    def _collective_pbytes(self, nbytes: int) -> int:
        """Link bytes for a collective restore: the non-owner ranks'
        shards, ``nbytes * (N - 1) / N``."""
        return max((int(nbytes) * (self.n_ranks - 1)) // self.n_ranks, 1)

    # ------------------------------------------------- learned re-homing
    def _note_rank_restore(self, key, nbytes: int,
                           req_rank: Optional[int]) -> None:
        """Feed one restore into the learned homing state.

        ``req_rank`` is the rank whose request drove the restore; the
        per-rank weights it accumulates (decayed by the tier's heat
        half-life) pick the re-home target. Restores with no requesting
        rank still train the hot/cold mixture."""
        now = self.topo.now
        self._policy.observe(key, now, int(nbytes))
        if req_rank is None:
            return
        if not 0 <= int(req_rank) < self.n_ranks:
            raise ValueError(f"req_rank {req_rank} out of range for "
                             f"{self.n_ranks} ranks")
        w = self._rank_weight.get(key)
        if w is None:
            w = self._rank_weight[key] = [0.0] * self.n_ranks
        hl = self.cfg.heat_half_life_ns
        if hl > 0.0:
            dt = max(0.0, now - self._rank_weight_t.get(key, now))
            decay = 0.5 ** (dt / hl)
            for r in range(self.n_ranks):
                w[r] *= decay
        w[int(req_rank)] += 1.0
        self._rank_weight_t[key] = now

    def _preferred_home(self, key) -> Optional[int]:
        """Restore-frequency-weighted home override for a hot entry.

        Returns the live rank whose requests restore ``key`` most, or
        None when the policy is off, the entry is not classified hot,
        or no per-rank demand has been observed — callers then keep the
        hash home / current owner."""
        if self._policy is None:
            return None
        w = self._rank_weight.get(key)
        if w is None or not any(w):
            return None
        if not self._policy.is_hot(key, self.topo.now):
            return None
        best = max(range(self.n_ranks), key=lambda r: w[r])
        return self._live_rank(best)

    def _live_holders(self, key, owner: int) -> List[int]:
        """Ranks currently holding a live copy of ``key`` (sorted)."""
        held = self._holders.get(key, {owner})
        return sorted(r for r in held if self.ranks[r].has_entry(key))

    # ---------------------------------------------------- blocking ops
    def write_entry(self, key, nbytes: int) -> float:
        """Flush an entry once, to its owning rank's port set.

        A re-flush keeps the same owner (stable segments, warm EP
        caches) and invalidates any stale mirror copies — the next
        cross-rank restore re-mirrors fresh pages. Returns the
        writer-held ns (the owning rank's slowest lane).
        """
        owner = self._resolve_owner(key)
        if owner is None:
            owner = self._live_rank(self.home_rank(key))
        pref = self._preferred_home(key)
        if pref is not None and pref != owner:
            # learned re-home: migrate the entry to the rank whose
            # requests restore it most; the flush below IS the charged
            # migration write, and the holder sweep frees stale copies
            owner = pref
            self.shard_counters["rehomes"] += 1
        for r in sorted(self._holders.get(key, ())):
            if r != owner:
                self.ranks[r].free_entry(key)
        ns = self.ranks[owner].write_entry(key, nbytes)
        self.last_entry_failed = self.ranks[owner].last_entry_failed
        self._owner[key] = owner
        self._holders[key] = {owner}
        return ns

    def read_entry(self, key, nbytes: int,
                   req_rank: Optional[int] = None) -> float:
        """Cross-rank demand restore: one media fetch + one link hop.

        The owning rank performs the only real media fetch; the other
        ``N - 1`` ranks' KV shards cross the owner's peer-link lane
        (``nbytes * (N - 1) / N`` at link speed), serialized after the
        media fetch — the returned stall is the sum. First share also
        mirrors the entry to the neighbor rank.

        ``req_rank`` tags the requesting rank for the learned homing
        policy (ignored otherwise); under ``placement="learned"`` a hot
        entry with multiple live copies is served multi-source instead
        (every holder fetches locally, missing shards split across the
        holders' lanes — see :meth:`_read_multi_source`).
        """
        owner = self._resolve_owner(key)
        if owner is None:
            # cold read of an unplaced key: CxlTier semantics (allocate
            # on the home rank and fetch) so read-before-write patterns
            # behave like the single-rank tier
            owner = self._live_rank(self.home_rank(key))
            self._owner[key] = owner
            self._holders.setdefault(key, set()).add(owner)
        if self._policy is not None:
            self._note_rank_restore(key, nbytes, req_rank)
            holders = self._live_holders(key, owner)
            if len(holders) > 1 and self._policy.is_hot(key, self.topo.now):
                return self._read_multi_source(key, nbytes, holders)
        ns = self.ranks[owner].read_entry(key, nbytes)
        failed = self.ranks[owner].last_entry_failed
        if failed:
            # transient/hot-remove on the owner: recover from a peer copy
            retry = self._resolve_owner(key)
            if retry is not None and retry != owner:
                ns = self.ranks[retry].read_entry(key, nbytes)
                failed = self.ranks[retry].last_entry_failed
                owner = retry
                if not failed:
                    self.shard_counters["peer_recoveries"] += 1
        self.last_entry_failed = failed
        if failed:
            return ns
        addr, pbytes = self._peer_span(owner, key,
                                       self._collective_pbytes(nbytes))
        link_ns = self.peer[owner].read(addr, pbytes)
        self._charge_peer(owner, PAGE_READ, addr, pbytes, link_ns)
        self.shard_counters["peer_fetches"] += 1
        self.shard_counters["peer_fetch_ns"] += link_ns
        self.shard_counters["peer_bytes"] += pbytes
        self._mirror(key, nbytes, owner)
        return ns + link_ns

    def _read_multi_source(self, key, nbytes: int,
                           holders: List[int]) -> float:
        """Collective restore of a hot entry from every live holder.

        Each holder fetches its local copy in parallel (stall is the
        max, not the sum — the fetches ride different ranks' ports) and
        the ``(N - H) / N`` of the payload held by no requester splits
        evenly across the holders' outbound lanes. With every rank
        holding a copy no peer bytes move at all. No mirror write is
        needed: multi-source only triggers with >= 2 live copies.
        """
        fetch: Dict[int, float] = {}
        ok: List[int] = []
        worst = 0.0
        for r in holders:
            ns = self.ranks[r].read_entry(key, nbytes)
            worst = max(worst, ns)
            if self.ranks[r].last_entry_failed:
                continue
            ok.append(r)
            fetch[r] = ns
        if not ok:
            self.last_entry_failed = True
            return worst
        h = len(ok)
        miss = max((int(nbytes) * (self.n_ranks - h)) // self.n_ranks, 0)
        stall = max(fetch.values())
        if miss > 0:
            share = -(-miss // h)
            left = miss
            for r in ok:
                pb = min(share, left)
                if pb <= 0:
                    break
                left -= pb
                addr, pb = self._peer_span(r, key, pb)
                link_ns = self.peer[r].read(addr, pb)
                self._charge_peer(r, PAGE_READ, addr, pb, link_ns)
                self.shard_counters["peer_fetches"] += 1
                self.shard_counters["peer_fetch_ns"] += link_ns
                self.shard_counters["peer_bytes"] += pb
                stall = max(stall, fetch[r] + link_ns)
        self.shard_counters["multi_source_reads"] += 1
        self.last_entry_failed = False
        return stall

    # ------------------------------------------------------- async ops
    def write_entry_async(self, key, nbytes: int) -> TierHandle:
        """Background flush to the owning rank (handle rank-tagged)."""
        owner = self._resolve_owner(key)
        if owner is None:
            owner = self._live_rank(self.home_rank(key))
        pref = self._preferred_home(key)
        if pref is not None and pref != owner:
            owner = pref
            self.shard_counters["rehomes"] += 1
        for r in sorted(self._holders.get(key, ())):
            if r != owner:
                self.ranks[r].free_entry(key)
        handle = self.ranks[owner].write_entry_async(key, nbytes)
        handle.rank = owner
        self._owner[key] = owner
        self._holders[key] = {owner}
        return handle

    def read_entry_async(self, key, nbytes: int,
                         req_rank: Optional[int] = None) -> TierHandle:
        """Non-blocking cross-rank restore.

        The owning rank's media fetch and the peer-link transfer are
        both issued without blocking; the handle completes only when
        the media lanes *and* the link op have landed (:meth:`poll`).
        The issuer pays only the issue-slot waits. ``req_rank`` and the
        learned multi-source path behave as in :meth:`read_entry`.
        """
        owner = self._resolve_owner(key)
        if owner is None:
            # cold read: CxlTier semantics, skipping dead ranks
            owner = self._live_rank(self.home_rank(key))
            self._owner[key] = owner
            self._holders.setdefault(key, set()).add(owner)
        if self._policy is not None:
            self._note_rank_restore(key, nbytes, req_rank)
            holders = self._live_holders(key, owner)
            if len(holders) > 1 and self._policy.is_hot(key, self.topo.now):
                return self._read_multi_source_async(key, nbytes, holders)
        handle = self.ranks[owner].read_entry_async(key, nbytes)
        handle.rank = owner
        if not handle.failed and self.ranks[owner].has_entry(key):
            addr, pbytes = self._peer_span(owner, key,
                                           self._collective_pbytes(nbytes))
            link = self.peer[owner].issue(PAGE_READ_ASYNC, addr, pbytes)
            self._charge_peer(owner, PAGE_READ_ASYNC, addr, pbytes,
                              link.wait_ns)
            handle.issue_wait_ns += link.wait_ns
            handle.done_ns = max(handle.done_ns, link.done_ns)
            self._peer_pending[id(handle)] = (owner, link)
            self.shard_counters["peer_fetches"] += 1
            self.shard_counters["peer_bytes"] += pbytes
            self._mirror(key, nbytes, owner)
        return handle

    def _read_multi_source_async(self, key, nbytes: int,
                                 holders: List[int]) -> TierHandle:
        """Async collective restore: all holder fetches + link shares
        ride one handle, completed only when every companion lands."""
        handle: Optional[TierHandle] = None
        ok: List[int] = []
        comps: List[Tuple[str, int, object]] = []
        for r in holders:
            h = self.ranks[r].read_entry_async(key, nbytes)
            h.rank = r
            if h.failed:
                if handle is None:
                    handle = h        # placeholder until a holder works
                continue
            if handle is None or handle.failed:
                handle = h
            else:
                handle.issue_wait_ns += h.issue_wait_ns
                handle.done_ns = max(handle.done_ns, h.done_ns)
                comps.append(("tier", r, h))
            ok.append(r)
        if not ok:
            return handle             # every holder refused at issue
        h_live = len(ok)
        miss = max((int(nbytes) * (self.n_ranks - h_live))
                   // self.n_ranks, 0)
        if miss > 0:
            share = -(-miss // h_live)
            left = miss
            for r in ok:
                pb = min(share, left)
                if pb <= 0:
                    break
                left -= pb
                addr, pb = self._peer_span(r, key, pb)
                link = self.peer[r].issue(PAGE_READ_ASYNC, addr, pb)
                self._charge_peer(r, PAGE_READ_ASYNC, addr, pb,
                                  link.wait_ns)
                handle.issue_wait_ns += link.wait_ns
                handle.done_ns = max(handle.done_ns, link.done_ns)
                comps.append(("link", r, link))
                self.shard_counters["peer_fetches"] += 1
                self.shard_counters["peer_bytes"] += pb
        if comps:
            self._companions[id(handle)] = comps
        self.shard_counters["multi_source_reads"] += 1
        return handle

    def poll(self, handle: TierHandle) -> bool:
        """True once the rank op, its peer-link transfer, and any
        multi-source companion fetches/transfers have all landed."""
        rank = getattr(handle, "rank", 0)
        done = self.ranks[rank].poll(handle)
        pend = self._peer_pending.get(id(handle))
        if pend is not None:
            lane_rank, link = pend
            if self.peer[lane_rank].poll(link):
                del self._peer_pending[id(handle)]
            else:
                done = False
                handle.retired = False
        comps = self._companions.get(id(handle))
        if comps is not None:
            remaining = [
                (kind, r, h) for kind, r, h in comps
                if not (self.ranks[r].poll(h) if kind == "tier"
                        else self.peer[r].poll(h))]
            if remaining:
                self._companions[id(handle)] = remaining
                done = False
                handle.retired = False
            else:
                del self._companions[id(handle)]
        return done

    def inflight_ops(self) -> int:
        """Outstanding async page ops across every rank + peer lane."""
        return (sum(t.inflight_ops() for t in self.ranks)
                + sum(p.inflight_depth() for p in self.peer))

    # ----------------------------------------------------- entry state
    def free_entry(self, key) -> int:
        """Release every rank's copy of ``key``; returns freed bytes."""
        freed = 0
        held = self._holders.pop(key, None)
        ranks = sorted(held) if held else range(self.n_ranks)
        for r in ranks:
            freed += self.ranks[r].free_entry(key)
        self._owner.pop(key, None)
        for r in range(self.n_ranks):
            self._peer_addr[r].pop(key, None)
        self._rank_weight.pop(key, None)
        self._rank_weight_t.pop(key, None)
        if self._policy is not None:
            self._policy.forget(key)
        return freed

    def has_entry(self, key) -> bool:
        """True while *any* rank still holds live segments for ``key``."""
        held = self._holders.get(key)
        ranks = held if held else range(self.n_ranks)
        return any(self.ranks[r].has_entry(key) for r in ranks)

    def speculative_read(self, key, nbytes: int) -> None:
        """MemSpecRd the entry's ranges on its owning rank."""
        owner = self._resolve_owner(key)
        if owner is not None:
            self.ranks[owner].speculative_read(key, nbytes)

    # -------------------------------------------------- time + faults
    def advance(self, dt_ns: float) -> None:
        """Tick every rank's topology and every peer lane by ``dt_ns``.

        Peer lanes record their advances as single-stream
        ``PAGE_ADVANCE`` ops so the lane traces replay with the same
        idle windows they saw live.
        """
        for t in self.ranks:
            t.advance(dt_ns)
        for r, lane in enumerate(self.peer):
            lane.advance(float(dt_ns))
            self._charge_peer(r, PAGE_ADVANCE, 0, int(dt_ns), 0.0)

    def poll_faults(self) -> List[object]:
        """Fold fired fault events on every rank (lost keys pooled)."""
        out = []
        for t in self.ranks:
            out.extend(t.poll_faults())
        return out

    def take_lost_keys(self) -> List[object]:
        """Drain rank-lost keys; keys alive on a peer rank recover.

        A key whose home copy was torn by a hot-remove but that has a
        mirror on a surviving rank is *not* reported lost — ownership
        remaps to the survivor (``rank_remaps``) and the serving layer
        never sees the fault. Only keys with no surviving copy anywhere
        propagate to the engine's recovery path.
        """
        lost = []
        for r, t in enumerate(self.ranks):
            for key in t.take_lost_keys():
                held = self._holders.get(key)
                if held is not None:
                    held.discard(r)
                if self._resolve_owner(key) is not None:
                    self.shard_counters["peer_recoveries"] += 1
                    continue
                self._owner.pop(key, None)
                self._holders.pop(key, None)
                self._rank_weight.pop(key, None)
                self._rank_weight_t.pop(key, None)
                if self._policy is not None:
                    self._policy.forget(key)
                lost.append(key)
        return lost

    # ---------------------------------------------------- aggregation
    def admit_store(self) -> bool:
        """Flush admission: conservative AND across every rank's ports."""
        verdicts = [t.admit_store() for t in self.ranks]
        return all(verdicts)

    def sr_hit_rate(self) -> float:
        """Aggregate EP internal-DRAM hit rate over every rank's reads."""
        ports = [p for t in self.ranks for p in t.topo.ports]
        reads = sum(p.ep.stats["reads"] for p in ports)
        hits = sum(p.ep.stats["hits"] for p in ports)
        return hits / reads if reads else 0.0

    def store_occupancy(self) -> float:
        """Worst staging-stack fill fraction across every rank."""
        return max(t.store_occupancy() for t in self.ranks)

    @property
    def counters(self) -> Dict[str, object]:
        """Summed per-rank tier counters + the shard-level counters.

        Built on demand (one small dict per call): every ``CxlTier``
        counter key holds the sum over ranks, and the shard-specific
        keys (``peer_fetches``, ``peer_fetch_ns``, ``peer_bytes``,
        ``mirror_writes``, ``rank_remaps``, ``peer_recoveries``,
        ``rehomes``, ``multi_source_reads``) ride alongside.
        """
        out: Dict[str, object] = {}
        for t in self.ranks:
            for k, v in t.counters.items():
                out[k] = out.get(k, 0) + v
        out.update(self.shard_counters)
        return out

    def port_stats(self) -> List[Dict[str, object]]:
        """Per-port telemetry across ranks, each row ``rank``-tagged.

        Rows keep their rank-local ``port`` index (fault schedules and
        placement are rank-local) and gain a ``rank`` key; peer lanes
        are not listed (they carry no EP/QoS state worth a row).
        """
        rows = []
        for r, t in enumerate(self.ranks):
            for row in t.port_stats():
                row["rank"] = r
                rows.append(row)
        return rows

    def snapshot(self) -> Dict[str, object]:
        """Flat dict of tier state (CxlTier-shaped, rank-aggregated).

        Every key a ``CxlTier.snapshot()`` exposes is present with the
        value summed (counters), maxed (clocks/occupancy) or aggregated
        (rates) over ranks, so the serving CLI's tier stats line and the
        bench artifact schema work unchanged; the shard-specific extras
        (``n_ranks``, the peer-link counters, per-lane trace lengths)
        ride alongside.
        """
        c = self.counters
        ports = self.port_stats()
        per = [t.snapshot() for t in self.ranks]
        snap = {
            "media": per[0]["media"],
            "topology": list(self.cfg.port_medias),
            "placement": self.cfg.placement if self.cfg.tagged else None,
            "sr_enabled": self.cfg.sr_enabled,
            "ds_enabled": self.cfg.ds_enabled,
            "now_ns": self.topo.now,
            "reads": c["reads"], "writes": c["writes"],
            "prefetches": c["prefetches"],
            "read_ns": c["read_ns"], "write_ns": c["write_ns"],
            "deferred_admits": c["deferred_admits"],
            "promotions": c["promotions"], "demotions": c["demotions"],
            "migrate_ns": c["migrate_ns"],
            "frees": c["frees"], "freed_bytes": c["freed_bytes"],
            "segment_reuses": c["reused_segments"],
            "async_reads": c["async_reads"],
            "async_writes": c["async_writes"],
            "issue_wait_ns": c["issue_wait_ns"],
            "inflight_ops": self.inflight_ops(),
            "sr_hit_rate": self.sr_hit_rate(),
            "ep_prefetches": sum(s["ep_prefetches"] for s in per),
            "gc_events": sum(s["gc_events"] for s in per),
            "staging_occupancy": self.store_occupancy(),
            "ds": [s["ds"] for s in per],
            "ports": ports,
            "trace_ops": sum(s["trace_ops"] for s in per),
            "trace_truncated": any(s["trace_truncated"] for s in per),
            "fault_ops": c["fault_ops"],
            "fault_retries": sum(s["fault_retries"] for s in per),
            "fault_failures": sum(s["fault_failures"] for s in per),
            "fault_backoff_ns": sum(s["fault_backoff_ns"] for s in per),
            "lost_entries": c["lost_entries"],
            "lost_bytes": c["lost_bytes"],
            "ports_down": self.topo.ports_down(),
            "noop_frees": c["noop_frees"],
            "dead_segment_frees": c["dead_segment_frees"],
            # shard extras
            "n_ranks": self.n_ranks,
            "peer_fetches": c["peer_fetches"],
            "peer_fetch_ns": c["peer_fetch_ns"],
            "peer_bytes": c["peer_bytes"],
            "mirror_writes": c["mirror_writes"],
            "rank_remaps": c["rank_remaps"],
            "peer_recoveries": c["peer_recoveries"],
            "rehomes": c["rehomes"],
            "multi_source_reads": c["multi_source_reads"],
            "peer_trace_ops": [len(ops) for ops in self.peer_ops],
        }
        return snap
