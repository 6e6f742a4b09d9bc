"""Request-lifecycle scheduler: preemptive admission over the serving slots.

The serving engine used to admit greedily (FIFO into the first free
slot) and charge every cold-tier restore as a synchronous stall at admit
time. This module rebuilds admission as an explicit state machine over
:class:`~repro_torch.serving.engine.Request`:

::

            submit                    admission
    QUEUED ─────────► (scheduler) ──┬──────────────────► RUNNING
                                    │ staging hit / blocking restore /
                                    │ prefill — slot active immediately
                                    │
                                    │ async cold-tier fetch issued
                                    └─► RESTORING ──completion──► RUNNING
    RUNNING ──preempt, swap policy──────► SWAPPED ───► QUEUED (requeued)
    RUNNING ──preempt, recompute policy─► PREEMPTED ─► QUEUED (requeued)
    RUNNING ──max tokens / position bound───────────────────────► RETIRED
    RESTORING ──fetch failed (transient budget / port hot-removed)─┐
                                          RECOVERING ─► QUEUED ◄───┘

Fault recovery (RECOVERING): a restore or swap-in whose tier fetch
failed — the transient-retry budget ran out, or the entry's port was
hot-removed mid-flight — re-queues the request instead of activating
garbage. If the tier copy survived (transient exhaustion) the next
admission simply retries the fetch; if the pages were lost the engine's
lost-key sweep has already dropped the host-store copy or downgraded
the swap payload to a recompute marker, so the retry falls through to a
fresh prefill / the ``preempt_policy="recompute"`` resume path. After
``RECOVERY_PREFILL_AFTER`` failed attempts the scheduler force-drops
the surviving copy too (no livelock on a permanently flaky port).

Two mechanisms hide the expansion tier's media latency behind decode:

 * **asynchronous restore** (``async_restore=True``): a cold-tier prefix
   fetch is issued through ``CxlTier.read_entry_async`` and the slot sits
   in RESTORING while *the rest of the batch keeps decoding*; the slot
   activates on the tick the completion lands. Only in-flight-cap issue
   stalls (plus any tick where every occupied slot was RESTORING) are
   exposed — the rest of the fetch overlaps decode, which is exactly the
   paper's speculative-read/deterministic-store claim lifted to request
   granularity.
 * **preemption** (``preempt_policy``): under slot pressure — queued work
   with strictly higher priority than the lowest-priority running slot
   and no free capacity — the victim's pages swap *out* to the CXL tier
   (``"swap"``: KV pages charged as an async flush, token progress kept)
   or are dropped (``"recompute"``: only the token stream is kept and the
   prompt + generated prefix is re-prefilled on resume). The freed slot
   admits the queued request instead of idling behind a long decode.

All scheduling state lives here; the engine keeps owning the cache, the
slots and the jitted hot path. ``preempt_policy="none"`` with
``async_restore=False`` reproduces the pre-scheduler engine exactly
(same admission order, same charges, same tokens).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict

from repro_torch.core.tier import CxlTier

# Request.state values (plain strings so Request stays a simple dataclass)
QUEUED = "QUEUED"
RESTORING = "RESTORING"
RUNNING = "RUNNING"
PREEMPTED = "PREEMPTED"
SWAPPED = "SWAPPED"
RETIRED = "RETIRED"
RECOVERING = "RECOVERING"

PREEMPT_POLICIES = ("none", "swap", "recompute")
ADMIT_MODES = ("continuous", "closed")

# After this many failed fetch attempts for one request, drop its
# surviving tier/store copy and force a fresh prefill — bounds the
# retry loop on a permanently flaky port (no livelock).
RECOVERY_PREFILL_AFTER = 3


@dataclasses.dataclass
class _InflightRestore:
    """One slot's outstanding async fetch (prefix restore or swap-in)."""

    req: object
    slot: int
    entry: dict
    handle: object                # repro_torch.core.tier.TierHandle
    mode: str                     # "restore" | "swap"
    key: object = None            # tier/store key (recovery bookkeeping)


class RequestScheduler:
    """Preemptive request-lifecycle scheduler over one ``ServingEngine``.

    Owns the QUEUED/RESTORING/SWAPPED bookkeeping and the per-tick
    scheduling pass (:meth:`begin_tick`); delegates cache surgery and
    tier charging to the engine's helpers. ``stats`` accumulates the
    scheduler telemetry the engine surfaces (preemptions, swap bytes,
    in-flight restore time, exposed stall).
    """

    def __init__(self, engine, *, async_restore: bool = False,
                 preempt_policy: str = "none",
                 admit_mode: str = "continuous"):
        if preempt_policy not in PREEMPT_POLICIES:
            raise ValueError(f"unknown preempt_policy {preempt_policy!r} "
                             f"(expected one of {PREEMPT_POLICIES})")
        if admit_mode not in ADMIT_MODES:
            raise ValueError(f"unknown admit_mode {admit_mode!r} "
                             f"(expected one of {ADMIT_MODES})")
        self.engine = engine
        self.async_restore = bool(async_restore)
        self.preempt_policy = preempt_policy
        self.admit_mode = admit_mode
        self.inflight: Dict[int, _InflightRestore] = {}   # slot -> fetch
        self.swapped: Dict[int, dict] = {}                # rid -> payload
        self.stats = {"preemptions": 0, "swap_out_bytes": 0,
                      "swap_in_bytes": 0, "restore_inflight_ns": 0.0,
                      "restore_exposed_ns": 0.0, "inflight_peak": 0,
                      "activations": 0, "blocked_ticks": 0,
                      "recoveries": 0}

    # ------------------------------------------------------------- tick
    def busy(self) -> bool:
        """True while any slot's async fetch is still outstanding."""
        return bool(self.inflight)

    def drain(self) -> None:
        """Poll outstanding async fetches and activate any that landed —
        the engine's horizon drain calls this between simulated-time
        advances so RESTORING slots settle without a full decode tick."""
        self._activate_completed()

    def begin_tick(self) -> None:
        """One scheduling pass: activate landed fetches, preempt under
        pressure, then admit queued work into free slots."""
        self._activate_completed()
        self._maybe_preempt()
        self._admit()

    def note_blocked_tick(self, dt_ns: float) -> None:
        """Account one tick where the whole batch idled on in-flight
        restores (no RUNNING slot): that tick's simulated time is exposed
        stall, not hidden latency."""
        self.stats["blocked_ticks"] += 1
        self.stats["restore_exposed_ns"] += dt_ns
        self.engine.stats["restore_stall_ns"] += dt_ns

    # ------------------------------------------------------- transitions
    def _activate_completed(self) -> None:
        eng = self.engine
        for slot in sorted(self.inflight):
            rec = self.inflight[slot]
            if not eng.tier.poll(rec.handle):
                continue
            del self.inflight[slot]
            if getattr(rec.handle, "failed", False):
                self._recover_inflight(rec)
                continue
            if rec.mode == "swap":
                eng.slots[slot] = rec.req
                eng._apply_swap_in(rec.req, slot, rec.entry)
                if eng.tier is not None:     # swap pages are back in GPU
                    eng.tier.free_entry(("swap", rec.req.rid))
            else:
                eng.slots[slot] = rec.req
                eng._apply_restore(rec.req, slot, rec.entry)
            rec.req.state = RUNNING
            self.stats["activations"] += 1

    # ---------------------------------------------------- fault recovery
    def _recover_inflight(self, rec: _InflightRestore) -> None:
        """An async fetch failed (retry budget exhausted or its port
        hot-removed): re-queue the request in RECOVERING state instead
        of activating a slot from pages that never arrived."""
        eng = self.engine
        req = rec.req
        if rec.mode == "swap":
            # put the payload back for the retry — unless the tier copy
            # died with its port (or keeps failing), in which case only
            # the token stream survives and resume goes through the
            # recompute path.
            if (eng.tier.has_entry(("swap", req.rid))
                    and req.recoveries + 1 < RECOVERY_PREFILL_AFTER):
                self.swapped[req.rid] = rec.entry
            else:
                eng.tier.free_entry(("swap", req.rid))
                self.swapped[req.rid] = {"recompute": True}
        elif rec.key is not None and (
                not eng.tier.has_entry(rec.key)
                or req.recoveries + 1 >= RECOVERY_PREFILL_AFTER):
            # pages lost, or this key keeps failing: drop the host-store
            # copy so the next admission prefills from scratch.
            eng.store.drop(rec.key)
        self._requeue_recovering(req)

    def _requeue_recovering(self, req) -> None:
        """Common tail of every recovery path: count it, mark the
        request RECOVERING and push it back on the admission queue."""
        req.slot = None
        req.recoveries += 1
        req.state = RECOVERING
        self.engine.queue.append(req)
        self.stats["recoveries"] += 1

    def _pop_next(self):
        """Highest-priority queued request, FIFO-stable on ties (so the
        default all-zero-priority queue is exactly the old FIFO)."""
        q = self.engine.queue
        best = 0
        for j in range(1, len(q)):
            if q[j].priority > q[best].priority:
                best = j
        return q.pop(best)

    def _admit(self) -> None:
        eng = self.engine
        if self.admit_mode == "closed" and (
                any(s is not None for s in eng.slots) or self.inflight):
            # wave batching: the next wave is admitted only once every
            # slot has drained — the closed-loop baseline the open-loop
            # load harness compares continuous admit-on-retire against
            return
        for slot in range(eng.n_slots):
            if eng.slots[slot] is not None or slot in self.inflight \
                    or not eng.queue:
                continue
            req = self._pop_next()
            req.slot = slot
            t0 = time.perf_counter()
            self._place(req, slot)
            eng.stats["prefill_time_s"] += time.perf_counter() - t0

    def _place(self, req, slot: int) -> None:
        """Route one admitted request: swap-in, prefix restore or prefill."""
        eng = self.engine
        if req.rid in self.swapped:
            self._swap_in(req, slot, self.swapped.pop(req.rid))
            return
        eng.slots[slot] = req
        if not eng.legacy and self._try_restore(req, slot):
            pass          # prefix_hits counted inside (failed fetches
        elif eng.legacy:  # recover into the queue, not into the stat)
            eng._prefill_slot_legacy(req, slot)
            req.state = RUNNING
        else:
            eng._prefill_slot(req, slot)
            req.state = RUNNING

    def _note_inflight_peak(self) -> None:
        if self.engine.tier is not None:
            depth = self.engine.tier.inflight_ops()
            if depth > self.stats["inflight_peak"]:
                self.stats["inflight_peak"] = depth

    def _try_restore(self, req, slot: int) -> bool:
        """Prefix restore — blocking charge, or async issue + RESTORING.

        Staging-index hits stay free and instant in both modes (the
        deterministic store keeps those pages in reserved GPU memory);
        only a cold-tier hit goes through the simulated fetch.
        """
        eng = self.engine
        res = eng._restore_lookup(req)
        if res is None:
            return False
        entry, key, source = res
        if eng.tier is not None and source == "store":
            nbytes = CxlTier.entry_bytes(entry)
            if self.async_restore:
                handle = eng.tier.read_entry_async(key, nbytes)
                req.restore_stall_ns = handle.issue_wait_ns
                eng.stats["restore_stall_ns"] += handle.issue_wait_ns
                self.stats["restore_exposed_ns"] += handle.issue_wait_ns
                self.stats["restore_inflight_ns"] += handle.in_flight_ns
                eng.slots[slot] = None          # reserved, not active
                self.inflight[slot] = _InflightRestore(
                    req, slot, entry, handle, "restore", key)
                req.state = RESTORING
                self._note_inflight_peak()
                eng.stats["prefix_hits"] += 1
                return True
            stall = eng.tier.read_entry(key, nbytes)
            req.restore_stall_ns = stall
            eng.stats["restore_stall_ns"] += stall
            if eng.tier.last_entry_failed:
                eng.slots[slot] = None
                if (not eng.tier.has_entry(key)
                        or req.recoveries + 1 >= RECOVERY_PREFILL_AFTER):
                    eng.store.drop(key)
                self._requeue_recovering(req)
                return True
        eng._apply_restore(req, slot, entry)
        req.state = RUNNING
        eng.stats["prefix_hits"] += 1
        return True

    # -------------------------------------------------------- preemption
    def _maybe_preempt(self) -> None:
        """Swap out the lowest-priority running slot when queued work of
        strictly higher priority has no free capacity to land on."""
        eng = self.engine
        if self.preempt_policy == "none" or not eng.queue:
            return
        if self.preempt_policy == "swap" and not eng._restorable:
            return            # no paged KV to swap for this family
        if any(eng.slots[s] is None and s not in self.inflight
               for s in range(eng.n_slots)):
            return            # free capacity: no pressure
        running = [(eng.slots[s].priority, s) for s in range(eng.n_slots)
                   if eng.slots[s] is not None]
        if not running:
            return
        best_queued = max(r.priority for r in eng.queue)
        vprio, vslot = min(running)
        if best_queued <= vprio:
            return
        self._swap_out(vslot)

    def _swap_out(self, slot: int) -> None:
        eng = self.engine
        req = eng.slots[slot]
        eng._materialize_tokens(req, slot)
        if self.preempt_policy == "swap":
            entry = eng._capture_swap_entry(req, slot)
            nbytes = CxlTier.entry_bytes(entry)
            if eng.tier is not None:
                if self.async_restore:
                    h = eng.tier.write_entry_async(("swap", req.rid), nbytes)
                    eng._async_writes.append(h)
                    eng.stats["tier_write_ns"] += h.issue_wait_ns
                    self._note_inflight_peak()
                else:
                    eng.stats["tier_write_ns"] += eng.tier.write_entry(
                        ("swap", req.rid), nbytes)
            self.stats["swap_out_bytes"] += nbytes
            self.swapped[req.rid] = entry
            req.state = SWAPPED
        else:                 # recompute: keep only the token stream
            self.swapped[req.rid] = {"recompute": True}
            req.state = PREEMPTED
        eng.slots[slot] = None
        req.slot = None
        eng.queue.append(req)
        self.stats["preemptions"] += 1

    def _swap_in(self, req, slot: int, entry: dict) -> None:
        eng = self.engine
        if entry.get("recompute"):
            eng.slots[slot] = req
            eng._recompute_resume(req, slot)
            req.state = RUNNING
            return
        nbytes = CxlTier.entry_bytes(entry)
        self.stats["swap_in_bytes"] += nbytes
        if eng.tier is not None:
            if self.async_restore:
                handle = eng.tier.read_entry_async(("swap", req.rid), nbytes)
                req.restore_stall_ns += handle.issue_wait_ns
                eng.stats["restore_stall_ns"] += handle.issue_wait_ns
                self.stats["restore_exposed_ns"] += handle.issue_wait_ns
                self.stats["restore_inflight_ns"] += handle.in_flight_ns
                self.inflight[slot] = _InflightRestore(
                    req, slot, entry, handle, "swap", ("swap", req.rid))
                req.state = RESTORING
                self._note_inflight_peak()
                return
            stall = eng.tier.read_entry(("swap", req.rid), nbytes)
            req.restore_stall_ns += stall
            eng.stats["restore_stall_ns"] += stall
            if eng.tier.last_entry_failed:
                if eng.tier.has_entry(("swap", req.rid)) and \
                        req.recoveries + 1 < RECOVERY_PREFILL_AFTER:
                    self.swapped[req.rid] = entry   # retry the swap-in
                else:
                    eng.tier.free_entry(("swap", req.rid))
                    self.swapped[req.rid] = {"recompute": True}
                self._requeue_recovering(req)
                return
            eng.tier.free_entry(("swap", req.rid))  # pages back in GPU
        eng.slots[slot] = req
        eng._apply_swap_in(req, slot, entry)
        req.state = RUNNING
