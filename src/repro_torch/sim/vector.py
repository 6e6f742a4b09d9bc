"""Vectorized trace-replay engine.

The scalar engine (``repro_torch.sim.engine``) replays one 64B access per Python
loop iteration; a full Fig. 9 sweep (config x workload x media) is
thousands of such replays and minutes of wall clock. This module replays
the same traces with the work hoisted out of the per-access loop:

 1. **Precomputed LLC + page masks.** LLC hit/miss (and the UVM/GDS page
    LRU) depend only on the address sequence, never on timing — so the
    masks are computed once per trace and shared by every config x media
    scenario in a sweep (``TraceBundle``).

 2. **Cumulative-sum base timeline.** Between stalls the GPU clock
    advances by a fixed per-op increment (COMPUTE_NS / LLC_NS); the whole
    no-stall timeline is one ``cumsum``. Stalls are represented as an
    additive offset stream on top of it.

 3. **Closed-form queue/bank/channel recurrences.** The HBM banks, the
    root-port transaction slots and the EP channels are FIFO servers with
    constant service time, whose completion recurrence
    ``done_i = max(a_i, done_{i-lag}) + L`` has the closed form
    ``done_i = (i+1)L + cummax(a_j - jL)`` — one vectorized cumulative-max
    pass (``repro_torch.sim.media.channel_timeline``). The GPU's MLP /
    store-queue blocking couples back into issue times; that feedback is
    resolved by a (quickly converging) vectorized fixed-point iteration.
    This covers ``gpu-dram``, ``uvm``, ``gds`` and every ``cxl*`` config
    on DRAM-class media.

 4. **Compressed event loop** for ``cxl*`` on SSD media: the controller /
    endpoint state machines (SR windows, QoS ladder, GC feedback) are
    genuinely sequential, but only LLC *misses* (plus the background-flush
    ticks) ever reach them — compute ops and LLC hits are folded into the
    cumsum timeline and never enter Python. Controller semantics are the
    exact scalar ones (the very same ``RootPortController``/``Endpoint``
    objects drive the state), so this path is bit-identical to the scalar
    engine.

If a closed-form fixed point fails to converge (not observed on the
bundled workloads) the scalar engine is used as a fallback, so ``run``
never returns an unverified approximation.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.qos import SR_GRANULARITIES
from repro_torch.sim import engine as se
from repro_torch.sim import workloads as wl
from repro_torch.sim.controller import (CXL_RTT_NS, GPU_MEM_NS,
                                  RootPortController, SRStats, TXN_SLOTS)
from repro_torch.sim.engine import (COMPUTE_NS, FAULT_NS, LLC_LINES, LLC_NS, MLP,
                              PAGE, PCIE_NS_PER_B, STORE_Q, WARMUP_FRAC,
                              RunResult)
from repro_torch.sim.media import DRAM, Endpoint, channel_timeline, resolve_media

_HBM_BANKS = 8
_HBM_SLOT_NS = GPU_MEM_NS / 4          # pipelined bank occupancy
_RTT2 = CXL_RTT_NS / 2

_SR_MODE = {"cxl": "off", "cxl-naive": "naive", "cxl-dyn": "dyn",
            "cxl-sr": "sr", "cxl-ds": "sr"}
CXL_CONFIGS = tuple(_SR_MODE)
ALL_CONFIGS = ("gpu-dram", "uvm", "gds") + CXL_CONFIGS


def _lru_hit_mask(keys: List[int], capacity: int) -> np.ndarray:
    """Exact LRU hit mask for an access sequence (hit -> touch, miss ->
    fill + evict-LRU), identical to engine.LRU's hit/fill pair."""
    out = np.empty(len(keys), dtype=bool)
    d: OrderedDict = OrderedDict()
    move = d.move_to_end
    pop = d.popitem
    for i, k in enumerate(keys):
        if k in d:
            move(k)
            out[i] = True
        else:
            out[i] = False
            if len(d) >= capacity:
                pop(last=False)
            d[k] = True
    return out


class TraceBundle:
    """Per-trace precomputation shared across every scenario of a sweep."""

    def __init__(self, trace: np.ndarray):
        self.trace = trace
        n = len(trace)
        kinds = np.asarray(trace["kind"])
        addrs = np.asarray(trace["addr"], dtype=np.int64)
        self.warm_i = int(n * WARMUP_FRAC)

        # base timeline: per-op increment, stalls excluded
        dt = np.where(kinds == 0, COMPUTE_NS, LLC_NS)
        self.cum = np.concatenate(([0.0], np.cumsum(dt)))

        mem = kinds != 0
        mem_idx = np.nonzero(mem)[0]
        hit = _lru_hit_mask((addrs[mem_idx] // 64).tolist(), LLC_LINES)

        self.miss_op = mem_idx[~hit]               # op index of each miss
        self.miss_addr = addrs[self.miss_op]
        self.miss_kind = kinds[self.miss_op]       # 1 load / 2 store
        self.miss_base = self.cum[self.miss_op]

        # controller background-flush ticks (compute ops at i % 16 == 0);
        # the scalar engine flushes AFTER the op's compute increment
        idx = np.arange(n)
        self.flush_op = idx[(kinds == 0) & (idx % 16 == 0)]
        self.flush_base = self.cum[self.flush_op + 1]

        self._page_masks: Dict[int, np.ndarray] = {}

    def page_hit_mask(self, page_capacity: int) -> np.ndarray:
        """UVM/GDS page-LRU hit mask over the miss sequence."""
        m = self._page_masks.get(page_capacity)
        if m is None:
            m = _lru_hit_mask((self.miss_addr // PAGE).tolist(),
                              page_capacity)
            self._page_masks[page_capacity] = m
        return m


_BUNDLES: Dict[Tuple, TraceBundle] = {}
_BUNDLES_MAX = 64


def bundle_for(workload: str, n_ops: int, working_set: int, seed: int,
               trace: Optional[np.ndarray] = None) -> TraceBundle:
    """Cached TraceBundle for a (workload, n_ops, working_set, seed)
    key; an explicit ``trace`` bypasses the cache (treat as read-only)."""
    if trace is not None:
        return TraceBundle(trace)
    key = (workload, n_ops, working_set, seed)
    b = _BUNDLES.get(key)
    if b is None:
        if len(_BUNDLES) >= _BUNDLES_MAX:
            _BUNDLES.pop(next(iter(_BUNDLES)))
        tr = wl.generate_cached(workload, n_ops, working_set, seed)
        b = _BUNDLES[key] = TraceBundle(tr)
    return b


# ---------------------------------------------------------------------------
# closed-form solver: base timeline + additive stalls + queue fixed point
# ---------------------------------------------------------------------------


def _running_kth_largest(vals: np.ndarray, m: int) -> np.ndarray:
    """out[k] = m-th largest of vals[:k] (-inf while fewer than m seen).

    This is the exact blocking value of a pop-min-when-full queue of
    depth m: the outstanding set after k pushes is provably the m largest
    completions seen so far (each push replaces the popped minimum with a
    value >= it, since a completion can never precede its issue). For the
    common case of non-decreasing completions the m-th largest of the
    prefix is simply the value m back — one vectorized shift; the bounded
    heap pass only runs for genuinely out-of-order completion streams
    (cross-channel contention).
    """
    n = len(vals)
    out = np.full(n, -np.inf)
    if n <= m:
        return out
    d = np.diff(vals)
    if not d.size or d.min() >= 0.0:        # monotone: FIFO == pop-min
        out[m:] = vals[:-m]
        return out
    h: List[float] = []
    push, replace = heapq.heappush, heapq.heapreplace
    for k, v in enumerate(vals.tolist()):
        if len(h) == m:
            out[k] = h[0]
            if v > h[0]:
                replace(h, v)
        else:
            push(h, v)
    return out


class _Solved:
    __slots__ = ("t", "done", "off", "total_off", "t_warm")


def _solve(bundle: TraceBundle, fault_extra: np.ndarray, is_load: np.ndarray,
           mlp: int, store_q: int, dones_fn,
           max_iter: int = 150) -> Optional[_Solved]:
    """Resolve issue times under MLP/store-queue blocking.

    fault_extra[k]: unconditional time added to the GPU clock by event k
    (UVM/GDS blocking faults); dones_fn(t) -> per-event completion times.

    A full queue blocks on B_k (the running depth-th largest completion of
    its kind). Given completion estimates, the sequential offset
    recurrence ``o_{k+1} = max(o_k, B_k - base_k) + F_k`` solves in closed
    form: with c = cumsum(F), ``o_k = c_k + relu(cummax_{j<k}(B_j -
    base_j - c_j))`` — one exclusive cumulative-max pass. The remaining
    coupling (completions depend on issue times) converges by fixed-point
    iteration, each round fully vectorized.
    """
    base = bundle.miss_base
    n = len(base)
    li = np.nonzero(is_load)[0]
    si = np.nonzero(~is_load)[0]
    c = np.concatenate(([0.0], np.cumsum(fault_extra)))   # prefix faults
    t = base + c[:-1]
    done = np.zeros(n)
    off = c[:-1]
    for _ in range(max_iter):
        done = dones_fn(t)
        B = np.full(n, -np.inf)
        if li.size > mlp:
            B[li] = _running_kth_largest(done[li], mlp)
        if si.size > store_q:
            B[si] = _running_kth_largest(done[si], store_q)
        g = B - base - c[:-1]
        p = np.maximum(np.maximum.accumulate(
            np.concatenate(([0.0], g)))[:-1], 0.0)        # exclusive
        off = c[:-1] + p
        t_new = np.maximum(base + off, B)
        if np.max(np.abs(t_new - t), initial=0.0) < 1e-6:
            t = t_new
            break
        t = t_new
    else:
        return None                             # no convergence: fall back
    out = _Solved()
    out.off = off
    p_total = max(float(np.max(B - base - c[:-1], initial=0.0)), 0.0) \
        if n else 0.0
    out.total_off = c[-1] + p_total
    out.t = t
    out.done = dones_fn(t)
    w = np.searchsorted(bundle.miss_op, bundle.warm_i)
    out.t_warm = bundle.cum[bundle.warm_i] + (out.off[w] if w < n
                                              else out.total_off)
    return out


def _finish(bundle: TraceBundle, sol: _Solved, config: str, media_name,
            record_samples: bool, *, ep_hit_rate: float = 0.0,
            sr: Optional[dict] = None, ds: Optional[dict] = None
            ) -> RunResult:
    t_end = bundle.cum[-1] + sol.total_off
    t_final = max(t_end, float(sol.done.max())) if len(sol.done) else t_end
    samples = None
    if record_samples:
        samples = [(float(t), float(d - t), int(k)) for t, d, k in
                   zip(sol.t, sol.done, bundle.miss_kind)]
    return RunResult(
        config=config, workload="", media=getattr(media_name, "name",
                                                  media_name),
        exec_ns=t_final - sol.t_warm,
        n_ops=len(bundle.trace) - bundle.warm_i,
        ep_hit_rate=ep_hit_rate, sr=sr, ds=ds, samples=samples)


# ---------------------------------------------------------------------------
# per-config closed forms
# ---------------------------------------------------------------------------


def _dones_gpu_dram(bundle: TraceBundle):
    """HBM: 8 pipelined banks, FCFS with constant 30ns bank occupancy —
    the lag-8 recurrence start_m = max(t_m, start_{m-8} + 30) decomposes
    into 8 independent running-max chains (residue classes)."""
    n = len(bundle.miss_base)

    def dones(t: np.ndarray) -> np.ndarray:
        start = np.empty(n)
        for r in range(_HBM_BANKS):
            u = t[r::_HBM_BANKS]
            i = np.arange(u.size)
            start[r::_HBM_BANKS] = i * _HBM_SLOT_NS + np.maximum.accumulate(
                u - i * _HBM_SLOT_NS)
        return start + GPU_MEM_NS

    return dones


def _run_uvm_gds(bundle: TraceBundle, config: str, media, gpu_mem: int,
                 mlp: int, store_q: int, record_samples: bool, media_name
                 ) -> Optional[RunResult]:
    pages_cap = max(gpu_mem // PAGE, 1)
    page_hit = bundle.page_hit_mask(pages_cap)
    move = PAGE * PCIE_NS_PER_B
    if config == "gds":
        move += media.read_ns + PAGE / media.bw_gbps
    else:
        move += DRAM.read_ns
    lat = np.where(page_hit, GPU_MEM_NS, FAULT_NS + move)
    fault_extra = np.where(page_hit, 0.0, lat)   # page misses block the GPU
    is_load = bundle.miss_kind == 1

    sol = _solve(bundle, fault_extra, is_load, mlp, store_q,
                 lambda t: t + lat)
    if sol is None:
        return None
    return _finish(bundle, sol, config, media_name, record_samples)


def _run_cxl_dram(bundle: TraceBundle, config: str, media, mlp: int,
                  store_q: int, record_samples: bool, media_name
                  ) -> Optional[RunResult]:
    """All five cxl* configs on a DRAM-class EP: SR never engages
    (``Endpoint.is_dram``), the QoS ladder stays LIGHT, and every media op
    is one constant-service channel access — fully closed-form."""
    ds = config == "cxl-ds"
    n = len(bundle.miss_base)
    is_load = bundle.miss_kind == 1
    service = media.read_ns + media.xfer_ns(64)
    chan = ((bundle.miss_addr // Endpoint.BLOCK) % media.channels).astype(
        np.int64)
    # transaction slots: demand loads always; stores only without DS
    # (DS stores are fire-and-forget dual writes that skip the root port's
    # transaction tracker)
    txn = is_load | (~is_load if not ds else np.zeros(n, bool))
    ti = np.nonzero(txn)[0]
    fault_extra = np.zeros(n)
    comp_prev = [np.zeros(n)]
    converged = [True]

    def dones(t: np.ndarray) -> np.ndarray:
        comp = comp_prev[0]
        for _ in range(40):
            arr = t + _RTT2                     # DS stores ride immediately
            if ti.size > TXN_SLOTS:
                free = _running_kth_largest(comp[ti], TXN_SLOTS)
                arr[ti] = np.maximum(t[ti], free) + _RTT2
            ep_done = channel_timeline(arr, chan, media.channels, service)
            comp_new = ep_done + _RTT2
            if ds:
                comp_new = np.where(is_load, comp_new, t + GPU_MEM_NS)
            if np.max(np.abs(comp_new - comp), initial=0.0) < 1e-9:
                comp_prev[0] = comp_new
                return comp_new
            comp = comp_new
        comp_prev[0] = comp
        converged[0] = False        # unconverged comp must not be trusted
        return comp

    # a saturated EP makes this fixed point converge slowly; bail early to
    # the exact one-pass loop instead of iterating
    sol = _solve(bundle, fault_extra, is_load, mlp, store_q, dones,
                 max_iter=8)
    if sol is None or not converged[0]:
        return None
    n_loads = int(is_load.sum())
    n_stores = n - n_loads
    ds_stats = {"fire_and_forget": n_stores if ds else 0, "diverted": 0,
                "flushed": 0, "read_through": 0, "blocked": 0}
    return _finish(bundle, sol, config, media_name, record_samples,
                   ep_hit_rate=0.0,
                   sr=dataclasses.asdict(SRStats()), ds=ds_stats)


# ---------------------------------------------------------------------------
# slim exact loops. The closed forms above cover the queue/bank/channel
# algebra; what remains sequential is driven by compressed per-miss loops
# with the scalar semantics inlined (locals instead of object dispatch).
# ``_run_cxl_events`` below keeps the object-driven form as the bridge
# oracle between these loops and the scalar engine.
# ---------------------------------------------------------------------------


def _event_arrays(bundle: TraceBundle, with_flush: bool):
    """Merged (op_idx, base_t, etype, addr) event stream in op order.
    etype: 0 background-flush tick, 1 load miss, 2 store miss."""
    if not with_flush:
        return (bundle.miss_op, bundle.miss_base, bundle.miss_kind,
                bundle.miss_addr)
    op_idx = np.concatenate((bundle.miss_op, bundle.flush_op))
    order = np.argsort(op_idx, kind="stable")
    base = np.concatenate((bundle.miss_base, bundle.flush_base))[order]
    etype = np.concatenate((bundle.miss_kind,
                            np.zeros(len(bundle.flush_op), np.uint8)))[order]
    addr = np.concatenate((bundle.miss_addr,
                           np.zeros(len(bundle.flush_op), np.int64)))[order]
    return op_idx[order], base, etype, addr


def _run_cxl_dram_loop(bundle: TraceBundle, config: str, media, mlp: int,
                       store_q: int, record_samples: bool, media_name
                       ) -> RunResult:
    """Exact one-pass loop for cxl* on a DRAM-class EP (fallback when the
    closed form's fixed point is slow to converge, i.e. saturated EPs).

    On a DRAM-class EP the SR engine never engages and the QoS ladder
    pins LIGHT, so the whole controller reduces to the transaction-slot
    heap plus the channel busy array — a handful of operations per miss.
    """
    ds = config == "cxl-ds"
    n_chan = media.channels
    l_read = media.read_ns + media.xfer_ns(64)
    l_write = media.write_ns + media.xfer_ns(64)
    chan_busy = [0.0] * n_chan
    txn = [0.0] * TXN_SLOTS
    heapq.heapify(txn)
    op_l, base, etype, addr_a = _event_arrays(bundle, with_flush=False)
    op_list = op_l.tolist()
    base_l = base.tolist()
    etype_l = etype.tolist()
    chan_l = ((addr_a // Endpoint.BLOCK) % n_chan).tolist()
    push, pop, pushpop = heapq.heappush, heapq.heappop, heapq.heappushpop

    warm_i = bundle.warm_i
    warm_off: Optional[float] = None
    offset = 0.0
    loads_q: List[float] = []
    stores_q: List[float] = []
    samples: List[Tuple[float, float, int]] = []
    n_loads = n_stores = 0

    for j in range(len(op_list)):
        if warm_off is None and op_list[j] >= warm_i:
            warm_off = offset
        t = base_l[j] + offset
        c = chan_l[j]
        if etype_l[j] == 1:
            n_loads += 1
            if len(loads_q) >= mlp:
                d = pop(loads_q)
                if d > t:
                    offset += d - t
                    t = d
            free = txn[0]
            arrival = (t if t > free else free) + _RTT2
            busy = chan_busy[c]
            e = (arrival if arrival > busy else busy) + l_read
            chan_busy[c] = e
            done = e + _RTT2
            pushpop(txn, done)
            push(loads_q, done)
            if record_samples:
                samples.append((t, done - t, 1))
        else:
            n_stores += 1
            if len(stores_q) >= store_q:
                d = pop(stores_q)
                if d > t:
                    offset += d - t
                    t = d
            if ds:              # fire-and-forget dual write
                busy = chan_busy[c]
                arr = t + _RTT2
                chan_busy[c] = (arr if arr > busy else busy) + l_write
                done = t + GPU_MEM_NS
            else:
                free = txn[0]
                arrival = (t if t > free else free) + _RTT2
                busy = chan_busy[c]
                e = (arrival if arrival > busy else busy) + l_write
                chan_busy[c] = e
                done = e + _RTT2
                pushpop(txn, done)
            push(stores_q, done)
            if record_samples:
                samples.append((t, done - t, 2))

    if warm_off is None:
        warm_off = offset
    t_final = bundle.cum[-1] + offset
    for q in (loads_q, stores_q):
        if q:
            t_final = max(t_final, max(q))
    ds_stats = {"fire_and_forget": n_stores if ds else 0, "diverted": 0,
                "flushed": 0, "read_through": 0, "blocked": 0}
    return RunResult(
        config=config, workload="",
        media=getattr(media_name, "name", media_name),
        exec_ns=t_final - (bundle.cum[warm_i] + warm_off),
        n_ops=len(bundle.trace) - warm_i, ep_hit_rate=0.0,
        sr=dataclasses.asdict(SRStats()), ds=ds_stats,
        samples=samples if record_samples else None)


def _run_cxl_ssd(bundle: TraceBundle, config: str, media, gpu_mem: int,
                 mlp: int, store_q: int, record_samples: bool, media_name
                 ) -> RunResult:
    """Compressed exact replay for cxl* on SSD media.

    Only LLC misses (and, with DS, the background-flush ticks) carry
    controller/endpoint state; they are replayed here with the
    ``RootPortController``/``Endpoint``/``QoSController`` semantics
    inlined into one loop over precomputed event arrays — no attribute
    dispatch, no dead bookkeeping (the root-port shadow queues, the
    prefetch-depth knob). ``_run_cxl_events`` keeps the object-driven
    form; the equivalence tests pin all three engines to identical cycle
    totals.
    """
    smode = ("off", "naive", "dyn", "sr").index(_SR_MODE[config])
    ds = config == "cxl-ds"
    # With SR and DS both off, the QoS ladder and the demand-pressure EWMA
    # feed nothing observable — only devload's GC-fire side effect stays
    # live. The loop below skips the dead updates in that case.
    qos_live = smode != 0 or ds

    # ---- endpoint state (media + internal DRAM cache)
    BLOCK = Endpoint.BLOCK
    n_chan = media.channels
    read_ns, write_ns, bw = media.read_ns, media.write_ns, media.bw_gbps
    gc_every, gc_ns = media.gc_every_bytes, media.gc_ns
    gc_thresh = 0.97 * gc_every
    cache: OrderedDict = OrderedDict()
    cache_get, cache_mte = cache.get, cache.move_to_end
    cache_pop = cache.popitem
    cache_cap = max((gpu_mem // 4) // BLOCK, 1)
    chan_busy = [0.0] * n_chan
    mshr = 0.0
    pressure = 0.0
    pressure_t = 0.0
    tau = 10.0 * (read_ns + 1.0)
    write_accum = 0
    written = 0
    gc_until = 0.0
    gc_start = 0.0
    last_write = 0.0
    n_reads = n_writes = n_hits = n_pref = n_gc = n_evict = n_fetch = 0
    DR55 = DRAM.read_ns
    DRX = DRAM.xfer_ns(64)
    DW55 = DRAM.write_ns
    ingress_limit = 64 * write_ns / 8          # ingress_depth = 64
    exp = math.exp

    # ---- controller state
    GRAN = SR_GRANULARITIES
    g_idx = GRAN.index(512)
    sr_halted = False
    flush_enabled = True
    ring: deque = deque()
    cov: Dict[int, int] = {}
    cov_shift = 6 if smode == 1 else 8
    sr_issued = sr_deduped = sr_halt_n = sr_bytes = 0
    last_addr: Optional[int] = None
    dir_ewma = 0.0
    staging: List[int] = []
    staging_index: Dict[int, int] = {}
    staging_cap = 16384
    txn = [0.0] * TXN_SLOTS
    heapq.heapify(txn)
    ds_faf = ds_div = ds_flu = ds_rt = ds_blk = 0

    def media_fetch(now: float, addr: int, nbytes: int,
                    write: bool) -> float:
        nonlocal n_fetch
        n_fetch += 1
        c = (addr // BLOCK) % n_chan
        b = chan_busy[c]
        start = now if now > b else b
        if gc_until > start:
            start = gc_until
        done = start + (write_ns if write else read_ns) + nbytes / bw
        chan_busy[c] = done
        return done

    def devload(now: float) -> int:
        """DevLoad with the endpoint's side effects (announced internal
        tasks fire once the write stream pauses; pressure decays)."""
        nonlocal written, gc_until, gc_start, n_gc, pressure, pressure_t
        if gc_every and written >= gc_thresh:
            if now - last_write > 8 * write_ns:
                written = 0
                n_gc += 1
                gc_start = now
                gc_until = now + gc_ns
            return 3                                     # SEVERE
        if now < gc_until:
            return 3
        if not qos_live:         # pressure feeds nothing observable
            return 0
        dt = now - pressure_t
        pressure_t = now
        if pressure != 0.0:
            pressure *= exp(-(dt if dt > 0.0 else 0.0) / tau)
        p = pressure
        if p > 3.0:
            return 3
        if p > 1.0:
            return 2
        if p > 0.25:
            return 1
        return 0

    def ep_write(now: float, addr: int) -> float:
        nonlocal n_writes, last_write, written, gc_until, gc_start, n_gc, \
            write_accum, n_evict
        n_writes += 1
        last_write = now
        written += 64
        if now < gc_until:       # mid-reclaim write thrashes the task
            g2 = gc_until + write_ns
            g3 = gc_start + 3 * gc_ns
            gc_until = g2 if g2 < g3 else g3
        if gc_every and written >= gc_every:
            written = 0
            n_gc += 1
            mx = max(chan_busy)
            s = now if now > mx else mx
            gc_start = s
            gc_until = s + gc_ns
        block = addr // BLOCK
        if block in cache:       # write-back fill: keep earliest ready
            cache_mte(block)
            old = cache[block]
            if now < old:
                cache[block] = now
        else:
            if len(cache) >= cache_cap:
                cache_pop(last=False)
                n_evict += 1
            cache[block] = now
        write_accum += 64
        flush_done = now
        if write_accum >= 4096:  # coalesced 4 KiB media program
            write_accum -= 4096
            flush_done = media_fetch(now, addr, 4096, True)
        backlog = sum(chan_busy) / n_chan - now
        if now < gc_until or backlog > ingress_limit:
            return flush_done if flush_done > gc_until else gc_until
        m = now if now > gc_until else gc_until
        return m + DW55

    def ep_prefetch(now: float, start_addr: int, nbytes: int) -> None:
        nonlocal n_pref, n_evict
        first = start_addr // BLOCK
        last = (start_addr + (nbytes if nbytes > 1 else 1) - 1) // BLOCK
        missing: List[int] = []
        for b in range(first, last + 1):
            if b in cache:
                cache_mte(b)
            else:
                missing.append(b)
        if not missing:
            return
        n_pref += 1
        s0 = prev = missing[0]
        for b in missing[1:]:
            if b != prev + 1:
                d = media_fetch(now, s0 * BLOCK, (prev - s0 + 1) * BLOCK,
                                False)
                for bb in range(s0, prev + 1):
                    if len(cache) >= cache_cap:
                        cache_pop(last=False)
                        n_evict += 1
                    cache[bb] = d
                s0 = b
            prev = b
        d = media_fetch(now, s0 * BLOCK, (prev - s0 + 1) * BLOCK, False)
        for bb in range(s0, prev + 1):
            if len(cache) >= cache_cap:
                cache_pop(last=False)
                n_evict += 1
            cache[bb] = d

    op_l, base, etype, addr_a = _event_arrays(bundle, with_flush=ds)
    op_list = op_l.tolist()
    base_l = base.tolist()
    etype_l = etype.tolist()
    addr_l = addr_a.tolist()
    push, pop, pushpop = heapq.heappush, heapq.heappop, heapq.heappushpop

    warm_i = bundle.warm_i
    warm_off: Optional[float] = None
    offset = 0.0
    loads_q: List[float] = []
    stores_q: List[float] = []
    samples: List[Tuple[float, float, int]] = []

    for j in range(len(op_list)):
        if warm_off is None and op_list[j] >= warm_i:
            warm_off = offset
        t = base_l[j] + offset
        et = etype_l[j]

        if et == 0:                              # ---- background flush
            if staging and flush_enabled and devload(t) < 2:
                for _ in range(16 if len(staging) >= 16 else len(staging)):
                    a2 = staging.pop()
                    staging_index.pop(a2, None)
                    ep_write(t, a2)
                    ds_flu += 1
            continue

        addr = addr_l[j]

        if et == 1:                              # ---- load miss
            if len(loads_q) >= mlp:
                d = pop(loads_q)
                if d > t:
                    offset += d - t
                    t = d
            if ds and addr in staging_index:
                ds_rt += 1
                done = t + GPU_MEM_NS
            else:
                if smode:                        # --- SR flit generation
                    last = last_addr
                    last_addr = addr
                    if sr_halted and smode >= 2:
                        sr_halt_n += 1
                    else:
                        g = GRAN[g_idx]
                        start = -1
                        end = 0
                        if smode == 1:           # naive: one 64B MemSpecRd
                            if (addr >> 6) in cov:
                                sr_deduped += 1
                            else:
                                start = addr - addr % 64
                                end = start + 64
                        elif smode == 2:         # dyn: run-ahead window
                            if (addr >> 8) in cov and \
                                    ((addr + g // 2) >> 8) in cov:
                                sr_deduped += 1
                            else:
                                a = addr - addr % 256
                                for _p in range(16):
                                    if (a >> 8) not in cov:
                                        break
                                    a += 256
                                start = a
                                end = a + g
                        else:                    # sr: queue-derived window
                            if last is not None and addr != last:
                                dir_ewma = 0.9 * dir_ewma \
                                    + (0.1 if addr > last else -0.1)
                            dd = dir_ewma
                            if dd < -0.3:        # backward run
                                probe = addr - g // 2
                                if probe < 0:
                                    probe = 0
                                if (addr >> 8) in cov and \
                                        (probe >> 8) in cov:
                                    sr_deduped += 1
                                else:
                                    start = addr - addr % 256 - g + 256
                                    if start < 0:
                                        start = 0
                                    end = start + g
                            elif dd > 0.3:       # forward run
                                if (addr >> 8) in cov and \
                                        ((addr + g // 2) >> 8) in cov:
                                    sr_deduped += 1
                                else:
                                    a = addr - addr % 256
                                    for _p in range(16):
                                        if (a >> 8) not in cov:
                                            break
                                        a += 256
                                    start = a
                                    end = a + g
                            else:                # Around: centred window
                                lo = addr - g // 2
                                if lo < 0:
                                    lo = 0
                                if (lo >> 8) in cov and (addr >> 8) in cov \
                                        and ((addr + g // 2) >> 8) in cov:
                                    sr_deduped += 1
                                else:
                                    s2 = addr - g // 2
                                    start = s2 - s2 % 256
                                    if start < 0:
                                        start = 0
                                    end = start + g
                        if start >= 0:
                            ep_prefetch(t, start, end - start)
                            if len(ring) == 64:
                                s0_, e0_ = ring.popleft()
                                for u in range(s0_ >> cov_shift,
                                               e0_ >> cov_shift):
                                    nv = cov[u] - 1
                                    if nv:
                                        cov[u] = nv
                                    else:
                                        del cov[u]
                            ring.append((start, end))
                            for u in range(start >> cov_shift,
                                           end >> cov_shift):
                                cov[u] = cov.get(u, 0) + 1
                            sr_issued += 1
                            sr_bytes += end - start
                free = txn[0]
                now = (t if t > free else free) + _RTT2
                # --- ep.read, inlined (the loop's hottest path)
                n_reads += 1
                block = addr // BLOCK
                ready = cache_get(block)
                if ready is not None:
                    cache_mte(block)
                    if ready <= now:
                        n_hits += 1
                    m = now if now > ready else ready
                    done = m + DR55 + DRX + _RTT2
                else:
                    start2 = now if now > mshr else mshr
                    fetched = media_fetch(start2, addr, BLOCK, False)
                    mshr = fetched
                    if len(cache) >= cache_cap:
                        cache_pop(last=False)
                        n_evict += 1
                    cache[block] = fetched
                    if qos_live:
                        wait = (start2 - now) / (read_ns + 1.0)
                        dt = now - pressure_t
                        pressure_t = now
                        if pressure != 0.0:
                            pressure *= exp(
                                -(dt if dt > 0.0 else 0.0) / tau)
                        pressure = 0.75 * pressure + 0.25 * wait
                    done = fetched + DR55 + _RTT2
                pushpop(txn, done)
                # --- devload + qos.update, inlined
                if gc_every and written >= gc_thresh:
                    if done - last_write > 8 * write_ns:
                        written = 0
                        n_gc += 1
                        gc_start = done
                        gc_until = done + gc_ns
                    dl = 3
                elif done < gc_until:
                    dl = 3
                elif not qos_live:
                    dl = 0
                else:
                    dt = done - pressure_t
                    pressure_t = done
                    if pressure != 0.0:
                        pressure *= exp(-(dt if dt > 0.0 else 0.0) / tau)
                    p = pressure
                    dl = 3 if p > 3.0 else 2 if p > 1.0 \
                        else 1 if p > 0.25 else 0
                if dl == 0:
                    sr_halted = False
                    flush_enabled = True
                    if g_idx < 3:
                        g_idx += 1
                elif dl == 1:
                    flush_enabled = True
                elif dl == 2:
                    if g_idx > 0:
                        g_idx -= 1
                    flush_enabled = False
                else:
                    sr_halted = True
                    flush_enabled = False
                    g_idx = 0
            push(loads_q, done)
            if record_samples:
                samples.append((t, done - t, 1))

        else:                                    # ---- store miss
            if len(stores_q) >= store_q:
                d = pop(stores_q)
                if d > t:
                    offset += d - t
                    t = d
            qos_dl = -1
            if not ds:
                free = txn[0]
                arrival = (t if t > free else free) + _RTT2
                done = ep_write(arrival, addr) + _RTT2
                pushpop(txn, done)
                qos_dl = devload(done)
            else:
                congested = not flush_enabled
                if not congested:
                    congested = bool(gc_every) and written >= gc_thresh
                if not congested:
                    congested = devload(t) >= 2
                if congested:
                    if len(staging) >= staging_cap:
                        ds_blk += 1       # staging exhausted: plain store
                        free = txn[0]
                        arrival = (t if t > free else free) + _RTT2
                        done = ep_write(arrival, addr) + _RTT2
                        pushpop(txn, done)
                        qos_dl = devload(done)
                    else:
                        staging.append(addr)
                        staging_index[addr] = len(staging) - 1
                        ds_div += 1
                        done = t + GPU_MEM_NS
                else:
                    ds_faf += 1           # dual write: EP copy rides along
                    ep_write(t + _RTT2, addr)
                    qos_dl = devload(t)
                    done = t + GPU_MEM_NS
            if qos_dl >= 0:
                if qos_dl == 0:
                    sr_halted = False
                    flush_enabled = True
                    if g_idx < 3:
                        g_idx += 1
                elif qos_dl == 1:
                    flush_enabled = True
                elif qos_dl == 2:
                    if g_idx > 0:
                        g_idx -= 1
                    flush_enabled = False
                else:
                    sr_halted = True
                    flush_enabled = False
                    g_idx = 0
            push(stores_q, done)
            if record_samples:
                samples.append((t, done - t, 2))

    if warm_off is None:
        warm_off = offset
    t_final = bundle.cum[-1] + offset
    for q in (loads_q, stores_q):
        if q:
            t_final = max(t_final, max(q))
    sr_stats = {"issued": sr_issued, "deduped": sr_deduped,
                "halted": sr_halt_n, "bytes": sr_bytes}
    ds_stats = {"fire_and_forget": ds_faf, "diverted": ds_div,
                "flushed": ds_flu, "read_through": ds_rt, "blocked": ds_blk}
    return RunResult(
        config=config, workload="",
        media=getattr(media_name, "name", media_name),
        exec_ns=t_final - (bundle.cum[bundle.warm_i] + warm_off),
        n_ops=len(bundle.trace) - bundle.warm_i,
        ep_hit_rate=(n_hits / n_reads if n_reads else 0.0),
        sr=sr_stats, ds=ds_stats,
        samples=samples if record_samples else None)


# ---------------------------------------------------------------------------
# compressed event loop (cxl* on SSD media): exact controller state machine
# ---------------------------------------------------------------------------


def _run_cxl_events(bundle: TraceBundle, config: str, media, gpu_mem: int,
                    mlp: int, store_q: int, record_samples: bool, media_name
                    ) -> RunResult:
    ep = Endpoint(media, dram_cache_bytes=gpu_mem // 4)
    ctl = RootPortController(ep, sr_mode=_SR_MODE[config],
                             ds_enabled=(config == "cxl-ds"))

    op_idx, base, etype, addr_a = _event_arrays(bundle, with_flush=True)
    addr_l = addr_a.tolist()
    base_l = base.tolist()
    etype_l = etype.tolist()
    op_l = op_idx.tolist()

    warm_i = bundle.warm_i
    warm_off: Optional[float] = None
    offset = 0.0
    loads_q: List[float] = []
    stores_q: List[float] = []
    samples: List[Tuple[float, float, int]] = []
    load, store, flush = ctl.load, ctl.store, ctl.background_flush
    push, pop = heapq.heappush, heapq.heappop

    for j in range(len(op_l)):
        if warm_off is None and op_l[j] >= warm_i:
            warm_off = offset
        t = base_l[j] + offset
        et = etype_l[j]
        if et == 0:
            flush(t)
            continue
        addr = addr_l[j]
        if et == 1:
            if len(loads_q) >= mlp:
                d = pop(loads_q)
                if d > t:
                    offset += d - t
                    t = d
            done = load(t, addr)
            push(loads_q, done)
            if record_samples:
                samples.append((t, done - t, 1))
        else:
            if len(stores_q) >= store_q:
                d = pop(stores_q)
                if d > t:
                    offset += d - t
                    t = d
            done = store(t, addr)
            push(stores_q, done)
            if record_samples:
                samples.append((t, done - t, 2))

    if warm_off is None:
        warm_off = offset
    t_final = bundle.cum[-1] + offset
    for q in (loads_q, stores_q):
        if q:
            t_final = max(t_final, max(q))
    t_warm = bundle.cum[warm_i] + warm_off
    return RunResult(
        config=config, workload="",
        media=getattr(media_name, "name", media_name),
        exec_ns=t_final - t_warm, n_ops=len(bundle.trace) - warm_i,
        ep_hit_rate=ep.hit_rate(),
        sr=dataclasses.asdict(ctl.sr_stats), ds=dict(ctl.ds_stats),
        samples=samples if record_samples else None)


def _saturated(bundle: TraceBundle, config: str, media) -> bool:
    """Cheap pre-test: when demand approaches EP-channel or root-port
    transaction capacity, the closed form's fixed point converges slowly
    (queueing couples every event); go straight to the one-pass loop."""
    n = len(bundle.miss_base)
    span = float(bundle.cum[-1])
    if n == 0 or span <= 0.0:
        return False
    service = media.read_ns + media.xfer_ns(64)
    util_chan = n * service / (media.channels * span)
    n_txn = n if config != "cxl-ds" else int((bundle.miss_kind == 1).sum())
    util_txn = n_txn * (service + CXL_RTT_NS) / (TXN_SLOTS * span)
    return max(util_chan, util_txn) > 0.5


# ---------------------------------------------------------------------------
# public API — signature-compatible with repro_torch.sim.engine.run
# ---------------------------------------------------------------------------


def run(config: str, workload: str, media_name="dram", *,
        n_ops: int = 60_000, gpu_mem_frac: float = 0.1,
        working_set: int = 640 << 20, seed: int = 0,
        record_samples: bool = False, mlp: int = MLP,
        store_q: int = STORE_Q,
        trace: Optional[np.ndarray] = None) -> RunResult:
    """Vectorized replay. Same contract as ``repro_torch.sim.engine.run``."""
    bundle = bundle_for(workload, n_ops, working_set, seed, trace)
    media = resolve_media(media_name)
    gpu_mem = int(working_set * gpu_mem_frac)
    out: Optional[RunResult] = None

    if config == "gpu-dram":
        sol = _solve(bundle, np.zeros(len(bundle.miss_base)),
                     bundle.miss_kind == 1, mlp, store_q,
                     _dones_gpu_dram(bundle))
        if sol is not None:
            out = _finish(bundle, sol, config, media_name, record_samples)
    elif config in ("uvm", "gds"):
        out = _run_uvm_gds(bundle, config, media, gpu_mem, mlp, store_q,
                           record_samples, media_name)
    elif config in _SR_MODE:
        # Endpoint.is_dram media: SR/QoS never engage, closed form applies
        # (lockstep with Endpoint.is_dram: scaled DRAM stays DRAM-class)
        dram_class = media.gc_every_bytes == 0
        if dram_class and media.read_ns == media.write_ns \
                and not _saturated(bundle, config, media):
            out = _run_cxl_dram(bundle, config, media, mlp, store_q,
                                record_samples, media_name)
        if out is None:
            if dram_class:
                out = _run_cxl_dram_loop(bundle, config, media, mlp,
                                         store_q, record_samples,
                                         media_name)
            else:
                out = _run_cxl_ssd(bundle, config, media, gpu_mem, mlp,
                                   store_q, record_samples, media_name)
    else:
        raise ValueError(config)

    if out is None:                 # fixed point did not converge: oracle
        return se.run(config, workload, media_name, n_ops=n_ops,
                      gpu_mem_frac=gpu_mem_frac, working_set=working_set,
                      seed=seed, record_samples=record_samples, mlp=mlp,
                      store_q=store_q, trace=trace)
    out.workload = workload
    return out


# ---------------------------------------------------------------------------
# Closed-form page-trace latencies (DRAM-class EP)
# ---------------------------------------------------------------------------

def _chan_store(ch, nc, addr, w, s, sw, rb):
    """Exact EP-channel busy updates for one deterministic-store page op.

    A fire-and-forget store completes GPU-side at ``GPU_MEM_NS`` but its
    EP-side media write still occupies the owning channel
    (``Endpoint._media_fetch`` sets ``chan_busy[c] = max(arrival, busy)
    + write_ns + xfer``). ``ch`` is the port's channel-busy vector,
    ``s`` the op's service-walk start, ``sw`` the EP-side write service
    time. Requests walk ``addr`` in ``rb``-byte steps at ``GPU_MEM_NS``
    cadence, cycling channels with period ``nc / gcd(rb // BLOCK, nc)``;
    only each channel's last hit persists unless hits chain (service
    time exceeding the revisit gap), which falls back to the exact
    per-hit recurrence."""
    half = CXL_RTT_NS / 2.0
    blk = Endpoint.BLOCK
    if rb % blk == 0:
        stride = rb // blk
        per = nc // math.gcd(stride, nc)
        gap = per * GPU_MEM_NS
        c0 = (addr // blk) % nc
        for j in range(w if w < per else per):
            c = (c0 + j * stride) % nc
            hits = (w - 1 - j) // per + 1
            a0 = s + j * GPU_MEM_NS + half
            r = ch[c]
            b = (r if r > a0 else a0) + sw
            if hits > 1:
                if b <= a0 + gap:       # no chaining: last hit wins
                    b = a0 + (hits - 1) * gap + sw
                else:                   # chained hits: exact recurrence
                    for m in range(1, hits):
                        a = a0 + m * gap
                        b = (b if b > a else a) + sw
            ch[c] = b
    else:                               # irregular stride: walk requests
        for i in range(w):
            c = ((addr + i * rb) // blk) % nc
            a = s + i * GPU_MEM_NS + half
            r = ch[c]
            ch[c] = (r if r > a else a) + sw


def _chan_load_wait(ch, nc, addr, w, s, dreq, rb):
    """Exact cumulative queueing a demand-read page op pays to residual
    channel occupancy left by fire-and-forget stores.

    Each request arrives ``CXL_RTT/2`` after its cursor slot and queues
    behind ``chan_busy`` (``Endpoint._media_fetch``); a wait shifts every
    later request of the op by the same amount. Only a channel's first
    hit can wait — the read's own fetch then re-stamps the channel with
    a completion the serialized walk has already passed, so touched
    channels are cleared. Returns the total shift (ns) to add to the
    op's service time."""
    half = CXL_RTT_NS / 2.0
    blk = Endpoint.BLOCK
    shift = 0.0
    if rb % blk == 0:
        stride = rb // blk
        per = nc // math.gcd(stride, nc)
        c0 = (addr // blk) % nc
        for j in range(w if w < per else per):
            c = (c0 + j * stride) % nc
            r = ch[c]
            if r > 0.0:
                a = s + shift + j * dreq + half
                if r > a:
                    shift += r - a
                ch[c] = 0.0
    else:
        for i in range(w):
            c = ((addr + i * rb) // blk) % nc
            r = ch[c]
            if r > 0.0:
                a = s + shift + i * dreq + half
                if r > a:
                    shift += r - a
                ch[c] = 0.0
    return shift


def page_trace_closed_form(ops, media_name="dram", *, ds: bool = True,
                           req_bytes: int = 256,
                           max_inflight: int = se.MAX_INFLIGHT_OPS
                           ) -> np.ndarray:
    """Closed-form per-op latencies for a page trace on DRAM-class EPs —
    the vectorized cross-check for the serving tier's ``dram`` media bin
    and for the DRAM-EP lanes of a multi-port topology. Covers blocking
    *and* async (``issue``/``poll``) op kinds; fault-annotated kinds are
    rejected (see below).

    Valid because a stream on a DRAM EP never queues inside the
    controller: every demand request finds its transaction slot free and
    the staging stack empty (DRAM DevLoad is always LIGHT), so each 64B
    CXL.mem request costs exactly

        read:   CXL_RTT + read_ns + xfer(64B)
        write:  GPU_MEM_NS              (deterministic store, dual write)
                CXL_RTT + write_ns + xfer(64B)   (ds disabled)

    and a page op of ``ceil(nbytes / req_bytes)`` requests is that many
    multiples — plus one exactly-modeled EP-side coupling: on scaled
    DRAM bins where a deterministic store's media write outlasts its
    GPU-side completion (``write_ns + xfer > GPU_MEM_NS``, e.g.
    ``dram@4``), the fire-and-forget write leaves residual channel
    occupancy that a closely-following demand read on the same channels
    queues behind (``Endpoint.chan_busy``). The closed form tracks
    per-port channel busy state and charges those waits exactly
    (:func:`_chan_store` / :func:`_chan_load_wait`, O(channels) per
    affected op); bins where the residual cannot outlive the request
    cadence skip the bookkeeping entirely. The same per-op algebra
    holds per *port* of a multi-port topology: ports front independent
    EPs, so each lane's ops cost the same whether or not other lanes
    run concurrently — pass port-tagged ``(port, kind, addr, nbytes)``
    ops plus a sequence of per-port media specs as ``media_name``.

    Blocking-only traces with no channel coupling collapse to pure
    per-op algebra (no clock state at all). Otherwise the scan keeps two
    scalars of state per port — the stream clock ``t`` and the service
    cursor ``u`` — plus, for async kinds, the in-flight cap's
    issue-stall recurrence ``wait_m = max(0, d_{m-cap} - t)`` against
    the port's (monotone) async completion times ``d``; request costs,
    per-port async ordinals and cap-lag taps are all precomputed
    vectorized, leaving an O(1)-per-op scan (no per-request controller
    walk, no heaps — the scalar oracle pays both).

    Prefetch ops are free on the demand path (SR never engages on a DRAM
    EP); advance ops carry ``dt`` ns in the nbytes slot and move the
    clocks (syncing ports first, as ``Topology.advance`` does). Raises
    ``ValueError`` for media with internal tasks on any lane (those need
    the event loop) and for fault-annotated kinds (retry/backoff prices
    off the recording run's FaultSchedule — replay those with
    ``replay_page_trace(..., faults=...)``).

    Args:
        ops: ``(kind, addr, nbytes)`` tuples, or port-tagged 4-tuples.
        media_name: one media spec, or a sequence of per-port specs for
            port-tagged ops.
        ds: deterministic store enabled (writes bill at GPU-memory speed).
        req_bytes: bytes per CXL.mem request within a page op.
        max_inflight: per-port async in-flight cap the trace was recorded
            under (``TierConfig.max_inflight``).

    Returns:
        Per-op latencies (ns), aligned with ``ops`` — completion latency
        for blocking ops, issue-stall wait for async ops, 0 for
        prefetch/advance (matching ``replay_page_trace``).
    """
    if max_inflight < 1:
        raise ValueError("max_inflight must be >= 1")
    if isinstance(media_name, (list, tuple)):
        medias = [resolve_media(m) for m in media_name]
        ops = list(ops)
        ports = np.asarray([p for p, _, _, _ in ops], np.int64)
        rest = [(k, a, n) for _, k, a, n in ops]
        tagged = True
    else:
        medias = [resolve_media(media_name)]
        rest = list(ops)
        ports = np.zeros(len(rest), np.int64)
        tagged = False
    for media in medias:
        # lockstep with Endpoint.is_dram: DRAM-class = no internal tasks
        # (scaled variants like "dram@2" stay valid — the stream never
        # queues in the controller regardless of the latency multiplier)
        if media.gc_every_bytes != 0:
            raise ValueError(f"{media.name}: closed form needs a "
                             "DRAM-class EP")
    kinds = np.asarray([k for k, _, _ in rest], np.int64)
    if np.any(np.isin(kinds, se.PAGE_FAULT_KINDS)):
        # fault-annotated ops price retry/backoff (and downed-port zero
        # charges) off the recording run's FaultSchedule — event-loop
        # state the per-op algebra cannot see
        raise ValueError("closed form cannot price fault-annotated page "
                         "ops; replay them with replay_page_trace(..., "
                         "faults=<the recording run's FaultSchedule>)")
    known = np.isin(kinds, (se.PAGE_ADVANCE, se.PAGE_READ, se.PAGE_WRITE,
                            se.PAGE_PREFETCH, se.PAGE_READ_ASYNC,
                            se.PAGE_WRITE_ASYNC))
    if not np.all(known):
        bad = sorted(set(kinds[~known].tolist()))
        raise ValueError(f"unknown page-op kind(s) {bad} in trace; known "
                         "kinds are PAGE_ADVANCE/PAGE_READ/PAGE_WRITE/"
                         "PAGE_PREFETCH/PAGE_READ_ASYNC/PAGE_WRITE_ASYNC "
                         "(fault-annotated kinds need replay_page_trace)")
    n = len(kinds)
    if n == 0:
        return np.zeros(0, np.float64)
    nbytes = np.asarray([nb for _, _, nb in rest], np.int64)
    n_reqs = -(-nbytes // req_bytes)
    line = 64                      # CXL.mem request granularity (MemRd)
    read_req = np.asarray(
        [CXL_RTT_NS + m.read_ns + m.xfer_ns(line) for m in medias])
    write_req = np.asarray(
        [GPU_MEM_NS if ds else CXL_RTT_NS + m.write_ns + m.xfer_ns(line)
         for m in medias])
    lane = np.clip(ports, 0, len(medias) - 1)   # advance records use -1
    is_read = (kinds == se.PAGE_READ) | (kinds == se.PAGE_READ_ASYNC)
    is_write = (kinds == se.PAGE_WRITE) | (kinds == se.PAGE_WRITE_ASYNC)
    dur = np.zeros(n, np.float64)              # service ns per op
    dur[is_read] = (n_reqs * read_req[lane])[is_read]
    dur[is_write] = (n_reqs * write_req[lane])[is_write]
    is_async = (kinds == se.PAGE_READ_ASYNC) | (kinds == se.PAGE_WRITE_ASYNC)
    # EP-channel residual coupling: a deterministic store's media write
    # can outlive the GPU-side completion only when its service time
    # exceeds the request cadence — then reads on the same lane can
    # queue behind it and the scan must track channel state
    chan_model = [ds and m.write_ns + m.xfer_ns(line) > GPU_MEM_NS
                  for m in medias]
    n_ports = len(medias)
    needs_chan = any(
        chan_model[p] and bool((is_write & (lane == p)).any())
        and bool((is_read & (lane == p)).any()) for p in range(n_ports))
    if not is_async.any() and not needs_chan:
        # blocking fast path: the stream clock always catches the service
        # cursor (t == u after every blocking op), so latency == service
        # time per op — no clock state needed at all
        return np.where((kinds == se.PAGE_READ) | (kinds == se.PAGE_WRITE),
                        dur, 0.0)

    # --- scan path: exact O(1)-state scan over precomputed costs ------
    # per-port async ordinals + cap-lag taps, vectorized: async op number
    # m on a port stalls until its (m - cap)-th predecessor completes
    # (completion times are monotone, so sorted(inflight)[len-cap] in
    # PageStream.issue is exactly d[m - cap])
    ordv = np.zeros(n, np.int64)
    n_async_p = [0] * n_ports
    for p in range(n_ports):
        mask = is_async & (lane == p)
        cnt = int(mask.sum())
        ordv[mask] = np.arange(cnt)
        n_async_p[p] = cnt
    tap = ordv - max_inflight       # < 0: cap slack, never stalls
    dur[kinds == se.PAGE_ADVANCE] = \
        nbytes[kinds == se.PAGE_ADVANCE].astype(np.float64)
    adv, rd, wr, pre = (se.PAGE_ADVANCE, se.PAGE_READ, se.PAGE_WRITE,
                        se.PAGE_PREFETCH)
    kl = kinds.tolist()
    ll = lane.tolist()
    dl = dur.tolist()
    ol = ordv.tolist()
    tl = tap.tolist()
    al = [a for _, a, _ in rest]    # request walks need base addresses
    wn = n_reqs.tolist()
    sw_l = [m.write_ns + m.xfer_ns(line) for m in medias]
    rr_l = read_req.tolist()
    chs = [[0.0] * m.channels if chan_model[p] else None
           for p, m in enumerate(medias)]
    t = [0.0] * n_ports             # stream clocks
    u = [0.0] * n_ports             # service cursors (busy_until)
    adone = [[0.0] * c for c in n_async_p]   # async completion times
    lat = [0.0] * n
    rda = se.PAGE_READ_ASYNC
    for e in range(n):
        k = kl[e]
        if k == adv:
            # Topology.advance: sync every stream clock to the global
            # max, then advance by dt (single-port traces degenerate to
            # t += dt); service cursors are untouched
            g = max(t) + dl[e]
            for p in range(n_ports):
                t[p] = g
        elif k == pre:
            continue                # free on a DRAM EP, no state change
        elif k == rd or k == wr:
            p = ll[e]
            tp, up = t[p], u[p]
            s = tp if tp > up else up
            d = dl[e]
            ch = chs[p]
            if ch is not None:
                if k == wr:
                    _chan_store(ch, len(ch), al[e], wn[e], s, sw_l[p],
                                req_bytes)
                else:
                    d += _chan_load_wait(ch, len(ch), al[e], wn[e], s,
                                         rr_l[p], req_bytes)
            done = s + d
            lat[e] = done - tp
            t[p] = u[p] = done
        else:                       # async issue
            p = ll[e]
            j = tl[e]
            tp = t[p]
            if j >= 0:
                dn = adone[p][j]
                if dn > tp:
                    lat[e] = dn - tp
                    tp = dn
                    t[p] = dn
            up = u[p]
            s = tp if tp > up else up
            d = dl[e]
            ch = chs[p]
            if ch is not None:
                if k == rda:
                    d += _chan_load_wait(ch, len(ch), al[e], wn[e], s,
                                         rr_l[p], req_bytes)
                else:
                    _chan_store(ch, len(ch), al[e], wn[e], s, sw_l[p],
                                req_bytes)
            done = s + d
            u[p] = done
            adone[p][ol[e]] = done
    return np.asarray(lat, np.float64)
