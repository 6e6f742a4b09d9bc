"""Typed serving telemetry: the single source of truth for stat keys.

Two dataclasses whose *field lists* are schema:

 * :class:`EngineStats` — the serving engine's per-run counters
   (``engine.stats``). It replaces the old ad-hoc dict but keeps the
   mapping protocol (``stats["decode_tokens"] += 1``) so every existing
   call site and test reads unchanged; unknown keys raise ``KeyError``
   instead of silently growing the schema.
 * :class:`LoadMetrics` — the SLO summary one open-loop load scenario
   produces (``repro_torch.serving.loadgen.summarize``): TTFT/TPOT
   percentiles, goodput at the latency target, queue-depth and
   restore-stall percentiles.

``benchmarks/serve_bench.py`` derives its ``SCHEMA_KEYS`` sections from
:meth:`EngineStats.field_names` / :meth:`LoadMetrics.field_names`, and
``tools/check_docs.py`` pins the docs/ARCHITECTURE.md schema tables
against the same constant — so the engine's fields, the bench artifact
and the documentation cannot drift independently.

This module is deliberately **pure stdlib** (no jax, no numpy): the CI
docs job imports it (by file path, through serve_bench) in an
environment where only numpy is installed.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple


class _StatsMapping:
    """Dataclass mixin adding the dict-style protocol over the fields.

    Keys are exactly the dataclass fields: ``__getitem__`` /
    ``__setitem__`` on any other name raise ``KeyError`` (a typo'd stat
    can no longer silently create a key the schema never sees).
    """

    @classmethod
    def field_names(cls) -> Tuple[str, ...]:
        """The declared field names, in declaration order (the schema)."""
        return tuple(f.name for f in dataclasses.fields(cls))

    def __getitem__(self, key: str):
        """Read one stat by name (``stats["decode_tokens"]``)."""
        if key not in self.__dataclass_fields__:
            raise KeyError(key)
        return getattr(self, key)

    def __setitem__(self, key: str, value) -> None:
        """Assign one stat by name; unknown names raise ``KeyError``."""
        if key not in self.__dataclass_fields__:
            raise KeyError(key)
        setattr(self, key, value)

    def __contains__(self, key: str) -> bool:
        """True when ``key`` is a declared stat field."""
        return key in self.__dataclass_fields__

    def keys(self) -> Tuple[str, ...]:
        """Field names, dict-style."""
        return self.field_names()

    def items(self):
        """(name, value) pairs in declaration order, dict-style."""
        return [(k, getattr(self, k)) for k in self.field_names()]

    def values(self) -> List:
        """Field values in declaration order, dict-style."""
        return [getattr(self, k) for k in self.field_names()]

    def as_dict(self) -> dict:
        """A JSON-serializable copy (nested stat dicts are copied)."""
        out = {}
        for k in self.field_names():
            v = getattr(self, k)
            if isinstance(v, list):
                v = [dict(e) if isinstance(e, dict) else e for e in v]
            out[k] = v
        return out


@dataclasses.dataclass
class EngineStats(_StatsMapping):
    """Serving-engine telemetry for one ``ServingEngine`` instance.

    The field list *is* the schema: ``serve_bench.SCHEMA_KEYS`` and the
    documented table in docs/ARCHITECTURE.md both derive from
    :meth:`field_names`. All times are simulated nanoseconds unless the
    suffix says otherwise (``prefill_time_s`` is wall seconds).
    """

    # hot-path counters
    steps: int = 0                       # engine ticks that did work
    prefill_tokens: int = 0              # prompt tokens ingested
    decode_tokens: int = 0               # tokens generated
    flushes: int = 0                     # retired entries flushed to host
    prefill_dispatches: int = 0          # jitted prefill-chunk dispatches
    decode_dispatches: int = 0           # fused decode+sample dispatches
    prefix_hits: int = 0                 # admissions served via restore
    prefill_time_s: float = 0.0          # wall time in prefill (admission)
    store_bytes: int = 0                 # HostPageStore LRU occupancy
    store_evictions: int = 0             # HostPageStore LRU evictions
    # CXL-tier accounting (all zero without a tier): simulated ns the
    # restore path stalled on cold-tier fetches / the flusher held on EP
    # writes, the EP's SR hit rate, DS staging-stack fill, and flush
    # windows the EP deferred (QoS admission).
    restore_stall_ns: float = 0.0
    tier_write_ns: float = 0.0
    tier_sr_hit_rate: float = 0.0
    tier_store_occupancy: float = 0.0
    flush_backlog: int = 0
    flushes_deferred: int = 0
    # per-root-port telemetry (multi-port topologies): occupancy, queue
    # depth, DevLoad, SR hit rate and async in-flight depth per port —
    # refreshed live every tick (tier.port_stats() is an in-place
    # updated view, so this is allocation-free).
    tier_ports: list = dataclasses.field(default_factory=list)
    # placement telemetry (multi-port tiers): entries migrated onto /
    # off the fast ports by the placement policy (``hotness`` counter or
    # the ``learned`` GMM — see repro_torch.sim.policy) and the simulated ns
    # those migrations charged.
    tier_promotions: int = 0
    tier_demotions: int = 0
    tier_migrate_ns: float = 0.0
    # request-lifecycle scheduler telemetry: preempted slots, page bytes
    # swapped out/in through the tier, total async restore in-flight ns
    # and the fraction hidden behind decode (1.0 = fully overlapped),
    # plus current/peak outstanding async tier ops.
    preemptions: int = 0
    swap_out_bytes: int = 0
    swap_in_bytes: int = 0
    restore_inflight_ns: float = 0.0
    restore_overlap_ratio: float = 0.0
    sched_inflight_ops: int = 0
    sched_inflight_peak: int = 0
    # fault injection + recovery (all zero without a FaultSchedule on
    # the tier): page ops that needed transient retries / exhausted the
    # retry budget, entries+bytes lost to hot-removed ports, ports
    # currently down, and requests re-queued through the RECOVERING
    # state after a failed fetch or page loss.
    tier_fault_ops: int = 0
    tier_fault_retries: int = 0
    tier_fault_failures: int = 0
    tier_lost_entries: int = 0
    tier_lost_bytes: int = 0
    tier_ports_down: int = 0
    recoveries: int = 0
    # sharded serving (all zero/1 on a single-rank engine): model-axis
    # rank count, cross-rank peer-link fetches + bytes + link ns served
    # by entry owners, and keys whose ownership migrated to a surviving
    # rank's mirror copy after a fault (the peer-recovery path).
    mesh_ranks: int = 1
    tier_peer_fetches: int = 0
    tier_peer_bytes: int = 0
    tier_peer_fetch_ns: float = 0.0
    tier_rank_remaps: int = 0
    tier_peer_recoveries: int = 0
    # learned cross-rank homing (zero unless placement="learned" on a
    # sharded tier): entries re-homed to their dominant requester rank,
    # and hot restores served multi-source from every live holder.
    tier_rehomes: int = 0
    tier_multi_source_reads: int = 0
    # clocks: the tier topology's simulated time at the last tick, and
    # the engine's own tick clock (tier_step_ns per working tick plus
    # open-loop idle jumps — requests per simulated second and every SLO
    # latency are measured on it).
    sim_time_ns: float = 0.0
    clock_ns: float = 0.0


@dataclasses.dataclass
class LoadMetrics(_StatsMapping):
    """SLO summary of one open-loop load scenario (all latencies ms).

    Produced by ``repro_torch.serving.loadgen.summarize`` from the per-request
    timing the engine stamps on its simulated tick clock:

     * **TTFT** (time to first token) = ``first_token_ns - arrival_ns``
       — queueing + admission + restore wait, everything before the
       first generated token exists.
     * **TPOT** (time per output token) = decode span / (tokens - 1).
     * **goodput** = requests that completed *within both SLO targets*
       (``slo_ttft_ms`` and ``slo_tpot_ms``) per simulated second;
       ``throughput_req_s`` counts every completion regardless of SLO.

    Percentiles over completed requests (TTFT/TPOT/restore stall) and
    over per-tick samples (queue depth).
    """

    arrivals: int = 0                    # requests the trace injected
    completed: int = 0                   # requests retired by the horizon
    completed_in_slo: int = 0            # completed within both SLOs
    goodput_req_s: float = 0.0           # SLO-compliant completions / sim s
    throughput_req_s: float = 0.0        # all completions / sim s
    ttft_ms_p50: float = 0.0
    ttft_ms_p99: float = 0.0
    tpot_ms_p50: float = 0.0
    tpot_ms_p99: float = 0.0
    queue_depth_p50: float = 0.0
    queue_depth_p99: float = 0.0
    restore_stall_ms_p50: float = 0.0
    restore_stall_ms_p99: float = 0.0
    slo_ttft_ms: float = 0.0             # the targets the goodput gate used
    slo_tpot_ms: float = 0.0
    sim_time_ms: float = 0.0             # engine clock span of the run
    preemptions: int = 0
    prefix_hits: int = 0
    # fault axis: RECOVERING re-queues the run absorbed, and requests
    # that never completed (the zero-lost-requests gate's numerator —
    # arrivals minus completions after the horizon drain).
    recoveries: int = 0
    lost_requests: int = 0
