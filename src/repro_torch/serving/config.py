"""Validated serving-engine configuration (the ``ServeConfig`` dataclass).

One frozen dataclass consolidates every ``ServingEngine`` constructor
knob — slot count, hot-path options, scheduler policy and the CXL-tier
attachment — so the engine, ``repro_torch.launch.serve``'s CLI and the
``benchmarks/serve_bench.py`` scenarios all derive from the same
defaults instead of each duplicating them. Cross-field constraints
(the frozen legacy baseline vs scheduler features, closed-batch
admission vs preemption, policy spellings) are validated once, at
construction, with the same errors the engine used to raise piecemeal.

The module imports nothing heavier than the stdlib at import time; the
tier attachment (:meth:`ServeConfig.make_tier`) imports
``repro_torch.core.tier`` lazily so building and validating a config never
touches torch.

This is the reference package's ``ServeConfig`` with the same fields and
validation; options this port does not implement yet (the legacy host
path) raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# mirrored from repro_torch.serving.scheduler / repro_torch.core.tier so validating
# a config stays import-light; the owning modules re-validate on use.
_PREEMPT_POLICIES = ("none", "swap", "recompute")
_ADMIT_MODES = ("continuous", "closed")
_PLACEMENTS = ("striped", "hashed", "hotness", "learned")
_FAULT_KINDS = ("degrade", "transient", "hot_remove")
# mirrored from repro_torch.models.kv_quant.KV_QUANT_MODES ("fp8" is reserved —
# spelled here so the error message can say so without importing torch)
_KV_QUANT_MODES = ("none", "int8", "fp8")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Everything a ``ServingEngine`` needs beyond params/config/mesh.

    Engine shape and hot path:

     * ``n_slots`` — concurrent decode slots (the continuous batch).
     * ``max_seq`` — per-slot page capacity in tokens.
     * ``temperature`` / ``seed`` — on-device sampling (0 = greedy).
     * ``prefill_chunk`` — tokens per jitted prefill dispatch.
     * ``store_budget_bytes`` — HostPageStore LRU budget (None = ∞).
     * ``legacy_host_path`` — the frozen pre-rewrite baseline engine.
     * ``sync_prefill`` — block after prefill (benchmark accounting).
     * ``kv_quant`` — KV page format: ``"none"`` (model dtype) or
       ``"int8"`` (per-page-scaled int8 pages; every tier flush /
       restore / swap / SR fetch is charged the quantized byte count —
       see ``repro_torch.models.kv_quant``). ``"fp8"`` is reserved.

    Scheduler (``repro_torch.serving.scheduler``):

     * ``cxl_async`` — completion-based async tier I/O (restores overlap
       decode; flushes become background ops).
     * ``preempt_policy`` — ``none`` / ``swap`` / ``recompute``.
     * ``admit_mode`` — ``continuous`` (admit-on-retire slot recycling,
       the default) or ``closed`` (wave batching: a new wave is admitted
       only once every slot drained — the baseline the open-loop load
       gates compare against).

    CXL tier attachment (declarative; :meth:`make_tier` builds it):

     * ``tier_media`` — single-port media bin ("" = no tier attached).
     * ``tier_topology`` — per-port media bins; non-empty overrides
       ``tier_media`` with a multi-root-port tier.
     * ``tier_placement`` / ``tier_sr`` — placement policy and the
       speculative-read engine. ``"learned"`` drives promotion /
       demotion (and, sharded, cross-rank re-homing) from a
       :class:`repro_torch.sim.policy.LearnedPlacement` GMM instead of the
       ``hotness`` restore counter.
     * ``tier_heat_half_life_ns`` — heat aging half-life for the
       ``hotness`` / ``learned`` policies (0 = no aging; a once-hot
       entry then pins its fast port until budget pressure evicts it).
     * ``tier_step_ns`` — simulated ns per engine tick.
     * ``tier_faults`` — declarative fault events, stdlib tuples of
       ``("degrade", t_ns, port, mult[, until_ns])``,
       ``("transient", t_ns, port, p_err[, until_ns])`` or
       ``("hot_remove", t_ns, port)``; :meth:`make_tier` folds them into
       a deterministic ``repro_torch.sim.engine.FaultSchedule`` seeded by
       ``fault_seed``. Requires a tier attachment. On a sharded tier
       the schedule applies to rank 0's port set (port indices stay
       per-rank-local).

    Sharded serving (``repro_torch.launch.mesh`` + ``repro_torch.parallel``):

     * ``mesh_shape`` — explicit (data, model) or (pod, data, model)
       device-mesh shape; the engine builds it via
       ``make_production_mesh(shape=...)`` and shards params + the
       paged KV cache across the model axis. ``()`` means unsharded
       (whatever mesh the caller activated, usually the host mesh).
     * ``tp`` — tensor-parallel sugar: ``tp=N`` is ``mesh_shape=(1, N)``.
       The model axis of ``mesh_shape``, when both are given, must
       equal ``tp``. ``n_ranks`` (model-axis size) also shards the CXL
       tier: :meth:`make_tier` returns a ``ShardedTier`` with one
       port set per rank when ``n_ranks > 1``.
    """

    n_slots: int = 4
    max_seq: int = 512
    temperature: float = 0.0
    seed: int = 0
    prefill_chunk: int = 32
    store_budget_bytes: Optional[int] = 256 << 20
    legacy_host_path: bool = False
    sync_prefill: bool = False
    kv_quant: str = "none"
    cxl_async: bool = False
    preempt_policy: str = "none"
    admit_mode: str = "continuous"
    tier_media: str = ""
    tier_topology: Tuple[str, ...] = ()
    tier_placement: str = "striped"
    tier_heat_half_life_ns: float = 0.0
    tier_sr: bool = True
    tier_step_ns: float = 100_000.0
    tier_faults: Tuple[tuple, ...] = ()
    fault_seed: int = 0
    mesh_shape: Tuple[int, ...] = ()
    tp: int = 1

    def __post_init__(self):
        """Validate spellings and cross-field constraints once."""
        if self.n_slots < 1:
            raise ValueError(f"n_slots must be >= 1 (got {self.n_slots})")
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1 "
                             f"(got {self.prefill_chunk})")
        if self.preempt_policy not in _PREEMPT_POLICIES:
            raise ValueError(f"unknown preempt_policy "
                             f"{self.preempt_policy!r} (expected one of "
                             f"{_PREEMPT_POLICIES})")
        if self.admit_mode not in _ADMIT_MODES:
            raise ValueError(f"unknown admit_mode {self.admit_mode!r} "
                             f"(expected one of {_ADMIT_MODES})")
        if self.kv_quant not in _KV_QUANT_MODES:
            raise ValueError(f"unknown kv_quant {self.kv_quant!r} "
                             f"(expected one of {_KV_QUANT_MODES})")
        if self.kv_quant == "fp8":
            raise ValueError("kv_quant='fp8' is reserved but not "
                             "implemented yet; use 'none' or 'int8'")
        if self.kv_quant != "none" and self.legacy_host_path:
            raise ValueError("kv_quant needs the device-resident paged "
                             "cache; the legacy host path keeps flat "
                             "full-precision K/V tuples")
        if self.tier_placement not in _PLACEMENTS:
            raise ValueError(f"unknown tier_placement "
                             f"{self.tier_placement!r} (expected one of "
                             f"{_PLACEMENTS})")
        if self.tier_heat_half_life_ns < 0:
            raise ValueError("tier_heat_half_life_ns must be >= 0 "
                             f"(got {self.tier_heat_half_life_ns})")
        if self.legacy_host_path and (self.cxl_async
                                      or self.preempt_policy != "none"):
            raise ValueError("the legacy host path is the frozen baseline: "
                             "cxl_async / preempt_policy need the "
                             "device-resident engine")
        if self.admit_mode == "closed" and self.preempt_policy != "none":
            raise ValueError("closed-batch admission cannot preempt: a "
                             "wave has no queue pressure to preempt for "
                             "(use admit_mode='continuous')")
        if self.tier_step_ns <= 0:
            raise ValueError("tier_step_ns must be positive "
                             f"(got {self.tier_step_ns})")
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1 (got {self.tp})")
        if self.mesh_shape:
            if len(self.mesh_shape) not in (2, 3) or \
                    any(int(s) < 1 for s in self.mesh_shape):
                raise ValueError(
                    "mesh_shape must be a 2- or 3-tuple of positive ints "
                    f"(got {self.mesh_shape!r})")
            if self.tp > 1 and self.mesh_shape[-1] != self.tp:
                raise ValueError(
                    f"mesh_shape model axis {self.mesh_shape[-1]} "
                    f"conflicts with tp={self.tp}; set one or make them "
                    "agree")
        if self.n_ranks > 1 and self.legacy_host_path:
            raise ValueError("sharded serving needs the device-resident "
                             "engine; the legacy host path is single-rank")
        if self.tier_faults:
            if not self.has_tier:
                raise ValueError("tier_faults without a tier attachment: "
                                 "set tier_media or tier_topology")
            for ev in self.tier_faults:
                if not ev or ev[0] not in _FAULT_KINDS:
                    raise ValueError(f"unknown fault event {ev!r} "
                                     f"(kinds: {_FAULT_KINDS})")
        if self.legacy_host_path:
            raise NotImplementedError("the legacy host path is not ported; "
                                      "the port serves on the device-"
                                      "resident path only")

    @classmethod
    def field_names(cls) -> Tuple[str, ...]:
        """Declared field names in declaration order (CLI derivation)."""
        return tuple(f.name for f in dataclasses.fields(cls))

    @property
    def has_tier(self) -> bool:
        """True when this config declares a CXL tier attachment."""
        return bool(self.tier_topology or self.tier_media)

    @property
    def resolved_mesh_shape(self) -> Tuple[int, ...]:
        """The mesh shape the engine should build (``()`` = unsharded).

        ``mesh_shape`` wins when set; otherwise ``tp > 1`` expands to
        ``(1, tp)``; otherwise the config is unsharded and the engine
        runs under whatever mesh the caller activated.
        """
        if self.mesh_shape:
            return tuple(int(s) for s in self.mesh_shape)
        if self.tp > 1:
            return (1, int(self.tp))
        return ()

    @property
    def n_ranks(self) -> int:
        """Model-axis size: tensor-parallel rank count (1 = unsharded)."""
        shape = self.mesh_shape or ((1, self.tp) if self.tp > 1 else ())
        return int(shape[-1]) if shape else 1

    def _tier_config(self, faults=None):
        """The per-tier ``TierConfig`` this config declares."""
        from repro_torch.core.tier import TierConfig
        if self.tier_topology:
            return TierConfig(topology=tuple(self.tier_topology),
                              placement=self.tier_placement,
                              heat_half_life_ns=self.tier_heat_half_life_ns,
                              sr_enabled=self.tier_sr, faults=faults)
        return TierConfig(media=self.tier_media, sr_enabled=self.tier_sr,
                          faults=faults)

    def make_tier(self):
        """Build the declared tier (or None without one).

        Single-rank configs get a ``CxlTier``; ``n_ranks > 1`` gets a
        ``ShardedTier`` with one port set per rank (fault schedule on
        rank 0). Lazy-imports ``repro_torch.core.tier`` so config
        construction and validation stay torch-free; callers that inject
        a prebuilt tier (tests, benches) simply never call this.
        """
        if not self.has_tier:
            return None
        faults = self.make_fault_schedule()
        if self.n_ranks > 1:
            from repro_torch.core.sharded_tier import ShardedTier
            return ShardedTier(self.n_ranks, self._tier_config(),
                               faults=faults, fault_rank=0)
        from repro_torch.core.tier import CxlTier
        return CxlTier(self._tier_config(faults))

    def make_fault_schedule(self):
        """Fold ``tier_faults`` into a ``FaultSchedule`` (None if empty).

        Lazy-imports ``repro_torch.sim.engine`` for the same reason
        :meth:`make_tier` is lazy; the event helpers re-validate the
        numeric fields (times, ports, multipliers, probabilities).
        """
        if not self.tier_faults:
            return None
        from repro_torch.sim.engine import (FaultSchedule, degrade, hot_remove,
                                      transient)
        mk = {"degrade": degrade, "transient": transient,
              "hot_remove": hot_remove}
        events = tuple(mk[ev[0]](*ev[1:]) for ev in self.tier_faults)
        return FaultSchedule(events, seed=self.fault_seed)
