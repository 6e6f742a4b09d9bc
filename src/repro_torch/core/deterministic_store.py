"""Deterministic store — fire-and-forget writes with staged writeback.

Paper mechanism (Fig. 8): a store to a slow EP completes immediately by
writing concurrently to GPU memory (a reserved, stack-organized staging
region indexed from SRAM) and the EP; under tail latency (GC) the write is
diverted to the staging region only and flushed in the background; reads
consult the staging index first.

* Training gradients: the reference pins the gradients to the pool
  sharding so that its backward emits a reduce-scatter (``ds_grad_specs``,
  ``apply_ds``). Over a rank mesh the port's backward does the same: each
  POOL-tier layer is gathered differentiably (``parallel.sharding.
  gather_train``) and the transpose of that gather is the
  ``GradReducer``, which reduce-scatters the layer's gradients in f32
  (one ``reduce_scatter`` a layer) so that each rank completes its shard
  and no whole gradient outlives its layer's backward; disabled, it is
  the baseline's all-reduce of the whole gradient, then the rank's slice.
  ``apply_ds`` then all-reduces the leaves that have no FSDP axis (norm
  scales, leaves the divisibility guard leaves whole, every leaf on the
  DEVICE tier), packed into one all-reduce. On a model axis too (Megatron's
  split, ``launch.steps``) a rank's gradients are its (F, M) shards and
  every reduction here stays over the data axes: a leaf cut on "model" is
  summed over the data ranks that hold the same part, and a leaf whole on
  the model axis arrives with its whole gradient on every model rank (the
  sums over the model axis are taken in the backward,
  ``parallel.sharding.copy_in``), so it is never summed over it again. At a data axis of 2 both
  modes give the same bits (each sum is one f32 addition, a + b on one
  rank, b + a on the other). On one rank both pass their input through.
* The staging ring (``RingState``, ``ring_init``, ``ring_write``,
  ``ring_lookup``, ``read_through``, ``ring_occupancy``): bounded slots on
  the device, written at the head, read through before the backing tier;
  tensors, each write returning a new state, as the reference's.
* ``StagingFlusher``, copied line for line from the reference package:
  drains staged items between steps while QoS allows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.qos import QoSController


# ---------------------------------------------------------------------------
# Gradient path (training)
# ---------------------------------------------------------------------------


def ds_grad_specs(param_specs: Any, enabled: bool) -> Any:
    """The placement the backward delivers gradients in (``{name: spec}``
    or a list of specs): the pool's (reduce-scatter; deterministic store)
    when enabled, else the gathered one (all-reduce of the whole gradient,
    the baseline a conventional data-parallel step uses)."""
    if enabled:
        return param_specs
    if isinstance(param_specs, dict):
        return {k: gathered_spec(s) for k, s in param_specs.items()}
    return [gathered_spec(s) for s in param_specs]


def gathered_spec(spec: Tuple) -> Tuple:
    """``spec`` with its FSDP axis dropped (the reference's
    ``gathered_specs`` of one leaf)."""
    def keep(a):
        if a == "data" or a == "pod":
            return None
        if isinstance(a, tuple):
            rest = tuple(x for x in a if x not in ("pod", "data"))
            return rest[0] if len(rest) == 1 else (rest or None)
        return a
    return tuple(keep(a) for a in spec)


def has_fsdp(spec: Tuple) -> bool:
    """Whether ``spec`` puts an FSDP axis (data, or pod and data) on the
    leaf."""
    return any(a == "data" or (isinstance(a, tuple) and "data" in a)
               for a in spec)


class GradReducer:
    """The deterministic store of one training step over the FSDP
    ``group``: the transpose of a POOL-tier unit's gather
    (``parallel.sharding.gather_train``). ``reduce(buf, key)`` takes the
    unit's whole gradients packed in f32 as [size, total] (row f: what
    FSDP rank f keeps) and returns this rank's row summed over the ranks
    -- one ``reduce_scatter`` when ``enabled``, else one all-reduce of the
    whole buffer and the rank's row. With ``final`` False (a microbatch
    before the last) the buffer is added to the unit's accumulator under
    ``key`` and zeros are returned; the last microbatch's call adds the
    accumulator first, so a unit is reduced once a step however many
    microbatches it has."""

    def __init__(self, group, enabled: bool = True):
        self.group, self.enabled = group, enabled
        self.final = True
        self.acc: Dict[Any, torch.Tensor] = {}

    def reduce(self, buf: torch.Tensor, key) -> torch.Tensor:
        if not self.final:
            if key in self.acc:
                self.acc[key] += buf
            else:
                self.acc[key] = buf
            return torch.zeros(buf.shape[1:], dtype=buf.dtype,
                               device=buf.device)
        if key in self.acc:
            buf = buf + self.acc.pop(key)
        if self.enabled:
            return self.group.reduce_scatter(buf, 0)[0]
        return self.group.all_reduce(buf, "sum")[self.group.rank]


def apply_ds(grads: Any, param_specs: Any = None, group=None) -> Any:
    """Gradients in their deterministic-store placement. ``grads`` and
    ``param_specs`` are aligned lists. Over a rank ``group`` (the FSDP and
    batch axes) the leaves whose spec has an FSDP axis arrive as this
    rank's shard already, reduced in the backward by the step's
    ``GradReducer`` (which holds the DS mode); the others are summed over
    the group here, in f32, packed into one all-reduce, each cast back to
    its dtype. On one rank the gradients are whole and pass through
    unchanged."""
    if group is None or group.size == 1:
        return grads
    whole = [i for i, s in enumerate(param_specs) if not has_fsdp(s)]
    if not whole:
        return list(grads)
    flat = torch.cat([grads[i].float().reshape(-1) for i in whole])
    flat = group.all_reduce(flat, "sum")
    out, off = list(grads), 0
    for i in whole:
        g = grads[i]
        out[i] = flat[off:off + g.numel()].reshape(g.shape).to(g.dtype)
        off += g.numel()
    return out


# ---------------------------------------------------------------------------
# Staging ring
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RingState:
    """Fixed slot buffers and their metadata, all tensors."""

    slots: Dict[str, torch.Tensor]   # each [n_slots, ...]
    keys: torch.Tensor               # [n_slots] int32 address, -1 = empty
    head: torch.Tensor               # 0-d int32: next write position
    count: torch.Tensor              # 0-d int32: occupied slots


def ring_init(n_slots: int, item: Dict[str, torch.Tensor]) -> RingState:
    """A fresh ring of ``n_slots`` zeroed slots shaped like ``item``'s
    tensors (on their device)."""
    dev = next(iter(item.values())).device
    slots = {k: torch.zeros((n_slots,) + tuple(t.shape), dtype=t.dtype,
                            device=t.device) for k, t in item.items()}
    i32 = dict(dtype=torch.int32, device=dev)
    return RingState(slots=slots, keys=torch.full((n_slots,), -1, **i32),
                     head=torch.zeros((), **i32),
                     count=torch.zeros((), **i32))


def ring_write(state: RingState, key, item: Dict[str, torch.Tensor]
               ) -> RingState:
    """Fire-and-forget store: an O(1) write at the head (a stack push)."""
    i = state.head.long()
    slots = {}
    for k, buf in state.slots.items():
        buf = buf.clone()
        buf[i] = item[k].to(buf.dtype).reshape(buf.shape[1:])
        slots[k] = buf
    keys = state.keys.clone()
    keys[i] = torch.as_tensor(key, dtype=torch.int32, device=keys.device)
    n = keys.shape[0]
    return RingState(slots=slots, keys=keys,
                     head=torch.remainder(state.head + 1, n).to(torch.int32),
                     count=torch.clamp(state.count + 1, max=n).to(
                         torch.int32))


def ring_lookup(state: RingState, key) -> Tuple[torch.Tensor, torch.Tensor]:
    """The staging-index probe: (hit, slot). The latest write wins."""
    key = torch.as_tensor(key, dtype=torch.int32, device=state.keys.device)
    matches = state.keys == key
    n = state.keys.shape[0]
    # recency rank: distance behind the head (smaller = newer)
    age = torch.remainder(state.head - 1 - torch.arange(
        n, device=state.keys.device), n)
    slot = torch.argmin(torch.where(matches, age, n + 1))
    return matches.any(), slot


def read_through(state: RingState, key,
                 backing: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The read path: the staging ring first, else the backing value."""
    hit, slot = ring_lookup(state, key)
    return {k: torch.where(hit, state.slots[k][slot].to(b.dtype), b)
            for k, b in backing.items()}


def ring_occupancy(state: RingState) -> torch.Tensor:
    """The ring's fill fraction in [0, 1] (the QoS occupancy signal)."""
    return state.count.float() / state.keys.shape[0]


# ---------------------------------------------------------------------------
# Host-side flusher (between steps)
# ---------------------------------------------------------------------------


class StagingFlusher:
    """Drains staged items to the backing tier between steps.

    The sink is a callable (e.g. checkpointer write, host-memory pool
    insert). Flushing is suppressed while DevLoad >= MODERATE, mirroring the
    controller's divert-on-congestion behaviour; suspended writes are kept
    (the ring keeps absorbing) and resumed when load drops — reads remain
    correct throughout because of ``read_through``.

    ``admit`` is the endpoint-side half of the same discipline: when the
    backing tier is a simulated CXL EP (``repro.core.tier.CxlTier``), the
    device pre-announces internal tasks / congestion through it and the
    flush window stays shut until the EP recovers (``deferred`` counts
    those windows); staged items keep absorbing meanwhile.
    """

    def __init__(self, sink: Callable[[int, Any], None],
                 qos: Optional[QoSController] = None,
                 admit: Optional[Callable[[], bool]] = None):
        self.sink = sink
        self.qos = qos or QoSController()
        self.admit = admit
        self.pending: List[Tuple[int, Any]] = []
        self.flushed = 0
        self.suppressed = 0
        self.deferred = 0

    def stage(self, key: int, value: Any) -> None:
        """Park one item for the next admitted flush window."""
        self.pending.append((key, value))

    def maybe_flush(self) -> int:
        """Drain pending items to the sink if QoS + admission allow;
        returns how many items were flushed (0 on a closed window)."""
        if not self.qos.flush_enabled:
            self.suppressed += 1
            return 0
        if self.pending and self.admit is not None and not self.admit():
            self.deferred += 1
            return 0
        n = len(self.pending)
        for key, value in self.pending:
            self.sink(key, value)
        self.pending.clear()
        self.flushed += n
        return n
