"""Sharding over the ranks of a mesh: the parameters by the reference's
rules (``repro.parallel.sharding``: ``_RULES``, ``AXIS_SIZES``,
``_divisible``, ``spec_for``, ``param_specs``), the POOL tier's FSDP
gathers, and the slot and page axes of the paged KV cache (the
reference's ``models.model.decode_axes`` / ``cache_specs``).

A spec is a tuple with one entry per axis of a leaf -- ``"model"``, the
FSDP axis (``"data"``, or ``("pod", "data")`` with ``multi_pod_fsdp``)
or None -- in place of the reference's ``PartitionSpec``, resolved for
the port's per-layer leaves (the reference's specs without their leading
stacked axes). ``shard_params`` cuts each leaf on its ``"model"`` axis,
model rank m taking the contiguous ``[m n/N, (m+1) n/N)`` of it, then on
its FSDP axis, FSDP rank f of F taking the contiguous 1/F of that: the
POOL tier's placement, on which a layer is gathered before use
(``FsdpRead``, the speculative read's load; in training ``gather_train``,
whose backward returns each gathered leaf's gradient to its shard through
the deterministic store's reduce-scatter). The divisibility guard tests
the production axis sizes, not the mesh's, as the reference's does, so a
leaf that 16 does not divide stays whole on that axis (granite's
vocabulary of 49155; smoke granite's 8 experts, which ``models.moe``'s
expert-parallel forms split themselves, as the reference's ``shard_map``
does).

The reference's ``cache_specs`` puts the batch axes (data, or pod and
data) on the slot axis of every leaf and the model axis on the page axis
of every paged leaf: the pages [L, B, P, page, Hkv, D] and the int8
scales [L, B, P, Hkv] alike, so model rank m holds pages ``[m P/N, (m+1)
P/N)`` with their scales and a contiguous token range of every slot it
holds. With one slot the batch is not split: the pages spread over the
data and model axes together (``decode_axes``' batch-1 branch).
"""
from __future__ import annotations

import collections
import copy
import math
import re
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

Spec = Tuple[Optional[str], ...]

# the page axis of a cache "kv" leaf [L, B, P, ...] and of one layer's
# leaf [B, P, ...]
PAGE_AXIS, LAYER_PAGE_AXIS = 2, 1
# the batch (slot) axis of each cache leaf ("kv" leaves: 1)
CACHE_BATCH_AXIS = {"pos": 0, "h": 2, "conv": 2, "cross_k": 1,
                    "cross_v": 1, "mC": 2, "mn": 2, "mm": 2, "mconv": 2,
                    "sh": 1, "sc": 1, "sn": 1, "sm": 1, "sconv": 1}
# on a module of a POOL-tier shard: {parameter name: its FSDP axis}
FSDP_ATTR = "_fsdp_axes"
# on a HOST-tier tensor: the device it is copied onto for use
HOST_TARGET = "_hdm_streams_to"
# while a list: ("issue" | "wait", label) of every HostRead's copies
HOST_TRACE: Optional[List] = None
# bytes the HOST tier has copied onto ("h2d") and off ("d2h") the card
HOST_COPIED = {"h2d": 0, "d2h": 0}

# (regex over param path, spec WITHOUT the leading layer-stack axis)
# "F" marks the FSDP-shardable axis (replaced by fsdp axis for POOL tier,
# None for DEVICE tier). "M" is the tensor-parallel axis.
_RULES = [
    # embeddings
    (r"embedding$",            ("M", "F")),
    (r"unembed$",              ("F", "M")),
    # attention
    (r"\bwq$|\bwk$|\bwv$",     ("F", "M")),
    (r"\bwo$",                 ("M", "F")),
    (r"q_norm$|k_norm$",       (None,)),
    # dense mlp
    (r"w_gate$|w_up$",         ("F", "M")),
    (r"w_down$",               ("M", "F")),
    # moe
    (r"router$",               ("F", None)),
    (r"e_gate$|e_up$",         ("M", "F", None)),
    (r"e_down$",               ("M", None, "F")),
    # mamba2
    (r"in_proj$",              ("F", "M")),
    (r"out_proj$",             ("M", "F")),
    (r"conv_w$",               (None, "M")),
    (r"A_log$|\bD$|dt_bias$",  ("M",)),
    # xlstm (mLSTM / sLSTM)
    (r"w_up1$|w_up2$|w_qkv$|w_gates$",  ("F", "M")),
    (r"w_down2$|w_out$",       ("M", "F")),
    (r"r_gates$",              ("M", None, None)),
    # vlm cross-attention follows attention rules (same names)
    # norms / scalars / gates
    (r"scale$|bias$|gate$",    (None,)),
]

# production mesh axis sizes — the divisibility guard below drops a mesh
# axis from a dim it does not divide (e.g. granite's vocab 49155 % 16 != 0,
# xlstm's 2*nh gate dim). Guarding against the production sizes keeps the
# specs identical between smoke (1x1) and production (16x16 / 2x16x16)
# meshes.
AXIS_SIZES = {"pod": 2, "data": 16, "model": 16}


def _divisible(axes, dim: int) -> bool:
    if axes is None:
        return True
    group = axes if isinstance(axes, tuple) else (axes,)
    n = 1
    for a in group:
        n *= AXIS_SIZES.get(a, 1)
    return dim % n == 0


def spec_for(path_str: str, shape, *, fsdp_axis, stacked: bool) -> Spec:
    """Resolve the spec for one param leaf."""
    ndim = len(shape)
    for pat, spec in _RULES:
        if re.search(pat, path_str):
            out = []
            for s in spec:
                if s == "F":
                    out.append(fsdp_axis)
                elif s == "M":
                    out.append("model")
                else:
                    out.append(None)
            # normalize to actual rank (norm scales etc. may be rank-1)
            base = len(out)
            eff_ndim = ndim - (1 if stacked else 0)
            if eff_ndim < base:
                out = out[-eff_ndim:] if eff_ndim > 0 else []
            elif eff_ndim > base:
                out = [None] * (eff_ndim - base) + out
            if stacked:
                out = [None] + out
            out = [a if _divisible(a, shape[i]) else None
                   for i, a in enumerate(out)]
            return tuple(out)
    # default: replicate
    return (None,) * ndim


# the port's module path (its leading name) -> the reference's path and
# the number of stacked index levels the port's name carries there
_STACKED = {"blocks": ("blocks", 1), "groups": ("groups", 2),
            "self_blocks": ("groups/self_blocks", 2),
            "cross": ("groups/cross", 1), "mlstm": ("groups/mlstm", 2),
            "slstm": ("groups/slstm", 1)}


def ref_path(name: str) -> Tuple[str, int]:
    """A port parameter name (``model.named_parameters()``:
    ``"blocks.3.attn.wq"``) as the reference's pytree path
    (``"blocks/attn/wq"``) and the stacked axes the reference's leaf has
    in front of the port's (the layer index, or group and layer)."""
    parts = name.split(".")
    head, n_idx = _STACKED.get(parts[0], (parts[0], 0))
    return "/".join([head] + parts[1 + n_idx:]), n_idx


def param_specs(params: nn.Module, *, tier: str = "pool",
                multi_pod_fsdp: bool = False) -> Dict[str, Spec]:
    """``{name: spec}`` for every parameter of the port's model: the
    reference's ``param_specs(..., tier, multi_pod_fsdp)`` of the same
    leaf, without its stacked axes. ``tier`` "device" has no FSDP axis;
    "pool" / "host" put "data" there, or ("pod", "data") with
    ``multi_pod_fsdp``."""
    fsdp_axis = None
    if tier in ("pool", "host"):
        fsdp_axis = ("pod", "data") if multi_pod_fsdp else "data"
    return {name: spec_for(ref_path(name)[0], tuple(p.shape),
                           fsdp_axis=fsdp_axis, stacked=False)
            for name, p in params.named_parameters()}


def _owner(root: nn.Module, name: str) -> Tuple[nn.Module, str]:
    *path, attr = name.split(".")
    mod = root
    for part in path:
        mod = getattr(mod, part)
    return mod, attr


def _fsdp_axis(spec: Spec) -> Optional[int]:
    """The axis of ``spec`` that carries the FSDP axis, if any."""
    for i, a in enumerate(spec):
        if a == "data" or (isinstance(a, tuple) and "data" in a):
            return i
    return None


def shard_params(params: nn.Module, rank: int, n_ranks: int,
                 specs: Optional[Dict[str, Spec]] = None, *,
                 fsdp: Tuple[int, int] = (0, 1)) -> nn.Module:
    """Rank ``rank``'s (of ``n_ranks`` on the model axis) shard of the
    whole ``params``: a new model whose leaves with a ``"model"`` axis in
    their spec (``param_specs`` of the whole model, or ``specs``) hold the
    rank's contiguous 1/N of that axis in new tensors; with ``fsdp = (f,
    F)``, F > 1, the leaves whose spec has an FSDP axis then hold FSDP
    rank f's contiguous 1/F of it, each owning module listing them under
    ``FSDP_ATTR`` (the POOL tier). Every other leaf is the same tensor as
    in ``params``, which is left whole. The result carries ``shard =
    (rank, n_ranks)``, or ``(rank, n_ranks, f, F)`` with FSDP shards."""
    if specs is None:
        specs = param_specs(params)
    f_rank, f_size = fsdp
    shared = {id(p): p for p in params.parameters()}
    out = copy.deepcopy(params, memo=shared)
    for name, p in params.named_parameters():
        spec = specs[name]
        cut = p.detach()
        if "model" in spec:
            axis = spec.index("model")
            n = p.shape[axis] // n_ranks
            cut = cut.narrow(axis, rank * n, n)
        f_axis = _fsdp_axis(spec) if f_size > 1 else None
        if f_axis is not None:
            if cut.shape[f_axis] % f_size:
                raise ValueError(f"{name}: axis {f_axis} of {tuple(cut.shape)}"
                                 f" does not split over {f_size} FSDP ranks")
            n = cut.shape[f_axis] // f_size
            cut = cut.narrow(f_axis, f_rank * n, n)
        if "model" not in spec and f_axis is None:
            continue
        mod, attr = _owner(out, name)
        setattr(mod, attr, nn.Parameter(cut.clone(), requires_grad=False))
        if f_axis is not None:
            mod.__dict__.setdefault(FSDP_ATTR, {})[attr] = f_axis
    out.shard = (rank, n_ranks) if f_size == 1 else (rank, n_ranks, f_rank,
                                                     f_size)
    out.specs = dict(specs)
    return out


def _pool_leaves(unit) -> List[Tuple[nn.Module, str, int]]:
    """(module, parameter name, FSDP axis) of every POOL-tier leaf of a
    layer, a model, or a tuple of them."""
    roots = unit if isinstance(unit, tuple) else (unit,)
    return [(mod, attr, axis) for root in roots for mod in root.modules()
            for attr, axis in mod.__dict__.get(FSDP_ATTR, {}).items()]


def fsdp_axes(params: nn.Module) -> List[Optional[int]]:
    """The FSDP axis of each of ``params.parameters()`` (a POOL-tier
    shard), None for a leaf held whole."""
    by_id = {id(mod._parameters[attr]): axis
             for mod, attr, axis in _pool_leaves(params)}
    return [by_id.get(id(p)) for p in params.parameters()]


def _twin(mod: nn.Module, got: Dict, keep_fsdp: bool = False) -> nn.Module:
    """A structural copy of ``mod`` (its own module and parameter dicts;
    the same tensors) with the gathered leaves ``got`` in place of its
    shards and no FSDP leaves left (with ``keep_fsdp``, still marked)."""
    new = object.__new__(type(mod))
    new.__dict__ = dict(mod.__dict__)
    if not keep_fsdp:
        new.__dict__.pop(FSDP_ATTR, None)
    new._parameters = {k: got.get((id(mod), k), p)
                       for k, p in mod._parameters.items()}
    new._modules = {k: None if m is None else _twin(m, got, keep_fsdp)
                    for k, m in mod._modules.items()}
    return new


class _Gathers:
    """The all-gathers of ``tensors`` (FSDP shards, each along its axis of
    ``axes``) over ``group``, issued at construction without waiting; the
    leaves travel packed as bytes, one ``all_gather`` per piece: with
    ``granularity`` g, a leaf whose first axis g divides goes in g
    contiguous pieces along it, one to each gather (the reference's
    ``gather_leaf``), any other leaf in the first."""

    def __init__(self, tensors, axes, group, granularity: int = 1):
        self.tensors, self.axes = tensors, axes
        self.gathers = []
        g = max(1, int(granularity))
        pieces: List[List] = [[] for _ in range(g)]
        for i, t in enumerate(tensors):
            if g > 1 and t.ndim and t.shape[0] % g == 0:
                for j, c in enumerate(t.chunk(g, 0)):
                    pieces[j].append((i, c))
            else:
                pieces[0].append((i, t))
        for items in pieces:
            if items:
                flat = torch.cat([c.contiguous().reshape(-1).view(torch.uint8)
                                  for _, c in items])
                self.gathers.append((items, group.all_gather_async(flat)))

    def wait(self) -> List[torch.Tensor]:
        """Every leaf whole along its FSDP axis, in new tensors."""
        parts = collections.defaultdict(list)
        for items, pending in self.gathers:
            recv = pending.wait()                     # [F, nbytes] uint8
            off = 0
            for i, c in items:
                nb = c.numel() * c.element_size()
                parts[i].append(recv[:, off:off + nb].contiguous()
                                .view(c.dtype).reshape((-1,) + c.shape))
                off += nb
        out = []
        for i, axis in enumerate(self.axes):
            shards = torch.cat(parts[i], dim=1)       # [F, *shard]
            shape = list(shards.shape[1:])
            shape[axis] *= shards.shape[0]
            out.append(shards.movedim(0, axis).reshape(shape))
        return out


def _with_leaves(unit, leaves, tensors):
    """``unit`` (a layer, a model or a tuple of them) as a structural twin
    with ``tensors`` in place of its POOL-tier ``leaves``."""
    return _with_got(unit, {(id(mod), attr): t for (mod, attr, _), t
                            in zip(leaves, tensors)})


def _with_got(unit, got, keep_fsdp: bool = False):
    """``unit`` as a structural twin with ``got[(id(module), name)]`` in
    place of those leaves and no FSDP leaves left (with ``keep_fsdp``,
    its FSDP leaves still marked)."""
    if isinstance(unit, tuple):
        return tuple(_twin(m, got, keep_fsdp) for m in unit)
    out = _twin(unit, got, keep_fsdp)
    if not keep_fsdp and len(getattr(unit, "shard", ())) == 4:
        out.shard = unit.shard[:2]
    return out


class FsdpRead:
    """The gathers of one layer's (or model's, or tuple of layers') POOL-
    tier leaves over the FSDP ``group``, issued at construction without
    waiting: ``wait()`` returns the unit with every FSDP axis whole, the
    leaves in new tensors (the shards they came from are left as they
    are), gathered in ``granularity`` pieces (``_Gathers``). Without a
    group of more than one rank, or without FSDP leaves, nothing is
    gathered and ``wait()`` returns the unit itself. No gradient flows
    through it: the serving steps' read (``gather_train`` is training's).
    A unit with HOST-tier leaves is copied onto the card first: the copies
    (``HostRead``) are issued at construction, the gathers of the copied
    shards in ``wait()``."""

    def __init__(self, unit, group=None, granularity: int = 1, label=None):
        self.unit, self.group, self.granularity = unit, group, granularity
        self.copy = HostRead(unit, label) if on_host(unit) else None
        self.pending = None if self.copy else self._gather(unit)

    def _gather(self, unit):
        self.leaves = (_pool_leaves(unit) if self.group is not None
                       and self.group.size > 1 else [])
        return _Gathers(
            [mod._parameters[attr].detach() for mod, attr, _ in self.leaves],
            [axis for *_, axis in self.leaves], self.group, self.granularity)

    def wait(self):
        unit = self.unit
        if self.copy:
            unit = self.copy.wait()
            self.pending = self._gather(unit)
        if not self.leaves:
            return unit
        return _with_leaves(unit, self.leaves, self.pending.wait())


def gather_fsdp(params, group, granularity: int = 1):
    """``params`` (a POOL-tier shard, or one layer of it) with every FSDP
    axis gathered over ``group``: exactly the leaves ``shard_params``
    cut, put back together."""
    return FsdpRead(params, group, granularity).wait()


def host_target(t: torch.Tensor) -> Optional[torch.device]:
    """The device a HOST-tier tensor (``core.hdm.host_empty``) is copied
    onto for use (None: not on the HOST tier)."""
    return getattr(t, HOST_TARGET, None)


def _host_leaves(unit) -> List[Tuple[nn.Module, str, torch.Tensor]]:
    """(module, parameter name, tensor) of every HOST-tier leaf of a
    layer, a model, or a tuple of them (none for a plain tensor)."""
    roots = unit if isinstance(unit, tuple) else (unit,)
    if not all(isinstance(r, nn.Module) for r in roots):
        return []
    return [(mod, attr, p) for root in roots for mod in root.modules()
            for attr, p in mod._parameters.items()
            if p is not None and host_target(p) is not None]


def on_host(unit) -> bool:
    """Whether a unit has leaves on the HOST tier."""
    return bool(_host_leaves(unit))


_COPY_STREAMS: Dict = {}


def copy_stream(device: torch.device, kind: str = "h2d"):
    """The side stream of ``kind`` ("h2d" or "d2h") that the HOST tier's
    copies to or from ``device`` run on, one per device."""
    key = (kind, device.index)
    if key not in _COPY_STREAMS:
        _COPY_STREAMS[key] = torch.cuda.Stream(device)
    return _COPY_STREAMS[key]


def _trace(event: str, label) -> None:
    if HOST_TRACE is not None:
        HOST_TRACE.append((event, label))


class HostRead:
    """The copy of a unit's (a layer's, a model's or a tuple's) HOST-tier
    leaves onto their card, issued at construction without waiting: on a
    side stream, after the work already queued on the current one, into
    fresh card tensors (``record_stream`` keeps the allocator from handing
    them out while the copy runs). A host leaf that is not pinned raises:
    a copy from pageable memory would run in line. On the CPU the copies
    are clones. ``copies()`` makes the current stream wait for them and
    hands them over (once); ``wait()`` returns the unit's card twin, the
    copies in place of its host leaves and its FSDP axes kept, which
    ``FsdpRead`` and ``gather_train`` then gather as a POOL unit. Each read
    is recorded in ``HOST_TRACE`` (while it is a list) as ``("issue",
    label)`` and ``("wait", label)``."""

    def __init__(self, unit, label=None):
        self.unit, self.label = unit, label
        self.leaves = _host_leaves(unit)
        self.params, self.index = [], {}
        for _, _, p in self.leaves:
            if id(p) not in self.index:
                self.index[id(p)] = len(self.params)
                self.params.append(p)
        _trace("issue", label)
        self.pending, self.event = _issue_copies(self.params)

    def copies(self) -> List[torch.Tensor]:
        """The card copies of ``self.params``, once the current stream
        waits for them; a read is taken once."""
        if self.event is not None:
            torch.cuda.current_stream(self.pending[0].device).wait_event(
                self.event)
        _trace("wait", self.label)
        out, self.pending = self.pending, None
        return out

    def wait(self):
        return self.twin(self.copies())

    def twin(self, copies):
        """The unit with ``copies`` (aligned with ``self.params``) in
        place of its host leaves, its FSDP axes kept."""
        return _with_got(self.unit, {
            (id(mod), attr): copies[self.index[id(p)]]
            for mod, attr, p in self.leaves}, keep_fsdp=True)


def _issue_copies(params: List[torch.Tensor]):
    """(card copies of the host ``params``, the event their copy records)
    -- clones and no event on the CPU."""
    device = host_target(params[0])
    if device.type != "cuda":
        return [p.detach().clone() for p in params], None
    cur = torch.cuda.current_stream(device)
    side = copy_stream(device)
    dst = [torch.empty(p.shape, dtype=p.dtype, device=device)
           for p in params]
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        for p, d in zip(params, dst):
            if not p.is_pinned():
                raise RuntimeError("a HOST-tier leaf is not in pinned "
                                   "memory: its copy would run in line")
            d.copy_(p.detach(), non_blocking=True)
            HOST_COPIED["h2d"] += p.numel() * p.element_size()
    for d in dst:
        d.record_stream(side)
    event = torch.cuda.Event()
    event.record(side)
    return dst, event


class HostGrads:
    """The card gradients of a step's HOST-tier leaves, which autograd
    cannot hand to a leaf on the host: ``_CopyFn``'s backward adds each
    leaf's (its shard's, on a group) under the leaf; ``pop(p)`` returns it
    (None if the loss did not reach ``p``)."""

    def __init__(self):
        self.grads: Dict[int, torch.Tensor] = {}

    def add(self, key: int, g: torch.Tensor) -> None:
        self.grads[key] = g if key not in self.grads else self.grads[key] + g

    def pop(self, p: torch.Tensor) -> Optional[torch.Tensor]:
        return self.grads.pop(id(p), None)


class _CopyFn(torch.autograd.Function):
    """HOST-tier leaves -> their card copies (a ``HostRead``'s); backward:
    each copy's gradient, in the leaf's dtype and shape (reduced to this
    rank's shard by ``_GatherFn`` first, where the leaf is gathered),
    handed to the step's ``HostGrads`` ``sink``. No gradient flows to the
    host leaves themselves: autograd refuses a card gradient for a leaf on
    the host."""

    @staticmethod
    def forward(ctx, sink, read, *leaves):
        ctx.sink, ctx.keys = sink, [id(p) for p in leaves]
        return tuple(read.copies())

    @staticmethod
    def backward(ctx, *grads):
        for k, g in zip(ctx.keys, grads):
            ctx.sink.add(k, g)
        return (None, None) + (None,) * len(grads)


def _pack_shard_grads(grads, axes, n: int) -> torch.Tensor:
    """Whole-leaf gradients as one f32 buffer [n, total]: row f holds
    every leaf's f-th contiguous 1/n along its FSDP axis (of ``axes``),
    flattened, leaf after leaf -- what FSDP rank f of n keeps."""
    rows = []
    for g, axis in zip(grads, axes):
        shape = tuple(g.shape)
        rows.append(g.float().reshape(
            shape[:axis] + (n, shape[axis] // n) + shape[axis + 1:])
            .movedim(axis, 0).reshape(n, -1))
    return torch.cat(rows, dim=1)


def _unpack_shard_grads(flat: torch.Tensor, metas) -> List[torch.Tensor]:
    """One rank's row of ``_pack_shard_grads`` ([total]) as tensors of the
    shards' ``metas`` (shape, dtype)."""
    out, off = [], 0
    for shape, dtype in metas:
        n = math.prod(shape)
        out.append(flat[off:off + n].reshape(shape).to(dtype))
        off += n
    return out


class _GatherFn(torch.autograd.Function):
    """FSDP shards -> whole leaves (the gather of ``_Gathers``); backward:
    the whole leaves' gradients -> this rank's shards, reduced over the
    group by the deterministic store's ``reducer`` (a reduce-scatter, or
    an all-reduce then this rank's slice). The sum is taken in f32 and
    cast once to each shard's dtype, as ``product_f32`` sums row-parallel
    products: a bf16 sum of the ranks' bf16 gradients would round once
    more per rank than one rank's gradient does."""

    @staticmethod
    def forward(ctx, spec, *shards):
        group, axes, granularity, reducer, key = spec
        ctx.spec = spec
        ctx.shapes = [(t.shape, t.dtype) for t in shards]
        return tuple(_Gathers(list(shards), axes, group, granularity).wait())

    @staticmethod
    def backward(ctx, *grads):
        group, axes, _, reducer, key = ctx.spec
        buf = _pack_shard_grads(grads, axes, group.size)
        mine = reducer.reduce(buf, key)
        return (None, *_unpack_shard_grads(mine, ctx.shapes))


def gather_train(unit, group, granularity: int, reducer, *, read=None,
                 sink: Optional[HostGrads] = None):
    """``unit`` with its FSDP axes gathered over ``group`` as in
    ``FsdpRead``, differentiably: the gradient of each gathered leaf
    returns to its shard through ``reducer`` (the step's
    ``core.deterministic_store.GradReducer``), one reduction for the
    unit. Without a group of more than one rank, or without FSDP leaves,
    the unit itself (``reducer`` may then be None). A unit on the HOST
    tier is copied onto the card first (``read``, a ``HostRead`` of it
    issued ahead, else one now, through ``_CopyFn``), then gathered as a
    POOL unit; its card gradients go to ``sink`` (``HostGrads``), not to
    the host leaves."""
    leaves = (_pool_leaves(unit)
              if group is not None and group.size > 1 else [])
    # the reducer's key names the unit's own modules, not a twin's
    key = tuple((id(mod), attr) for mod, attr, _ in leaves)
    if on_host(unit):
        if sink is None:
            raise ValueError("a HOST-tier unit in training needs the "
                             "step's HostGrads")
        read = read if read is not None else HostRead(unit)
        unit = read.twin(list(_CopyFn.apply(sink, read, *read.params)))
        leaves = (_pool_leaves(unit) if leaves else [])
    if not leaves:
        return unit
    if reducer is None:
        raise ValueError(f"gather_train over {group.size} ranks needs the "
                         f"step's GradReducer")
    spec = (group, [axis for *_, axis in leaves], granularity, reducer, key)
    whole = _GatherFn.apply(spec, *[mod._parameters[attr]
                                    for mod, attr, _ in leaves])
    return _with_leaves(unit, leaves, whole)


class _RowsFn(torch.autograd.Function):
    """Every rank's rows of ``x`` stacked in rank order along axis 0;
    backward: the sum over the ranks of the gradient's rows of this rank
    (a reduce-scatter in f32, cast back to the gradient's dtype)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return group.all_gather(x).reshape((-1,) + x.shape[1:])

    @staticmethod
    def backward(ctx, grad):
        return None, ctx.group.reduce_scatter(grad.float(), 0).to(grad.dtype)


def gather_rows(group, x: torch.Tensor) -> torch.Tensor:
    """``x`` [b, ...] of every rank of ``group`` as [size b, ...], rank
    order, differentiably (``_RowsFn``); ``x`` itself on one rank."""
    if group is None or group.size == 1:
        return x
    return _RowsFn.apply(group, x)


class _MeanFn(torch.autograd.Function):
    """The mean of a scalar over the ranks (a sum all-reduce in f32 over
    the group's size); backward: this rank's share, ``grad / size`` --
    the ranks' gradients then sum to the mean's."""

    @staticmethod
    def forward(ctx, group, t):
        ctx.size = group.size
        total = group.all_reduce(t.detach().float().clone(), "sum")
        return (total / group.size).to(t.dtype)

    @staticmethod
    def backward(ctx, grad):
        return None, grad / ctx.size


def mean_over(group, t: torch.Tensor) -> torch.Tensor:
    """The mean of the scalar ``t`` over ``group``'s ranks, each rank's
    gradient its 1/size share; ``t`` itself on one rank."""
    if group is None or group.size == 1:
        return t
    return _MeanFn.apply(group, t)


# ------------------------------------------------ the model axis in training
#
# Training splits each block over the model axis as Megatron does: the
# activations between blocks whole (and equal) on every model rank, each
# rank computing its own heads, d_ff columns and experts. Every rank then
# holds the same loss, and the gradient of an activation held whole is
# complete on each rank; inside a block a rank's gradients are its share.
# Five differentiable collectives join the two (each a no-op on one rank;
# every sum in f32, in rank order, ``RankGroup.sum_ranked``):
#
#  * ``copy_in``: identity forward, sum backward -- at the input of a
#    column-parallel product, and on a whole leaf that a rank uses for
#    its own share of the work (the router on its tokens, a q/k norm on
#    its heads, a whole ``wk`` sliced to its kv heads);
#  * ``reduce_out``: sum forward (cast once), identity backward -- after a
#    row-parallel product, and where each rank holds some of the terms
#    (a vocabulary-split lookup, the cross-entropy's sums);
#  * ``all_sum``: sum forward and backward -- a statistic every rank
#    uses for its own share (the split RMSNorm's squares);
#  * ``gather_cols``: all-gather forward; backward this rank's slice of
#    the gradient where the gathered tensor's use is whole on every rank
#    (``"own"``), else the slice of the gradient summed over the ranks
#    (``"sum"``);
#  * ``all_to_all_grad``: the tiled ``all_to_all``, whose backward is the
#    ``all_to_all`` of the gradient (the expert-parallel MoE's dispatch).
#
# The serving collectives (``reduce_sum``, ``gather_columns``, the uint8
# ``all_gather``) cut or miss the graph: autograd sees an all-reduce in
# place as an identity and a gather through bytes as a constant.


def _grouped(group) -> bool:
    return group is not None and group.size > 1


class _CopyInFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.group.sum_ranked(g).to(g.dtype)


class _ReduceOutFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x, dtype):
        ctx.dtype = x.dtype
        return group.sum_ranked(x).to(dtype)

    @staticmethod
    def backward(ctx, g):
        return None, g.to(ctx.dtype), None


class _AllSumFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return group.sum_ranked(x).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.group.sum_ranked(g).to(g.dtype)


class _GatherColsFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x, dim, grad):
        ctx.group, ctx.dim, ctx.grad, ctx.n = group, dim, grad, x.shape[dim]
        return torch.cat(list(group.all_gather(x)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        group, dim, n = ctx.group, ctx.dim, ctx.n
        if ctx.grad == "sum":
            g = group.sum_ranked(g).to(g.dtype)
        return None, g.narrow(dim, group.rank * n, n).contiguous(), None, None


class _AllToAllFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x, *riders):
        ctx.group = group
        n = group.size
        parts = [x] + list(riders)
        msg = torch.cat([p.contiguous().view(torch.uint8).reshape(n, -1)
                         for p in parts], dim=1)
        got = group.all_to_all(msg)
        out, at = [], 0
        for p in parts:
            nb = p[0].numel() * p.element_size()
            out.append(got[:, at:at + nb].contiguous().view(p.dtype)
                       .view(p.shape))
            at += nb
        if riders:
            ctx.mark_non_differentiable(*out[1:])
        return tuple(out) if riders else out[0]

    @staticmethod
    def backward(ctx, g, *_):
        return (None, ctx.group.all_to_all(g.contiguous()),
                *([None] * len(_)))


def copy_in(group, x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is; its gradient summed over ``group`` (f32, rank
    order)."""
    return _CopyInFn.apply(group, x) if _grouped(group) else x


def reduce_out(group, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """The ranks' partial terms ``x`` summed in f32 and cast once to
    ``dtype`` (default ``x``'s); the gradient passes to each rank's
    ``x`` as it is."""
    if not _grouped(group):
        return x.to(dtype or x.dtype)
    return _ReduceOutFn.apply(group, x, dtype or x.dtype)


def all_sum(group, x: torch.Tensor) -> torch.Tensor:
    """The sum of the ranks' ``x`` (f32, rank order), each rank using it
    for its own share: its gradient summed over the ranks too."""
    return _AllSumFn.apply(group, x) if _grouped(group) else x


def gather_cols(group, x: torch.Tensor, dim: int = -1,
                grad: str = "own") -> torch.Tensor:
    """The ranks' parts ``x`` concatenated along ``dim`` in rank order;
    backward this rank's part of the gradient (``grad="own"``: the use is
    whole on every rank) or of its sum over the ranks (``"sum"``: each
    rank's gradient is its share)."""
    if not _grouped(group):
        return x
    return _GatherColsFn.apply(group, x, dim % x.ndim, grad)


def all_to_all_grad(group, x: torch.Tensor, *riders):
    """``RankGroup.all_to_all`` of ``x`` [size, ...], differentiably (its
    backward the ``all_to_all`` of the gradient); ``riders`` ([size, ...]
    tensors without gradient, the MoE's expert ids) travel in the same
    message. Returns ``x``'s result, or a tuple with the riders'."""
    if not _grouped(group):
        return (x, *riders) if riders else x
    return _AllToAllFn.apply(group, x, *riders)


def check_pages(n_pages: int, n_ranks: int, max_seq: int,
                kv_page_size: int) -> None:
    """The reference engine's construction-time check
    (``repro.serving.engine``): the page axis must divide by the ranks."""
    if n_pages % n_ranks:
        raise ValueError(
            f"sharded decode needs the page axis divisible by the model "
            f"axis: {n_pages} pages (max_seq={max_seq}, kv_page_size="
            f"{kv_page_size}) % {n_ranks} ranks != 0 — lower kv_page_size "
            f"or adjust max_seq")


def page_range(n_pages: int, rank: int, n_ranks: int) -> Tuple[int, int]:
    """The pages ``[lo, hi)`` of ``n_pages`` that ``rank`` holds."""
    per = n_pages // n_ranks
    return rank * per, (rank + 1) * per


def shard_cache(cache: Dict, rank: int, n_ranks: int,
                rows: Tuple[int, int] = (0, 1)) -> Dict:
    """``cache`` cut to one rank's part (new, contiguous tensors): with
    ``rows = (r, R)``, R > 1, every leaf to slot row r's contiguous 1/R of
    the slots (along its own batch axis, ``CACHE_BATCH_AXIS``), then
    every "kv" leaf to ``rank``'s pages of ``n_ranks``. The other leaves
    (``pos``, the recurrent states, the vision K/V) are not cut on pages,
    as the reference's ``cache_specs`` leaves them whole on the model
    axis. A cache without pages (xLSTM) is cut on slots only."""
    out = dict(cache)
    row, n_rows = rows
    if n_rows > 1:
        b = cache["pos"].shape[0]
        if b % n_rows:
            raise ValueError(f"{b} slots do not split over {n_rows} rows")
        per = b // n_rows
        for name, a in cache.items():
            if name == "kv":
                out["kv"] = {n: t.narrow(1, row * per, per)
                             for n, t in a.items()}
            else:
                out[name] = a.narrow(CACHE_BATCH_AXIS[name], row * per,
                                     per).clone()
    if "kv" not in cache:
        return out
    n_pages = next(iter(out["kv"].values())).shape[PAGE_AXIS]
    lo, hi = page_range(n_pages, rank, n_ranks)
    out["kv"] = {name: t.narrow(PAGE_AXIS, lo, hi - lo).clone()
                 for name, t in out["kv"].items()}
    return out


def gather_pages(group, kv: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """One layer's leaves ([B, P/N, ...] on each rank) gathered whole:
    [B, P, ...] on every rank, pages in rank order."""
    out = {}
    for name, t in kv.items():
        parts = group.all_gather(t)                      # [N, B, P/N, ...]
        out[name] = torch.cat(list(parts), dim=LAYER_PAGE_AXIS)
    return out


def gather_columns(group, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """A column-parallel product ([..., n/N] on each rank) put together:
    [..., n] on every rank, columns in rank order (or the parts along
    ``dim``: a state split on its heads)."""
    return torch.cat(list(group.all_gather(t)), dim=dim)


def whole_columns(group, t: torch.Tensor, width: int) -> torch.Tensor:
    """``t``, a product over a weight that may be split on its columns:
    gathered to its ``width`` columns where it is short of them (the
    weight split over the rank ``group``), else as it is."""
    if group is None or t.shape[-1] == width:
        return t
    return gather_columns(group, t)


def held_range(group, held: int, whole: int) -> Tuple[int, int]:
    """The ``[lo, lo + held)`` of an axis of ``whole`` entries that this
    rank holds: all of it, or the rank's contiguous 1/N where ``held`` is
    short of ``whole`` (``shard_params``'s cut)."""
    if group is None or held == whole:
        return 0, whole
    if held * group.size != whole:
        raise ValueError(f"{held} of {whole} entries is no 1/{group.size} "
                         f"share")
    return group.rank * held, held


def reduce_sum(group, t: torch.Tensor, dtype=None) -> torch.Tensor:
    """The ranks' partial sums ``t`` added in f32 (every rank gets the
    same bits), cast once to ``dtype`` (default ``t``'s)."""
    return group.all_reduce(t.to(torch.float32, copy=True),
                            "sum").to(dtype or t.dtype)


def product_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated and returned in f32. On the card a bf16 or
    f16 product stays one cuBLAS call on the tensor cores with an f32
    output (``out_dtype``); on the CPU, which has no such call, the same
    sum is taken from f32 copies."""
    if x.is_cuda and x.dtype != torch.float32:
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return _MmF32Fn.apply(x, w)
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.view(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


class _MmF32Fn(torch.autograd.Function):
    """``product_f32`` on the card under grad: the f32-output product
    forward; backward the products of the gradient in the operands'
    dtype, as a product in that dtype takes them."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.view(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = g @ w.T
        gw = x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return gx, gw


def row_parallel(group, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for ``w`` split over the ranks on its rows (``x`` this
    rank's columns of the input): each rank's product kept in f32
    (``product_f32``) and the partial sums added across the ranks in f32,
    cast once to ``x``'s dtype -- the whole product but for the order of
    its f32 additions, as one rank's bf16 product accumulates in f32 and
    rounds once."""
    return reduce_sum(group, product_f32(x, w), x.dtype)


def row_product(group, x: torch.Tensor, w: torch.Tensor,
                width: int) -> torch.Tensor:
    """``x @ w`` over ``width`` input channels. Where ``w`` is split over
    the rank ``group`` on its rows, ``x`` is whole (its rank's columns are
    taken) or already this rank's columns, and the products are summed
    across the ranks (``row_parallel``); else one product."""
    if w.shape[0] == width:
        return x @ w
    if x.shape[-1] == width:
        lo, n = held_range(group, w.shape[0], width)
        x = x[..., lo:lo + n]
    return row_parallel(group, x, w)


def split_rmsnorm(group, scale: torch.Tensor, x: torch.Tensor, width: int,
                  eps: float) -> torch.Tensor:
    """RMSNorm over ``width`` channels of which ``x`` holds this rank's
    contiguous share ([..., width/N], at ``held_range``): the squares
    summed in f32 on each rank and across the ranks, then each rank's
    channels scaled by their slice of the whole ``scale`` [width] -- the
    whole norm's result, but for the order of its f32 additions. Without
    a split, the plain RMSNorm."""
    lo, n = held_range(group, x.shape[-1], width)
    xf = x.float()
    if n == width:
        var = (xf * xf).mean(dim=-1, keepdim=True)
    elif torch.is_grad_enabled() and x.requires_grad:
        # training: each rank scales its own channels by the whole sum,
        # and takes the whole scale's gradient for its channels only
        var = all_sum(group, (xf * xf).sum(dim=-1, keepdim=True)) / width
        scale = copy_in(group, scale)
    else:
        var = group.all_reduce((xf * xf).sum(dim=-1, keepdim=True),
                               "sum") / width
    return (xf * torch.rsqrt(var + eps)
            * scale[lo:lo + n].float()).to(x.dtype)
