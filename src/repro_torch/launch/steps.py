"""The training step: loss and gradients, the deterministic store, the
optional int8 error feedback, then AdamW.

The paper's mechanisms appear as in the reference's ``launch/steps.py``:

* the parameters and the optimizer state are placed by their tiers
  (``core.hdm.HDMStore``): on the POOL tier of a rank mesh each rank
  holds the FSDP shards of the weights and of m, v and the f32 master
  (``init_state``, ``state_specs``); on the HOST tier with
  ``rc.enable_host_tier`` the same shards live in pinned host memory,
  the weights copied onto the card by the speculative read, m, v and the
  master streamed through the card by AdamW (``optim.adamw``), while the
  gradients stay on the card;
* the layers stream through the speculative read inside ``loss_fn``,
  each gathered in its remat'd body, the leaves outside the stream once a
  step;
* the gradients complete as shards: the backward of each gather is the
  deterministic store's reduce-scatter (``core.deterministic_store``),
  never a whole gradient past its layer, and AdamW updates the shards.

One process is one rank of a ``launch.mesh.RankMesh`` of shape (D, N) or
(P, D, N) (``mesh``; None: one rank). Its batch is its rows of the
global batch, as the reference's ``batch_specs`` places them: over the
data axis, or the (pod, data) product with ``rc.mesh.multi_pod`` -- the
FSDP axes too; without ``multi_pod`` the pod ranks are replicas; every
model rank of a data row takes the same rows. With both tiers "device"
the step is plain data parallel on the data axes: whole weights, whole
gradients all-reduced. DEVICE weights beside POOL or HOST state update
the state's FSDP shard and gather the new weights; POOL or HOST weights
beside DEVICE state gather the gradient shards and update whole
(``state_moves``, as the reference's ``state_specs`` places the two).

On a model axis of more than one rank (the dense, audio and MoE
families; ``models.model.check_trainable``) the step is Megatron's
tensor parallelism with the activations whole on every model rank
between blocks -- the form serving's row-parallel products already take
-- rather than the reference's sequence-sharded activations
(``_act_spec``): each rank computes its own heads, d_ff columns and
experts, two collectives a dense block a pass over the model axis
(``sharding.copy_in`` before its column-parallel products, whose
backward sums; ``sharding.reduce_out`` after its row-parallel ones); the
vocabulary-parallel cross-entropy never gathers the logits; the MoE is
the reference's expert-parallel form, its tokens sharded over (data,
model). The gathers, HOST copies and the deterministic store stay over
the data axes. The step works in place on the model, the moments and the
masters (wherever they live), and returns the same state.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.core import deterministic_store as ds
from repro_torch.core import hdm
from repro_torch.models import model as M
from repro_torch.models.layers import pdtype
from repro_torch.optim import adamw, compression
from repro_torch.parallel import sharding


class TrainState(NamedTuple):
    params: nn.Module                       # the model (a rank's shard)
    opt: adamw.AdamWState
    residuals: Optional[List[torch.Tensor]]  # int8-EF residuals


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                rc: RunConfig) -> Dict[str, Tuple[Tuple[int, ...],
                                                  torch.dtype]]:
    """The train step's inputs as ``name -> (shape, dtype)`` (the
    reference's ShapeDtypeStructs for ``kind == "train"``)."""
    del rc
    B, S = shape.global_batch, shape.seq_len
    tok = (B, cfg.n_codebooks, S) if cfg.family == "audio" else (B, S)
    out = {"tokens": (tok, torch.int32), "labels": (tok, torch.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = ((B, cfg.n_vision_tokens, cfg.d_model),
                                pdtype(cfg))
    return out


def batch_group(rc: RunConfig, mesh):
    """The rank group the batch's rows and the FSDP shards split over:
    (pod, data) with ``rc.mesh.multi_pod``, else data (None: one rank)."""
    return None if mesh is None else mesh.dp(rc.mesh.multi_pod)


def param_spec_list(params: nn.Module, rc: RunConfig) -> List[Tuple]:
    """The spec of each of ``params.parameters()``: the specs a shard was
    cut by (``sharding.shard_params`` keeps them), else those of the
    whole model under ``rc.param_tier``."""
    specs = getattr(params, "specs", None)
    if specs is None:
        specs = sharding.param_specs(params, tier=rc.param_tier,
                                     multi_pod_fsdp=rc.mesh.multi_pod)
    return [specs[n] for n, _ in params.named_parameters()]


def state_specs(params: nn.Module, rc: RunConfig,
                state: Optional[TrainState] = None) -> TrainState:
    """The training state's placement (the reference's ``state_specs``):
    the parameters' specs under ``rc.param_tier``, the optimizer state
    mirroring them under ``rc.optimizer_tier`` (``adamw.opt_specs``), the
    residuals the parameters'. Lists aligned with ``params.parameters()``
    of the whole model (or of a shard, by the specs it was cut by)."""
    pspecs = param_spec_list(params, rc)
    alike = (rc.optimizer_tier == rc.param_tier
             or {rc.param_tier, rc.optimizer_tier} <= {"pool", "host"})
    if alike and getattr(params, "specs", None) is not None:
        ospecs = pspecs     # a shard, cut alike under both tiers
    else:                   # by the whole leaves, under the state's tier
        ospecs = _whole_specs(params, rc, rc.optimizer_tier)
    opt = adamw.opt_specs(ospecs, None if state is None else state.opt)
    residuals = (pspecs if state is not None and state.residuals is not None
                 else None)
    return TrainState(params=pspecs, opt=opt, residuals=residuals)


def _whole_specs(params: nn.Module, rc: RunConfig, tier: str) -> List:
    """The spec under ``tier`` of each of ``params.parameters()``, by the
    whole leaf: of the model itself, or of a shard (``shard_params``'
    result) by the whole shapes it was cut from."""
    if not hasattr(params, "shard"):
        specs = sharding.param_specs(params, tier=tier,
                                     multi_pod_fsdp=rc.mesh.multi_pod)
        return [specs[n] for n, _ in params.named_parameters()]
    shard = params.shard
    n, f = shard[1], (shard[3] if len(shard) == 4 else 1)
    fsdp = ("pod", "data") if rc.mesh.multi_pod else "data"
    out = []
    for name, p in params.named_parameters():
        spec = params.specs[name]
        shape = [size * (n if a == "model" else f if a == fsdp and f > 1
                         else 1) for size, a in zip(p.shape, spec)]
        out.append(sharding.spec_for(sharding.ref_path(name)[0], shape,
                                     fsdp_axis=None if tier == "device"
                                     else fsdp, stacked=False))
    return out


def state_moves(params: nn.Module, rc: RunConfig, mesh) -> List:
    """For each of ``params.parameters()`` (a rank's shard): None where
    the weight and its optimizer state sit alike on the FSDP axes, else
    how the state's placement differs (``adamw.update``'s ``moves``):
    ``("slice", axis)`` for a weight whole on the data axis (DEVICE)
    beside a state sharded along ``axis`` (POOL or HOST), ``("gather",
    axis)`` for a weight sharded along ``axis`` beside a whole state."""
    group = batch_group(rc, mesh)
    tiers = {rc.param_tier, rc.optimizer_tier}
    if (group is None or group.size == 1 or len(tiers) == 1
            or tiers <= {"pool", "host"}):
        return [None] * len(list(params.parameters()))
    axes = sharding.fsdp_axes(params)
    out = []
    for a, spec in zip(axes, _whole_specs(params, rc, rc.optimizer_tier)):
        o = sharding._fsdp_axis(spec)
        out.append(None if a == o else ("gather", a) if o is None
                   else ("slice", o))
    return out


def init_state(params: nn.Module, rc: RunConfig,
               opt_cfg: adamw.AdamWConfig, mesh=None) -> TrainState:
    """A training state over ``params``: the whole model placed first
    under ``rc.param_tier`` (``HDMStore.place``: on a rank ``mesh`` this
    rank's model-axis shard, on POOL and HOST cut again to its FSDP
    shard, a shard already placed kept; on HOST with
    ``rc.enable_host_tier`` every leaf in pinned host memory, on one rank
    too); grads turned on for every parameter (the port builds them
    frozen for serving), zero moments, f32 masters and, with
    ``rc.grad_compression == "int8_ef"``, zero residuals (the weights'
    placement), placed under ``rc.optimizer_tier``: on HOST with
    ``rc.enable_host_tier`` in pinned host memory, m and v created there
    and each master cast on the card one leaf at a time and copied out.
    Where the two tiers place a leaf apart on the data axis
    (``state_moves``) its m, v and master are the state tier's: this
    rank's slice of a DEVICE weight, or a POOL or HOST weight gathered
    whole."""
    M.check_trainable(rc.model, mesh.shape if mesh is not None else ())
    store = hdm.HDMStore(mesh, tier=rc.param_tier,
                         enable_host_tier=rc.enable_host_tier,
                         multi_pod_fsdp=rc.mesh.multi_pod)
    if not hasattr(params, "shard") and (mesh is not None or store.pinned):
        params = store.place(params)
    params.requires_grad_(True)
    flat = list(params.parameters())
    host = (hdm.compute_device(flat[0])
            if rc.optimizer_tier == hdm.HOST and rc.enable_host_tier
            else None)
    residuals = None
    if rc.grad_compression == "int8_ef":
        residuals = (compression.init_residuals(flat) if host is None
                     else hdm.host_like(flat, host, torch.float32))
    moves = state_moves(params, rc, mesh)
    src = flat
    if any(moves):
        zeros = [torch.zeros(p.shape, dtype=torch.float32,
                             device=hdm.compute_device(p)) for p in flat]
        _, src, _ = adamw._to_state(zeros, [p.detach() for p in flat],
                                    moves, batch_group(rc, mesh))
    return TrainState(params, adamw.init(src, opt_cfg, host=host),
                      residuals)


def loss_and_grads(params: nn.Module, cfg: ModelConfig, rc: RunConfig,
                   batch: Dict[str, torch.Tensor], *, group=None,
                   reducer=None, ranks: Optional[M.Ranks] = None
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(loss, gradients aligned with ``params.parameters()``, in the
    parameters' dtypes, on the card; zeros for a parameter the loss does
    not reach). Over a rank ``group`` the loss is the global mean and each
    FSDP leaf's gradient the rank's shard, reduced in the backward by
    ``reducer``; the whole leaves' gradients are still this rank's part
    (``ds.apply_ds`` sums them). A HOST-tier leaf's gradient is collected
    on the card from the step's ``sharding.HostGrads``. With ``ranks``
    (``models.model.Ranks``: the model axis beside the data axes) each
    leaf cut on the model axis takes this rank's part of its gradient."""
    flat = list(params.parameters())
    sink = sharding.HostGrads()
    with torch.enable_grad():
        loss = M.loss_fn(params, cfg, rc, batch, group=group,
                         reducer=reducer, host_grads=sink, ranks=ranks)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    out = []
    for p, g in zip(flat, grads):
        if g is None:
            g = sink.pop(p)
        out.append(torch.zeros(p.shape, dtype=p.dtype,
                               device=hdm.compute_device(p))
                   if g is None else g)
    return loss.detach(), out


def _accumulated_grads(params, cfg, rc, batch, n_micro: int, group=None,
                       reducer=None, ranks=None):
    """Gradient accumulation over ``n_micro`` splits of the leading batch
    axis: the f32 sums scaled by ``1 / n_micro`` and cast to the
    parameters' dtypes, and the mean loss. Over a rank group the FSDP
    leaves' whole gradients accumulate in the ``reducer`` (f32, a layer's
    whole size each) and are reduce-scattered once, in the last
    microbatch's backward."""
    def split(x):
        return x.reshape((n_micro, x.shape[0] // n_micro) + x.shape[1:])

    micro = {k: split(v) for k, v in batch.items()}
    flat = list(params.parameters())
    loss_acc = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    g_acc = [torch.zeros(p.shape, dtype=torch.float32,
                         device=hdm.compute_device(p)) for p in flat]
    for i in range(n_micro):
        if reducer is not None:
            reducer.final = i == n_micro - 1
        loss, g = loss_and_grads(params, cfg, rc,
                                 {k: v[i] for k, v in micro.items()},
                                 group=group, reducer=reducer,
                                 ranks=ranks)
        loss_acc = loss_acc + loss
        for a, b in zip(g_acc, g):
            a.add_(b.float())
    inv = 1.0 / n_micro
    return loss_acc * inv, [(g * inv).to(p.dtype)
                            for g, p in zip(g_acc, flat)]


def train_ranks_of(rc: RunConfig, mesh) -> Optional[M.Ranks]:
    """The rank groups of the train step on ``mesh``: the model axis, the
    data axes as the FSDP and batch groups, the data axis alone for the
    MoE's tokens (each None at one rank); None without a mesh."""
    if mesh is None:
        return None
    def real(g):
        return g if g.size > 1 else None
    group = real(batch_group(rc, mesh))
    return M.Ranks(model=real(mesh.model), fsdp=group, batch=group,
                   data=real(mesh.data))


def build_train_step(cfg: ModelConfig, rc: RunConfig,
                     opt_cfg: adamw.AdamWConfig, mesh=None):
    """Returns ``step(state, batch) -> (state, metrics)``: loss and grads
    (accumulated over ``rc.microbatches``), the deterministic store
    (``rc.ds_enabled``: the reduce-scatter, else the all-reduce-then-slice
    baseline), the optional int8 error feedback, then AdamW, in place. On
    a rank ``mesh`` the state is this rank's (``init_state(mesh=)``) and
    ``batch`` its rows of the global batch.

    On a model axis of N > 1 ranks the step is Megatron's tensor
    parallelism with the activations whole on every model rank between
    blocks (``models.model.loss_fn``): each rank holds its shard of every
    leaf ``param_specs`` cuts on "model", computes its heads, d_ff
    columns and experts, and every model rank the same loss. The
    gradients complete as (F, M) shards: a leaf whole on the model axis
    has its whole gradient on every model rank (the sums over the model
    axis are taken inside the backward: ``sharding.copy_in``), so the
    deterministic store reduces over the data axes only; the clip's norm
    sums an M-cut leaf's squares over the model axis too, and int8 error
    feedback quantizes each (F, M) shard in its whole leaf's blocks."""
    M.check_trainable(cfg, mesh.shape if mesh is not None else ())
    ranks = train_ranks_of(rc, mesh)
    group = None if ranks is None else ranks.fsdp
    model = None if ranks is None else ranks.model

    def step(state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        params = state.params
        reducer = (None if group is None
                   else ds.GradReducer(group, rc.ds_enabled))
        if rc.microbatches > 1:
            loss, grads = _accumulated_grads(params, cfg, rc, batch,
                                             rc.microbatches, group, reducer,
                                             ranks)
        else:
            loss, grads = loss_and_grads(params, cfg, rc, batch, group=group,
                                         reducer=reducer, ranks=ranks)
        specs = param_spec_list(params, rc)
        # deterministic store: the gradients complete as pool shards
        grads = ds.apply_ds(grads, specs, group=group)
        axes = sharding.fsdp_axes(params) if group is not None else None
        split = (None if model is None
                 else [_model_axis(s) is not None for s in specs])
        residuals = state.residuals
        if residuals is not None:
            layouts = _layouts(grads, axes, split, specs, group, model)
            grads, residuals = compression.compress_grads(
                grads, residuals, group=group, layouts=layouts, model=model)
        _, opt, om = adamw.update(
            grads, state.opt, list(params.parameters()), opt_cfg,
            group=group,
            sharded=None if axes is None else [a is not None for a in axes],
            model=model, split=split, moves=state_moves(params, rc, mesh))
        return TrainState(params, opt, residuals), {"loss": loss, **om}

    return step


def serve_ranks_of(rc: RunConfig, mesh, n_slots: int) -> M.Ranks:
    """The rank groups of a serving step on ``mesh`` for a batch of
    ``n_slots`` rows, as the serving engine takes them: the weights split
    over the model axis, gathered over the FSDP axes on POOL and HOST,
    the rows split over the batch axes and the cache's pages over the
    model axis -- or, for one row, over every axis (the reference's
    ``decode_axes``)."""
    if mesh is None:
        return M.Ranks()

    def real(g):
        return g if g is not None and g.size > 1 else None
    mp = rc.mesh.multi_pod
    store = hdm.HDMStore(mesh, tier=rc.param_tier, multi_pod_fsdp=mp)
    one = n_slots == 1
    return M.Ranks(model=real(mesh.model),
                   pages=real(mesh.all_axes(mp) if one else mesh.model),
                   fsdp=store.fsdp_group(),
                   batch=None if one else real(mesh.dp(mp)))


def build_prefill_step(cfg: ModelConfig, rc: RunConfig, mesh=None):
    """``step(params, batch) -> logits``: the reference's prefill step,
    ``models.model.prefill_step`` (the whole prompt, no cache, the last
    position's logits) on this rank's shard of the weights over the rank
    groups of ``mesh`` (``serve_ranks_of``; ``batch`` this rank's rows)."""
    def step(params, batch):
        ranks = serve_ranks_of(rc, mesh, batch["tokens"].shape[0])
        return M.prefill_step(params, cfg, rc, batch, ranks=ranks)
    return step


def build_serve_step(cfg: ModelConfig, rc: RunConfig, mesh=None):
    """``step(params, cache, tokens) -> (logits, cache)``: the reference's
    serve step, one ``models.model.decode_step`` for every row, on this
    rank's shard of the weights and of the cache
    (``parallel.sharding.shard_cache``) over the rank groups of ``mesh``
    (``serve_ranks_of``); the cache is updated in place."""
    def step(params, cache, tokens):
        ranks = serve_ranks_of(rc, mesh, cache["pos"].shape[0] * (
            1 if mesh is None else mesh.dp(rc.mesh.multi_pod).size))
        return M.decode_step(params, cfg, rc, tokens, cache, ranks=ranks)
    return step


def _model_axis(spec) -> Optional[int]:
    return spec.index("model") if "model" in spec else None


def _layouts(grads, axes, split, specs, group, model):
    """Each gradient's layout for ``compression.compress_grads``: None for
    a leaf whole on every axis, else its whole shape and its cuts
    ``{axis: (index, count)}`` on the FSDP and model axes."""
    if axes is None and split is None:
        return None
    out = []
    for i, g in enumerate(grads):
        cuts = {}
        if axes is not None and axes[i] is not None:
            cuts[axes[i]] = (group.rank, group.size)
        if split is not None and split[i]:
            cuts[_model_axis(specs[i])] = (model.rank, model.size)
        if not cuts:
            out.append(None)
            continue
        shape = list(g.shape)
        for a, (_, count) in cuts.items():
            shape[a] *= count
        out.append((tuple(shape), cuts))
    return out
