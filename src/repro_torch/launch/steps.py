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

One process is one rank of a ``launch.mesh.RankMesh`` of shape (D, 1) or
(P, D, 1) (``mesh``; None: one rank). Its batch is its rows of the
global batch, as the reference's ``batch_specs`` places them: over the
data axis, or the (pod, data) product with ``rc.mesh.multi_pod`` -- the
FSDP axes too; without ``multi_pod`` the pod ranks are replicas. With both
tiers "device" the step is plain data parallel: whole weights, whole
gradients all-reduced. A model axis of more than one rank, and DEVICE
beside POOL or HOST on more than one FSDP rank, raise
(``models.model.check_trainable``). The step works in place on the
model, the moments and the masters (wherever they live), and returns the
same state.
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
    else:                   # the whole model, or one FSDP rank's (uncut)
        whole = sharding.param_specs(params, tier=rc.optimizer_tier,
                                     multi_pod_fsdp=rc.mesh.multi_pod)
        ospecs = [whole[n] for n, _ in params.named_parameters()]
    opt = adamw.opt_specs(ospecs, None if state is None else state.opt)
    residuals = (pspecs if state is not None and state.residuals is not None
                 else None)
    return TrainState(params=pspecs, opt=opt, residuals=residuals)


def init_state(params: nn.Module, rc: RunConfig,
               opt_cfg: adamw.AdamWConfig, mesh=None) -> TrainState:
    """A training state over ``params``: the whole model placed first
    under ``rc.param_tier`` (``HDMStore.place``: on a rank ``mesh`` this
    rank's FSDP shards on POOL and HOST, a shard already placed kept; on
    HOST with ``rc.enable_host_tier`` every leaf in pinned host memory,
    on one rank too); grads turned on for every parameter (the port
    builds them frozen for serving), zero moments, f32 masters and, with
    ``rc.grad_compression == "int8_ef"``, zero residuals, placed under
    ``rc.optimizer_tier``: on HOST with ``rc.enable_host_tier`` in pinned
    host memory, m and v created there and each master cast on the card
    one leaf at a time and copied out."""
    M.check_trainable(rc.model, mesh.shape if mesh is not None else (), rc)
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
    return TrainState(params, adamw.init(flat, opt_cfg, host=host),
                      residuals)


def loss_and_grads(params: nn.Module, cfg: ModelConfig, rc: RunConfig,
                   batch: Dict[str, torch.Tensor], *, group=None,
                   reducer=None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(loss, gradients aligned with ``params.parameters()``, in the
    parameters' dtypes, on the card; zeros for a parameter the loss does
    not reach). Over a rank ``group`` the loss is the global mean and each
    FSDP leaf's gradient the rank's shard, reduced in the backward by
    ``reducer``; the whole leaves' gradients are still this rank's part
    (``ds.apply_ds`` sums them). A HOST-tier leaf's gradient is collected
    on the card from the step's ``sharding.HostGrads``."""
    flat = list(params.parameters())
    sink = sharding.HostGrads()
    with torch.enable_grad():
        loss = M.loss_fn(params, cfg, rc, batch, group=group,
                         reducer=reducer, host_grads=sink)
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
                       reducer=None):
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
                                 group=group, reducer=reducer)
        loss_acc = loss_acc + loss
        for a, b in zip(g_acc, g):
            a.add_(b.float())
    inv = 1.0 / n_micro
    return loss_acc * inv, [(g * inv).to(p.dtype)
                            for g, p in zip(g_acc, flat)]


def build_train_step(cfg: ModelConfig, rc: RunConfig,
                     opt_cfg: adamw.AdamWConfig, mesh=None):
    """Returns ``step(state, batch) -> (state, metrics)``: loss and grads
    (accumulated over ``rc.microbatches``), the deterministic store
    (``rc.ds_enabled``: the reduce-scatter, else the all-reduce-then-slice
    baseline), the optional int8 error feedback, then AdamW, in place. On
    a rank ``mesh`` the state is this rank's (``init_state(mesh=)``) and
    ``batch`` its rows of the global batch."""
    M.check_trainable(cfg, mesh.shape if mesh is not None else (), rc)
    group = batch_group(rc, mesh)
    if group is not None and group.size == 1:
        group = None

    def step(state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        params = state.params
        reducer = (None if group is None
                   else ds.GradReducer(group, rc.ds_enabled))
        if rc.microbatches > 1:
            loss, grads = _accumulated_grads(params, cfg, rc, batch,
                                             rc.microbatches, group, reducer)
        else:
            loss, grads = loss_and_grads(params, cfg, rc, batch, group=group,
                                         reducer=reducer)
        # deterministic store: the gradients complete as pool shards
        grads = ds.apply_ds(grads, param_spec_list(params, rc),
                            group=group)
        axes = sharding.fsdp_axes(params) if group is not None else None
        residuals = state.residuals
        if residuals is not None:
            layouts = None if axes is None else [
                None if a is None else (_whole_shape(g, a, group.size), a)
                for g, a in zip(grads, axes)]
            grads, residuals = compression.compress_grads(
                grads, residuals, group=group, layouts=layouts)
        _, opt, om = adamw.update(
            grads, state.opt, list(params.parameters()), opt_cfg,
            group=group,
            sharded=None if axes is None else [a is not None for a in axes])
        return TrainState(params, opt, residuals), {"loss": loss, **om}

    return step


def _whole_shape(shard: torch.Tensor, axis: int, n: int) -> Tuple[int, ...]:
    shape = list(shard.shape)
    shape[axis] *= n
    return tuple(shape)
