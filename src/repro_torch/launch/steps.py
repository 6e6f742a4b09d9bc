"""The training step: loss and gradients, the deterministic store, the
optional int8 error feedback, then AdamW.

The paper's mechanisms appear as in the reference's ``launch/steps.py``:
the layers stream through the speculative-read pipeline inside
``loss_fn``, the gradients are placed by the deterministic store
(``core.deterministic_store.apply_ds``; whole on one rank) and the
optimizer updates them where they lie. One rank has no shardings: the
reference's ``state_specs`` / ``shardings`` and its serve and prefill
builders stay with the multi-rank slice. The step works in place on the
model, the moments and the masters, and returns the same state.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.core import deterministic_store as ds
from repro_torch.models import model as M
from repro_torch.models.layers import pdtype
from repro_torch.optim import adamw, compression


class TrainState(NamedTuple):
    params: nn.Module                       # the model, grads enabled
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


def init_state(params: nn.Module, rc: RunConfig,
               opt_cfg: adamw.AdamWConfig) -> TrainState:
    """A training state over ``params``: grads turned on for every
    parameter (the port builds them frozen for serving), zero moments, f32
    masters and, with ``rc.grad_compression == "int8_ef"``, zero
    residuals."""
    M.check_trainable(rc.model)
    params.requires_grad_(True)
    flat = list(params.parameters())
    residuals = (compression.init_residuals(flat)
                 if rc.grad_compression == "int8_ef" else None)
    return TrainState(params, adamw.init(flat, opt_cfg), residuals)


def loss_and_grads(params: nn.Module, cfg: ModelConfig, rc: RunConfig,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(loss, gradients aligned with ``params.parameters()``, in the
    parameters' dtypes; zeros for a parameter the loss does not reach)."""
    flat = list(params.parameters())
    with torch.enable_grad():
        loss = M.loss_fn(params, cfg, rc, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(flat, grads)]


def _accumulated_grads(params, cfg, rc, batch, n_micro: int):
    """Gradient accumulation over ``n_micro`` splits of the leading batch
    axis: the f32 sums scaled by ``1 / n_micro`` and cast to the
    parameters' dtypes, and the mean loss."""
    def split(x):
        return x.reshape((n_micro, x.shape[0] // n_micro) + x.shape[1:])

    micro = {k: split(v) for k, v in batch.items()}
    flat = list(params.parameters())
    loss_acc = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in flat]
    for i in range(n_micro):
        loss, g = loss_and_grads(params, cfg, rc,
                                 {k: v[i] for k, v in micro.items()})
        loss_acc = loss_acc + loss
        for a, b in zip(g_acc, g):
            a.add_(b.float())
    inv = 1.0 / n_micro
    return loss_acc * inv, [(g * inv).to(p.dtype)
                            for g, p in zip(g_acc, flat)]


def build_train_step(cfg: ModelConfig, rc: RunConfig,
                     opt_cfg: adamw.AdamWConfig):
    """Returns ``step(state, batch) -> (state, metrics)``: loss and grads
    (accumulated over ``rc.microbatches``), the deterministic store, the
    optional int8 error feedback, then AdamW, in place."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        params = state.params
        if rc.microbatches > 1:
            loss, grads = _accumulated_grads(params, cfg, rc, batch,
                                             rc.microbatches)
        else:
            loss, grads = loss_and_grads(params, cfg, rc, batch)
        # deterministic store: the gradients complete where they lie
        grads = ds.apply_ds(grads, None, enabled=rc.ds_enabled)
        residuals = state.residuals
        if residuals is not None:
            grads, residuals = compression.compress_grads(grads, residuals)
        _, opt, om = adamw.update(grads, state.opt,
                                  list(params.parameters()), opt_cfg)
        return TrainState(params, opt, residuals), {"loss": loss, **om}

    return step
