"""AdamW over a flat list of tensors, with an f32 master copy.

The optimizer state (m, v and the f32 master copy of low-precision
parameters) is the largest write-heavy resident of training -- the
occupant the paper's SSD-EP tier is for. ``opt_specs`` places it under
the optimizer tier with the parameters' layout: on the POOL tier of a
rank mesh each rank holds m, v and the master of its FSDP shards only,
and ``update`` runs on those shards (the deterministic store's
reduce-scattered gradients), so no optimizer-state collective is issued.
The clip is global, as the reference's: over a rank ``group`` the
squares of the FSDP shards are summed across the ranks (one all-reduce)
and each whole leaf counted once. The arithmetic is the reference's
(``repro/optim/adamw.py``), step for step in f32: global-norm clipping,
linear warmup then cosine decay, bias-corrected moments and decoupled
weight decay on the master. ``update`` writes the new moments, masters
and parameters in place, as a PyTorch optimizer step does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor                    # 0-d int32
    m: List[torch.Tensor]                 # first moments, f32
    v: List[torch.Tensor]                 # second moments, f32
    master: Optional[List[torch.Tensor]]  # f32 masters (None: no master)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    use_master: bool = True  # keep an f32 master of every parameter


def init(params: Sequence[torch.Tensor], cfg: AdamWConfig) -> AdamWState:
    """Zero moments and (with ``use_master``) f32 masters of ``params``,
    on their devices."""
    with torch.no_grad():
        m = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in params]
        v = [torch.zeros_like(t) for t in m]
        master = ([p.detach().float().clone() for p in params]
                  if cfg.use_master else None)
    dev = params[0].device if params else torch.device("cpu")
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=m, v=v, master=master)


def schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio`` (f32)."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.learning_rate * torch.where(step < cfg.warmup_steps, warm,
                                           cos)


def global_norm(tensors: Sequence[torch.Tensor], group=None,
                sharded: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, in f32. Over a rank
    ``group``, the tensors flagged in ``sharded`` are this rank's FSDP
    shards: their squares are summed across the ranks; the others are
    whole and equal on every rank, counted once."""
    sq = [torch.sum(torch.square(t.float())) for t in tensors]
    if group is None or group.size == 1 or not sharded or not any(sharded):
        total = sum(sq)
        return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
    dev = tensors[0].device
    part = sum((q for q, s in zip(sq, sharded) if s),
               torch.zeros((), dtype=torch.float32, device=dev))
    whole = sum((q for q, s in zip(sq, sharded) if not s),
                torch.zeros((), dtype=torch.float32, device=dev))
    part = group.all_reduce(part.reshape(1).clone(), "sum")[0]
    return torch.sqrt(part + whole)


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        group=None, sharded=None
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / (norm + 1e-9))``;
    returns (the scaled gradients in their dtypes, the norm)."""
    norm = global_norm(grads, group, sharded)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return [(g.float() * scale).to(g.dtype) for g in grads], norm


@torch.no_grad()
def update(grads: Sequence[torch.Tensor], state: AdamWState,
           params: Sequence[torch.Tensor], cfg: AdamWConfig, *,
           group=None, sharded: Optional[Sequence[bool]] = None
           ) -> Tuple[Sequence[torch.Tensor], AdamWState, dict]:
    """One AdamW step. Writes the moments, masters and ``params`` in place
    and returns (params, the new state, {"grad_norm", "lr"}). Over a rank
    ``group``, ``params`` (and ``grads``, the moments, the masters) are
    this rank's: the ones flagged in ``sharded`` its FSDP shards, the
    others whole; only the clip's norm crosses the ranks."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, group, sharded)
    step = state.step + 1
    lr = schedule(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())
    masters = state.master or [None] * len(params)
    for p, g, m, v, mp in zip(params, grads, state.m, state.v, masters):
        g32 = g.float()
        m2 = b1 * m + (1 - b1) * g32
        v2 = b2 * v + (1 - b2) * torch.square(g32)
        mhat = m2 / bc1
        vhat = v2 / bc2
        base = mp if mp is not None else p.float()
        new = base - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                           + cfg.weight_decay * base)
        m.copy_(m2)
        v.copy_(v2)
        if mp is not None:
            mp.copy_(new)
        p.copy_(new.to(p.dtype))
    new_state = AdamWState(step=step, m=state.m, v=state.v,
                           master=state.master)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}


def opt_specs(param_specs: Sequence,
              state: Optional[AdamWState] = None) -> AdamWState:
    """The optimizer state's placement: m, v and the master mirror the
    parameters' specs under the optimizer tier (the same layout); the
    step is replicated. Without ``state``, a state with masters."""
    mirror = list(param_specs)
    master = state is None or state.master is not None
    return AdamWState(step=(), m=mirror, v=mirror,
                      master=mirror if master else None)
