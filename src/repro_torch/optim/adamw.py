"""AdamW over a flat list of tensors, with an f32 master copy.

The optimizer state (m, v and the f32 master copy of low-precision
parameters) is the largest write-heavy resident of training -- the
occupant the paper's SSD-EP tier is for. ``opt_specs`` places it under
the optimizer tier with the parameters' layout: on the POOL tier of a
rank mesh each rank holds m, v and the master of its FSDP shards only,
and ``update`` runs on those shards (the deterministic store's
reduce-scattered gradients), so no optimizer-state collective is issued.
On the HOST tier (``init(host=)``) the state lives in pinned host memory
(``core.hdm``): ``update`` streams each leaf through the card in pieces
of at most ``CHUNK_BYTES`` -- copied in on a side stream into one of two
card buffers, updated on the card against the card's gradient, copied
back on another stream -- so that a piece's copies overlap its
neighbours' arithmetic; a parameter on the HOST tier gets its new value
the same way. The arithmetic is the same whichever tier a tensor lives
on, so a HOST step gives a DEVICE step's bits. The clip is global, as the
reference's: over a rank ``group`` the
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

from repro_torch.core import hdm
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import HOST_COPIED, copy_stream, host_target

# the largest piece of a HOST-tier leaf streamed through the card at once
CHUNK_BYTES = 256 << 20


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


def init(params: Sequence[torch.Tensor], cfg: AdamWConfig,
         host: Optional[torch.device] = None) -> AdamWState:
    """Zero moments and (with ``use_master``) f32 masters of ``params``,
    on the devices they are computed on (``hdm.compute_device``); with
    ``host`` (a card), in pinned host arenas streamed to it: m and v
    created there, each master cast on the card one leaf at a time and
    copied out. The step counter lives on the card."""
    dev = (host or hdm.compute_device(params[0]) if params
           else torch.device("cpu"))
    with torch.no_grad():
        if host is None:
            m = [torch.zeros(p.shape, dtype=torch.float32,
                             device=hdm.compute_device(p)) for p in params]
            v = [torch.zeros_like(t) for t in m]
            master = ([p.detach().to(hdm.compute_device(p)).float().clone()
                       for p in params] if cfg.use_master else None)
        else:
            m = hdm.host_like(params, host, torch.float32)
            v = hdm.host_like(params, host, torch.float32)
            master = None
            if cfg.use_master:
                master = hdm.host_like(params, host, torch.float32)
                for mp, p in zip(master, params):
                    mp.copy_(p.detach().to(host).float())
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
                sharded: Optional[Sequence[bool]] = None, model=None,
                split: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, in f32. Over a rank
    ``group``, the tensors flagged in ``sharded`` are this rank's FSDP
    shards: their squares are summed across the ranks; the others are
    whole and equal on every rank, counted once. Over a ``model`` group
    the tensors flagged in ``split`` are this rank's part of a leaf cut
    on the model axis: their squares are summed across its ranks too
    (one all-reduce an axis); a leaf whole on the model axis counts
    once."""
    sq = [torch.sum(torch.square(t.float())) for t in tensors]
    on_model = bool(model is not None and model.size > 1 and split
                    and any(split))
    on_group = bool(group is not None and group.size > 1 and sharded
                    and any(sharded))
    if not on_model and not on_group:
        total = sum(sq)
        return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
    dev = tensors[0].device
    sharded = sharded if on_group else [False] * len(sq)
    split = split if on_model else [False] * len(sq)

    def part(f, m):
        return sum((q for q, a, b in zip(sq, sharded, split)
                    if a == f and b == m),
                   torch.zeros((), dtype=torch.float32, device=dev))
    fm, f_only, m_only, whole = (part(True, True), part(True, False),
                                 part(False, True), part(False, False))
    if on_model:
        fm, m_only = model.all_reduce(torch.stack([fm, m_only]), "sum")
    if on_group:
        fm, f_only = group.all_reduce(torch.stack([fm, f_only]), "sum")
    return torch.sqrt(fm + f_only + m_only + whole)


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        group=None, sharded=None, model=None, split=None
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / (norm + 1e-9))``;
    returns (the scaled gradients in their dtypes, the norm)."""
    norm = global_norm(grads, group, sharded, model, split)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return [(g.float() * scale).to(g.dtype) for g in grads], norm


def _to_state(grads, params, moves, group):
    """The gradients and parameters of the leaves whose weights and
    optimizer state are placed apart on the FSDP ``group`` (``moves[i]``:
    ``("slice", axis)`` -- a weight whole on the group, its state this
    rank's contiguous 1/F along ``axis``; ``("gather", axis)`` -- a weight
    shard, its state whole) in the state's placement: a slice of the
    gradient and a copy of the weight's slice, or the gradient and the
    weight gathered whole (one all-gather for them all). Returns (grads,
    params, finish): ``finish()`` puts the updated values back into the
    weights -- the new slices gathered to every rank (one all-gather), or
    this rank's slice of the whole update."""
    grads, params = list(grads), list(params)
    rank, n = group.rank, group.size
    owned = list(params)
    gather = [i for i, mv in enumerate(moves) if mv and mv[0] == "gather"]
    if gather:
        whole = sharding._Gathers(
            [t.detach().to(grads[i].device) for i in gather
             for t in (grads[i], params[i])],
            [moves[i][1] for i in gather for _ in range(2)], group).wait()
        for j, i in enumerate(gather):
            grads[i], params[i] = whole[2 * j], whole[2 * j + 1]
    sliced = [i for i, mv in enumerate(moves) if mv and mv[0] == "slice"]
    for i in sliced:
        axis = moves[i][1]
        k = params[i].shape[axis] // n
        grads[i] = grads[i].narrow(axis, rank * k, k)
        params[i] = params[i].detach().narrow(axis, rank * k,
                                              k).contiguous()

    def finish():
        for i in gather:
            axis = moves[i][1]
            k = params[i].shape[axis] // n
            owned[i].copy_(params[i].narrow(axis, rank * k, k))
        if sliced:
            got = sharding._Gathers([params[i] for i in sliced],
                                    [moves[i][1] for i in sliced],
                                    group).wait()
            for i, t in zip(sliced, got):
                owned[i].copy_(t)
    return grads, params, finish


@torch.no_grad()
def update(grads: Sequence[torch.Tensor], state: AdamWState,
           params: Sequence[torch.Tensor], cfg: AdamWConfig, *,
           group=None, sharded: Optional[Sequence[bool]] = None,
           model=None, split: Optional[Sequence[bool]] = None,
           moves: Optional[Sequence] = None
           ) -> Tuple[Sequence[torch.Tensor], AdamWState, dict]:
    """One AdamW step. Writes the moments, masters and ``params`` in place
    and returns (params, the new state, {"grad_norm", "lr"}). Over a rank
    ``group``, ``params`` (and ``grads``, the moments, the masters) are
    this rank's: the ones flagged in ``sharded`` its FSDP shards, the
    others whole; over a ``model`` group the ones flagged in ``split``
    its part of a leaf cut on the model axis. Only the clip's norm
    crosses the ranks, but for the leaves whose weights and state are
    placed apart on the group (``moves``, ``_to_state``): DEVICE weights
    beside POOL or HOST state update the state's shard and gather the new
    weights; POOL or HOST weights beside DEVICE state gather the gradient
    and the weight, update whole and keep the weight's shard."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, group, sharded,
                                       model, split)
    out, finish = params, None
    if moves and any(moves):
        grads, params, finish = _to_state(grads, params, moves, group)
    step = state.step + 1
    lr = schedule(step, cfg)
    bc1 = 1 - torch.pow(cfg.b1, step.float())
    bc2 = 1 - torch.pow(cfg.b2, step.float())
    masters = state.master or [None] * len(params)
    streamed = []
    for p, g, m, v, mp in zip(params, grads, state.m, state.v, masters):
        if any(t is not None and host_target(t) is not None
               for t in (p, m, v, mp)):
            streamed.append((p, g, m, v, mp))
            continue
        m2, v2, new = _adamw(g, m, v, mp if mp is not None else p.float(),
                             lr, bc1, bc2, cfg)
        m.copy_(m2)
        v.copy_(v2)
        if mp is not None:
            mp.copy_(new)
        p.copy_(new.to(p.dtype))
    if streamed:
        _stream_update(streamed, lr, bc1, bc2, cfg)
    if finish is not None:
        finish()
    new_state = AdamWState(step=step, m=state.m, v=state.v,
                           master=state.master)
    return out, new_state, {"grad_norm": gnorm, "lr": lr}


def _adamw(g, m, v, base, lr, bc1, bc2, cfg: AdamWConfig):
    """One leaf's (or piece's) new m, v and f32 value, from its gradient
    ``g``, moments and ``base`` (the master, or the parameter in f32)."""
    g32 = g.float()
    m2 = cfg.b1 * m + (1 - cfg.b1) * g32
    v2 = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
    mhat = m2 / bc1
    vhat = v2 / bc2
    new = base - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                       + cfg.weight_decay * base)
    return m2, v2, new


def _stream_update(items, lr, bc1, bc2, cfg: AdamWConfig) -> None:
    """``update``'s arithmetic for the leaves ``(p, g, m, v, master)``
    with a tensor on the HOST tier, piece by piece on the card: each
    host tensor's piece copied into one of two card slots on the h2d
    stream (after the slot's last copy out), updated on the current
    stream, copied back on the d2h stream; the card's tensors are used in
    place. Returns once every copy back has landed. On the CPU the same
    pieces and slots, copied in line."""
    dev = items[0][1].device
    cuda = dev.type == "cuda"
    per = CHUNK_BYTES // 4
    most = min(per, max(p.numel() for p, *_ in items))
    names = ("m", "v", "mp", "p")
    slots = [{"buf": {n: torch.empty(most * 4, dtype=torch.uint8,
                                     device=dev) for n in names},
              "free": None} for _ in range(2)]
    if cuda:
        comp = torch.cuda.current_stream(dev)
        h2d, d2h = copy_stream(dev, "h2d"), copy_stream(dev, "d2h")
        h2d.wait_stream(comp)       # the slots' memory, free on comp
    k = 0
    for p, g, m, v, mp in items:
        flat = {"m": m, "v": v, "mp": mp, "p": p}
        host = {n for n, t in flat.items()
                if t is not None and host_target(t) is not None}
        wanted = {"m", "v"} | ({"mp"} if mp is not None else {"p"})
        gflat = g.reshape(-1)
        for lo in range(0, p.numel(), per):
            hi = min(p.numel(), lo + per)
            slot = slots[k % 2]
            k += 1
            view = {n: t.view(-1)[lo:hi] for n, t in flat.items()
                    if t is not None}
            card = {n: (slot["buf"][n][:(hi - lo) * view[n].element_size()]
                        .view(view[n].dtype) if n in host else view[n])
                    for n in view}
            ins = [(card[n], view[n]) for n in host & wanted]
            if cuda:
                with torch.cuda.stream(h2d):
                    if slot["free"] is not None:
                        h2d.wait_event(slot["free"])
                    for dst, src in ins:
                        dst.copy_(src, non_blocking=True)
                        HOST_COPIED["h2d"] += src.numel() * src.element_size()
                    ready = torch.cuda.Event()
                    ready.record(h2d)
                comp.wait_event(ready)
            else:
                for dst, src in ins:
                    dst.copy_(src)
            base = card["mp"] if mp is not None else card["p"].float()
            m2, v2, new = _adamw(gflat[lo:hi], card["m"], card["v"], base,
                                 lr, bc1, bc2, cfg)
            card["m"].copy_(m2)
            card["v"].copy_(v2)
            if mp is not None:
                card["mp"].copy_(new)
            card["p"].copy_(new.to(p.dtype))
            outs = [(view[n], card[n]) for n in host]
            if cuda:
                done = torch.cuda.Event()
                done.record(comp)
                with torch.cuda.stream(d2h):
                    d2h.wait_event(done)
                    for dst, src in outs:
                        dst.copy_(src, non_blocking=True)
                        HOST_COPIED["d2h"] += dst.numel() * dst.element_size()
                    slot["free"] = torch.cuda.Event()
                    slot["free"].record(d2h)
            else:
                for dst, src in outs:
                    dst.copy_(src)
    if cuda:
        comp.wait_stream(d2h)
        d2h.synchronize()


def opt_specs(param_specs: Sequence,
              state: Optional[AdamWState] = None) -> AdamWState:
    """The optimizer state's placement: m, v and the master mirror the
    parameters' specs under the optimizer tier (the same layout); the
    step is replicated. Without ``state``, a state with masters."""
    mirror = list(param_specs)
    master = state is None or state.master is not None
    return AdamWState(step=(), m=mirror, v=mirror,
                      master=mirror if master else None)
