"""Mixture-of-Experts layer: top-k routing at a fixed expert capacity.

The port of the reference's ``repro.models.moe``. On one rank its
``moe_apply_ep`` (prefill) and ``moe_apply_ep_decode`` (decode) fall back
to ``moe_apply``, so both drop (token, expert) pairs past each expert's
capacity ``round(capacity_factor · t · k / E)`` -- at decode too, where t
counts every slot of the tick, idle ones included. Over a rank group of
more than one rank (``launch.mesh``) they are the reference's
expert-parallel forms: ``all_to_all`` dispatch at prefill, a sum
all-reduce at decode (section below). ``moe_block_apply`` is the training
forward of a whole MoE block; ``moe_apply`` returns the load-balance aux
loss the training loss adds.

Routing is f32 (router weight, softmax); the experts' products run in the
model dtype as batched matmuls. The dispatch buffers are written without
accumulation -- each kept pair owns its (expert, position) cell and the
dropped pairs all land in one slack row that is never read -- so they are
bit-stable run to run on the card.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense_init, frozen_param, pdtype,
                                       rmsnorm)
from repro_torch.parallel import sharding


class MoE(nn.Module):
    """``router`` [d, E] in f32; ``e_gate``/``e_up`` [E, d, ff] and
    ``e_down`` [E, ff, d] in the model dtype."""

    def __init__(self, router, e_gate, e_up, e_down):
        super().__init__()
        self.router, self.e_gate, self.e_up, self.e_down = (
            frozen_param(w) for w in (router, e_gate, e_up, e_down))


def moe_init(gen: torch.Generator, cfg: ModelConfig, device) -> MoE:
    """Draw the router and the experts from ``gen`` (router, gate, up,
    down order)."""
    d, ff, e, dt = cfg.d_model, cfg.d_ff, cfg.n_experts, pdtype(cfg)

    def experts(shape):
        return (torch.randn(shape, generator=gen, device=device)
                * 0.02).to(dt)
    router = dense_init(gen, d, e, torch.float32, device)
    return MoE(router, experts((e, d, ff)), experts((e, d, ff)),
               experts((e, ff, d)))


def _capacity(cf: float, tokens: int, k: int, buckets: int) -> int:
    """Pairs an expert keeps: Python's ``round`` (half to even) of the
    reference's float expression, at least 1."""
    return int(max(1, round(cf * tokens * k / buckets)))


def _gates(moe: MoE, cfg: ModelConfig, xt: torch.Tensor):
    """The f32 softmax over E of ``xt`` [t, d] and its top-k, sorted
    descending, the gates normalized before any drop: ``(probs [t, E],
    gate_w [t, k], gate_i [t, k])``."""
    probs = torch.softmax(xt.float() @ moe.router, dim=-1)      # [t, E]
    gate_w, gate_i = torch.topk(probs, cfg.top_k, dim=-1)       # [t, k]
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_w, gate_i


def _positions(ids: torch.Tensor, buckets: int,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each pair's position in its bucket ``ids`` [n]: the count of
    (``valid``) pairs before it there. Counted along each bucket's own row
    of [buckets, n], a scan of the inner axis: the scan down the n rows of
    [n, buckets] took 0.39 ms a layer at granite's 256-token chunk (H100
    80GB HBM3, 700 W)."""
    mine = torch.arange(buckets, device=ids.device)[:, None] == ids[None]
    if valid is not None:
        mine = mine & valid[None]
    return torch.cumsum(mine, dim=1).gather(0, ids[None])[0] - 1


def route(moe: MoE, cfg: ModelConfig, xt: torch.Tensor):
    """Routing of t tokens ``xt`` [t, d]: the f32 softmax over E, top-k
    sorted descending, gates normalized before any drop. Returns
    ``(probs [t, E], gate_w [t, k], gate_i [t, k], flat_e [k·t], pos [k·t],
    capacity)``: pairs slot-major (every token's first choice before any
    second), each pair's position in its expert the count of pairs before
    it there."""
    t, e, k = xt.shape[0], cfg.n_experts, cfg.top_k
    probs, gate_w, gate_i = _gates(moe, cfg, xt)
    flat_e = gate_i.T.reshape(-1)                               # [k*t]
    pos = _positions(flat_e, e)
    capacity = min(_capacity(cfg.capacity_factor, t, k, e), t)
    return probs, gate_w, gate_i, flat_e, pos, capacity


def dropped_pairs(moe: MoE, cfg: ModelConfig,
                  x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(pairs dropped at capacity, a 0-d device tensor; pairs routed) for
    ``x`` [B, S, d] -- what ``moe_apply`` drops on the same input."""
    xt = x.reshape(-1, x.shape[-1])
    *_, pos, capacity = route(moe, cfg, xt)
    return (pos >= capacity).sum(), pos.numel()


def _experts(buf: torch.Tensor, e_gate: torch.Tensor, e_up: torch.Tensor,
             e_down: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU over their dispatch rows: buf [E, C, d] ->
    [E, C, d], batched products in the model dtype."""
    h = F.silu(torch.bmm(buf, e_gate)) * torch.bmm(buf, e_up)
    return torch.bmm(h, e_down)


def _aux(cfg: ModelConfig, probs: torch.Tensor, gate_i: torch.Tensor):
    """The load-balance auxiliary loss (Switch-style) of one set of
    routes: the mean router probability and the share of pairs of each
    expert, ``(me [E], ce [E])``, and their loss."""
    t, k = gate_i.shape
    ce = torch.zeros(cfg.n_experts, dtype=torch.float32,
                     device=probs.device).index_add_(
        0, gate_i.reshape(-1), torch.full((t * k,), 1.0 / (t * k),
                                          device=probs.device))
    me = probs.mean(dim=0)
    return me, ce, cfg.router_aux_coef * cfg.n_experts * torch.sum(me * ce)


def moe_apply(moe: MoE, cfg: ModelConfig,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], the load-balance aux loss). Each
    expert takes at most ``capacity`` pairs; a dropped pair adds nothing
    and the kept gates are not renormalized."""
    b, s, d = x.shape
    t, e, k = b * s, cfg.n_experts, cfg.top_k
    xt = x.reshape(t, d)
    probs, gate_w, gate_i, flat_e, pos, cap = route(moe, cfg, xt)
    aux = _aux(cfg, probs, gate_i)[2]

    keep = pos < cap
    slot_w = gate_w.T.reshape(-1) * keep                        # [k*t]
    # dispatch [E, C, d]: kept pairs into their own cells, dropped ones
    # into the slack row C, which the experts never see
    buf = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=x.device)
    buf[flat_e, torch.where(keep, pos, cap)] = xt.repeat(k, 1)
    y_e = _experts(buf[:, :cap], moe.e_gate, moe.e_up, moe.e_down)

    # gather combine: y = sum_i g_i e_i(x), the gate in the model dtype
    vals = y_e[flat_e, torch.where(keep, pos, cap - 1)]         # [k*t, d]
    vals = (vals * slot_w[:, None].to(vals.dtype)).view(k, t, d)
    y = vals[0]
    for i in range(1, k):
        y = y + vals[i]
    return y.view(b, s, d), aux


# ------------------------------------------------ more than one rank
#
# The reference's two multi-rank forms, with the experts split over the
# model axis as ``[r E/N, (r+1) E/N)`` (its ``dest = flat_e // e_loc``):
#
#  * ``moe_apply_ep`` (prefill): rank r takes the contiguous S/N slice of
#    the sequence, packs a capacity-bounded send buffer per destination
#    rank (stage 1), one ``all_to_all`` moves them, the receiver
#    dispatches per expert at a second capacity (stage 2), a second
#    ``all_to_all`` brings the results back, and the gated combine adds
#    them in the model dtype in the reference's scatter order. Where the
#    ranks do not divide E or S it is the one-device ``moe_apply``;
#  * ``moe_apply_ep_decode``: the tokens stay whole on every rank, each
#    rank runs its own experts' pairs (capacity t·k: nothing drops) and a
#    sum all-reduce combines.
#
# Each stage below is one rank's part; ``moe_apply_ep_ref`` runs the N
# ranks' parts in one process, with the collectives replaced by indexing.


def _own_weights(moe: MoE, cfg: ModelConfig, rank: int, n: int):
    """Rank ``rank``'s experts ``[r E/N, (r+1) E/N)``: the leaves as held
    where ``parallel.sharding`` split them, else cut from the whole ones
    (the reference's ``shard_map`` splits experts that its ``param_specs``
    leaves whole)."""
    e_loc = cfg.n_experts // n
    ws = (moe.e_gate, moe.e_up, moe.e_down)
    if moe.e_gate.shape[0] == e_loc:
        return ws
    return tuple(w[rank * e_loc:(rank + 1) * e_loc] for w in ws)


def _own_pairs(moe: MoE, cfg: ModelConfig, xt: torch.Tensor, rank: int,
               n: int, *, decode: bool):
    """Rank ``rank``'s part of the MoE over every token ``xt`` [t, d],
    its own experts' pairs only, summed over each token's pairs in f32:
    at decode (``moe_apply_ep_decode``) every pair at capacity t·k; else
    the one-device ``moe_apply``'s pairs kept at its global capacity.
    Returns ``(partial y [t, d] f32, pairs dropped)``."""
    t, d = xt.shape
    k, e_loc = cfg.top_k, cfg.n_experts // n
    if decode:
        _, gate_w, gate_i = _gates(moe, cfg, xt)
        flat_e = gate_i.T.reshape(-1)
        cap = t * k
        pos = torch.arange(k * t, device=xt.device)
        keep = torch.ones_like(pos, dtype=torch.bool)
    else:
        _, gate_w, _, flat_e, pos, cap = route(moe, cfg, xt)
        keep = pos < cap
    lo = rank * e_loc
    mine = keep & (flat_e >= lo) & (flat_e < lo + e_loc)
    own_e = torch.where(mine, flat_e - lo, 0)
    buf = torch.zeros((e_loc, cap + 1, d), dtype=xt.dtype, device=xt.device)
    buf[own_e, torch.where(mine, pos, cap)] = xt.repeat(k, 1)
    y_e = _experts(buf[:, :cap], *_own_weights(moe, cfg, rank, n))
    vals = y_e[own_e, torch.where(mine, pos, 0)]                 # [k*t, d]
    vals = vals * gate_w.T.reshape(-1)[:, None].to(vals.dtype)
    vals = torch.where(mine[:, None], vals, 0)
    return vals.float().view(k, t, d).sum(0), (~keep).sum()


def _ep_send(moe: MoE, cfg: ModelConfig, xt: torch.Tensor, n: int) -> Dict:
    """Stage 1 on one rank's t tokens ``xt`` [t, d]: route, and pack each
    destination rank's buffer of at most ``cd = round(cf t k / N)`` pairs
    in slot-major priority. ``x`` [N, cd, d] and ``meta`` [N, cd] (the
    expert's local id + 1; 0 for an empty row) are sent; ``dest``,
    ``pos`` and ``keep`` (per pair, [k·t]), ``gate`` [N, cd] and the
    routes' aux statistics stay on the rank."""
    t, d = xt.shape
    k, e_loc = cfg.top_k, cfg.n_experts // n
    probs, gate_w, gate_i = _gates(moe, cfg, xt)
    flat_e = gate_i.T.reshape(-1)                                # [k*t]
    dest = flat_e // e_loc
    cd = _capacity(cfg.capacity_factor, t, k, n)
    pos = _positions(dest, n)
    keep = pos < cd
    cell = (dest, torch.where(keep, pos, cd))       # dropped: slack column
    send_x = torch.zeros((n, cd + 1, d), dtype=xt.dtype, device=xt.device)
    send_x[cell] = xt.repeat(k, 1)
    meta = torch.zeros((n, cd + 1), dtype=torch.int32, device=xt.device)
    meta[cell] = (flat_e % e_loc + 1).to(torch.int32)
    gate = torch.zeros((n, cd + 1), dtype=torch.float32, device=xt.device)
    gate[cell] = gate_w.T.reshape(-1)
    return {"x": send_x[:, :cd], "meta": meta[:, :cd], "gate": gate[:, :cd],
            "dest": dest, "pos": pos, "keep": keep, "t": t,
            "probs": probs, "gate_i": gate_i}


def _ep_experts(weights, cfg: ModelConfig, recv_x: torch.Tensor,
                recv_meta: torch.Tensor, t_all: int):
    """Stage 2 on the receiver: the rows from every source rank, in
    source-rank order ([N, cd, d] and their ``meta``), dispatched to this
    rank's experts at ``round(cf t_all k / E)`` rows each (``t_all`` the
    tokens over all ranks; an empty row takes no position), run, and laid
    back out as the rows came: ([N, cd, d], rows dropped here)."""
    n, cd, d = recv_x.shape
    e_loc = weights[0].shape[0]
    rows = recv_x.reshape(n * cd, d)
    exp = recv_meta.reshape(-1).long() - 1
    ok = exp >= 0
    exp = torch.where(ok, exp, 0)
    cap = _capacity(cfg.capacity_factor, t_all, cfg.top_k, cfg.n_experts)
    pos = _positions(exp, e_loc, ok)
    keep = ok & (pos < cap)
    buf = torch.zeros((e_loc, cap + 1, d), dtype=rows.dtype,
                      device=rows.device)
    buf[exp, torch.where(keep, pos, cap)] = rows
    y_e = _experts(buf[:, :cap], *weights)
    back = torch.where(keep[:, None], y_e[exp, torch.where(keep, pos, 0)], 0)
    return back.view(n, cd, d), (ok & ~keep).sum()


def _ep_combine(ret: torch.Tensor, sent: Dict, k: int) -> torch.Tensor:
    """The gated combine on the sender: ``ret`` [N, cd, d], the rows its
    buffers came back as, scaled by their gates in the model dtype; each
    token's pairs added in the model dtype in the order the reference's
    scatter-add takes its rows (by destination rank, then position: per
    token, its slots in a stable order of their destinations). [t, d]."""
    n, cd, d = ret.shape
    t = sent["t"]
    rows = ret.reshape(n * cd, d) * sent["gate"].reshape(-1)[:, None].to(
        ret.dtype)
    keep = sent["keep"]
    row = sent["dest"] * cd + torch.where(keep, sent["pos"], 0)
    vals = torch.where(keep[:, None], rows[row], 0).view(k, t, d)
    order = torch.sort(sent["dest"].view(k, t), dim=0, stable=True).indices
    vals = vals.gather(0, order[..., None].expand(k, t, d))
    y = vals[0]
    for i in range(1, k):
        y = y + vals[i]
    return y


def _pack(*parts: torch.Tensor) -> torch.Tensor:
    """[N, ...] tensors of any dtypes as one uint8 [N, bytes] message."""
    n = parts[0].shape[0]
    return torch.cat([p.contiguous().view(torch.uint8).reshape(n, -1)
                      for p in parts], dim=1)


def _unpack(msg: torch.Tensor, *likes: torch.Tensor):
    """``_pack``'s inverse: one tensor shaped and typed like each of
    ``likes``."""
    out, at = [], 0
    for like in likes:
        nbytes = like[0].numel() * like.element_size()
        out.append(msg[:, at:at + nbytes].contiguous().view(like.dtype)
                   .view(like.shape))
        at += nbytes
    return out


def _rank(group) -> Tuple[int, int]:
    return (0, 1) if group is None else (group.rank, group.size)


def _size(group) -> int:
    return 1 if group is None else group.size


def moe_apply_ep(moe: MoE, cfg: ModelConfig, x: torch.Tensor, *,
                 group=None, aux: bool = True
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The train / prefill MoE over a rank ``group``'s model axis. x [B,
    S, d], whole on every rank -> (y [B, S, d], whole on every rank; the
    load-balance aux loss over every token, or None without ``aux``: the
    serving path drops it, and its statistics' all-reduce with it). On
    one rank, or where the ranks do not divide E, ``moe_apply``. Where
    they do not divide S (the last chunk of an odd-length prompt) the
    one-device semantics too -- one capacity over all t tokens, with its
    drops -- each rank running its own experts' pairs and a sum
    all-reduce combining. Else the expert-parallel form: 2
    ``all_to_all``s, the sequence all-gathered back, and with ``aux`` one
    all-reduce of the routes' statistics."""
    rank, n = _rank(group)
    b, s, d = x.shape
    if n == 1 or cfg.n_experts % n:
        y, loss = moe_apply(moe, cfg, x)
        return y, loss if aux else None
    if s % n:
        xt = x.reshape(b * s, d)
        part, _ = _own_pairs(moe, cfg, xt, rank, n, decode=False)
        y = group.all_reduce(part, "sum").to(x.dtype).view(b, s, d)
        if not aux:
            return y, None
        probs, _, gate_i = _gates(moe, cfg, xt)
        return y, _aux(cfg, probs, gate_i)[2]
    sl = s // n
    xt = x[:, rank * sl:(rank + 1) * sl].reshape(b * sl, d)
    sent = _ep_send(moe, cfg, xt, n)
    recv = _unpack(group.all_to_all(_pack(sent["x"], sent["meta"])),
                   sent["x"], sent["meta"])
    back, _ = _ep_experts(_own_weights(moe, cfg, rank, n), cfg, *recv,
                          b * s)
    y = _ep_combine(group.all_to_all(back), sent, cfg.top_k)
    y = group.all_gather(y.view(b, sl, d))              # [N, B, S/N, d]
    y = y.permute(1, 0, 2, 3).reshape(b, s, d)
    if not aux:
        return y, None
    me, ce, _ = _aux(cfg, sent["probs"], sent["gate_i"])
    me, ce = group.all_reduce(torch.stack([me, ce]), "sum") / n
    return y, cfg.router_aux_coef * cfg.n_experts * torch.sum(me * ce)


def check_mesh(dp: int, n: int) -> None:
    """Raise for the MoE family on ``dp`` ranks of the batch axes and
    ``n`` of the model axis at once: the reference's ``moe_apply_ep``
    splits the tokens over both in one ``shard_map``, which the one-slot
    prefill batch cannot take (it raises there), so the port refuses the
    mesh too."""
    if dp > 1 and n > 1:
        raise NotImplementedError(
            f"the MoE family on {dp} data ranks and {n} model ranks: the "
            f"reference's moe_apply_ep shards the tokens over (data, "
            f"model) in one shard_map and refuses the one-slot prefill "
            f"batch there; serve MoE over the data axis (model axis 1) or "
            f"the model axis (data axis 1)")


def moe_apply_ep_decode(moe: MoE, cfg: ModelConfig, x: torch.Tensor, *,
                        group=None, batch=None) -> torch.Tensor:
    """The decode MoE over a rank ``group``'s model axis. x [B, 1, d],
    whole on every rank of the model axis. On one rank, or where the
    ranks do not divide E, ``moe_apply``'s output, drops included (the
    reference's "no drops" holds only for its multi-rank form); else each
    rank runs its own experts' pairs, none dropped, and one sum
    all-reduce in f32 combines. With the decode batch's rows split over
    ``batch``, x is this rank's rows: where the model axis splits the
    experts, each rank runs its own experts' pairs of its rows and the
    model axis sums them (the reference's ``shard_map`` over (data,
    model)); else the whole batch is gathered and routed at once, as the
    reference's ``moe_apply`` routes it (one capacity over every token),
    and this rank keeps its rows."""
    rank, n = _rank(group)
    split = n > 1 and not cfg.n_experts % n
    if batch is not None and batch.size > 1 and not split:
        b = x.shape[0]
        whole = batch.all_gather(x).reshape((-1,) + x.shape[1:])
        return moe_apply(moe, cfg, whole)[0][batch.rank * b:
                                             (batch.rank + 1) * b]
    if not split:
        return moe_apply(moe, cfg, x)[0]
    b, s, d = x.shape
    part, _ = _own_pairs(moe, cfg, x.reshape(b * s, d), rank, n,
                         decode=True)
    return group.all_reduce(part, "sum").to(x.dtype).view(b, s, d)


def moe_apply_ep_ref(moe: MoE, cfg: ModelConfig, x: torch.Tensor,
                     n_ranks: int, *, decode: bool = False
                     ) -> Tuple[torch.Tensor, Dict[str, int]]:
    """The plain version of ``moe_apply_ep`` (``decode``:
    ``moe_apply_ep_decode``) on ``n_ranks`` ranks, all run in this process
    in a loop, with whole experts ``moe`` and no collective: each
    ``all_to_all`` is an exchange of the ranks' buffers, each all-reduce
    a sum in rank order. Returns (y, the pairs dropped: ``"dispatch"`` at
    stage 1's per-destination capacity, ``"expert"`` at an expert's
    capacity -- the one-device ``moe_apply``'s where that is the form)."""
    b, s, d = x.shape
    k = cfg.top_k
    n = n_ranks
    if n == 1 or cfg.n_experts % n:
        y = moe_apply(moe, cfg, x)[0]
        return y, {"dispatch": 0, "expert": int(dropped_pairs(moe, cfg, x)[0])}
    if decode or s % n:
        xt = x.reshape(b * s, d)
        parts = [_own_pairs(moe, cfg, xt, r, n, decode=decode)
                 for r in range(n)]
        y = parts[0][0]
        for part, _ in parts[1:]:
            y = y + part
        return (y.to(x.dtype).view(b, s, d),
                {"dispatch": 0, "expert": int(parts[0][1])})
    sl = s // n
    sent = [_ep_send(moe, cfg, x[:, r * sl:(r + 1) * sl].reshape(-1, d), n)
            for r in range(n)]
    back, dropped = [], 0
    for r in range(n):
        recv_x = torch.stack([sent[src]["x"][r] for src in range(n)])
        recv_meta = torch.stack([sent[src]["meta"][r] for src in range(n)])
        rows, lost = _ep_experts(_own_weights(moe, cfg, r, n), cfg, recv_x,
                                 recv_meta, b * s)
        back.append(rows)
        dropped += int(lost)
    ys = [_ep_combine(torch.stack([back[dst][r] for dst in range(n)]),
                      sent[r], k).view(b, sl, d) for r in range(n)]
    return torch.cat(ys, dim=1), {
        "dispatch": sum(int((~m["keep"]).sum()) for m in sent),
        "expert": dropped}


def moe_apply_ep_loop(moe: MoE, cfg: ModelConfig, x: torch.Tensor,
                      n_ranks: int, *, decode: bool = False
                      ) -> Tuple[torch.Tensor, Dict[str, int]]:
    """A second plain version of ``moe_apply_ep`` (``decode``:
    ``moe_apply_ep_decode``) on ``n_ranks`` ranks, written apart from the
    helpers the forms above share with ``moe_apply_ep_ref``: the kept
    pairs are chosen on the host one pair at a time, in the reference's
    priority (slot-major; at stage 2 in source-rank order), each expert
    runs on the tokens it kept, and each pair's output times its gate (in
    the model dtype) is added to its token in f32, cast once. Returns (y,
    the pairs dropped, as ``moe_apply_ep_ref`` counts them)."""
    b, s, d = x.shape
    e, k, n = cfg.n_experts, cfg.top_k, n_ranks
    t = b * s
    xt = x.reshape(t, d)

    def capacity(tokens, buckets):
        return int(max(1, round(cfg.capacity_factor * tokens * k / buckets)))

    probs = torch.softmax(xt.float() @ moe.router, dim=-1)
    gate_w, gate_i = torch.topk(probs, k, dim=-1)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    choice = gate_i.tolist()                                    # [t][k]
    kept, drops = [], {"dispatch": 0, "expert": 0}
    if n > 1 and not e % n and decode:
        kept = [(i, j) for j in range(k) for i in range(t)]
    elif n == 1 or e % n or s % n:           # one capacity over all t
        cap, used = min(capacity(t, e), t), [0] * e
        for j in range(k):
            for i in range(t):
                if used[choice[i][j]] < cap:
                    used[choice[i][j]] += 1
                    kept.append((i, j))
                else:
                    drops["expert"] += 1
    else:
        e_loc, sl = e // n, s // n
        cd, ce_cap = capacity(b * sl, n), capacity(t, e)
        sent = [[[] for _ in range(n)] for _ in range(n)]  # [src][dst]
        for src in range(n):
            mine = [bi * s + src * sl + si for bi in range(b)
                    for si in range(sl)]
            for j in range(k):
                for i in mine:
                    rows = sent[src][choice[i][j] // e_loc]
                    if len(rows) < cd:
                        rows.append((i, j))
                    else:
                        drops["dispatch"] += 1
        for dst in range(n):
            used = [0] * e
            for src in range(n):
                for i, j in sent[src][dst]:
                    if used[choice[i][j]] < ce_cap:
                        used[choice[i][j]] += 1
                        kept.append((i, j))
                    else:
                        drops["expert"] += 1
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    by_expert: Dict[int, list] = {}
    for i, j in kept:
        by_expert.setdefault(choice[i][j], []).append((i, j))
    for ex, pairs in by_expert.items():
        tok = torch.tensor([i for i, _ in pairs], device=x.device)
        slot = torch.tensor([j for _, j in pairs], device=x.device)
        h = F.silu(xt[tok] @ moe.e_gate[ex]) * (xt[tok] @ moe.e_up[ex])
        out = (h @ moe.e_down[ex]) * gate_w[tok, slot][:, None].to(x.dtype)
        y.index_add_(0, tok, out.float())
    return y.to(x.dtype).view(b, s, d), drops


class _Routes(NamedTuple):
    """The router and the experts as ``route`` / ``moe_apply`` read them
    off an ``MoE``: the leaves a training rank runs through ``copy_in``
    or gathers."""

    router: torch.Tensor
    e_gate: torch.Tensor
    e_up: torch.Tensor
    e_down: torch.Tensor


def moe_apply_ep_train(moe: MoE, cfg: ModelConfig, x: torch.Tensor, *,
                       group, data=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's expert-parallel ``moe_apply_ep`` under grad over a
    model ``group`` of N ranks (E and S divisible by N): the tokens
    sharded over (data, model) -- ``x`` [B, S, d] this data rank's rows,
    whole on every model rank, of which model rank m routes the sequence
    slice [m S/N, (m+1) S/N) -- at the stage-1 capacity of its own t
    tokens and the stage-2 capacity of the data row's t N, the two
    ``all_to_all``s differentiable (``sharding.all_to_all_grad``) and the
    rows gathered back over the sequence (each rank keeping its slice's
    gradient). The router, and experts that ``param_specs`` leaves whole,
    enter through ``copy_in``: each rank's gradient is its tokens' share.
    Returns (y [B, S, d], this data rank's load-balance term): ``ce``,
    each expert's share of the routes, is the mean over the ``data`` and
    model ranks, as the reference's ``pmean`` takes it;
    ``me``, the mean router probability, the mean over the model ranks
    here, so that the data ranks' terms average to the reference's loss
    (the training loss is their mean, ``sharding.mean_over``)."""
    rank, n = group.rank, group.size
    b, s, d = x.shape
    sl = s // n
    x = sharding.copy_in(group, x)
    own = _own_weights(moe, cfg, rank, n)
    if moe.e_gate.shape[0] != own[0].shape[0]:        # whole experts
        e_loc = cfg.n_experts // n
        own = tuple(sharding.copy_in(group, w)[rank * e_loc:
                                               (rank + 1) * e_loc]
                    for w in (moe.e_gate, moe.e_up, moe.e_down))
    routes = _Routes(sharding.copy_in(group, moe.router), *own)
    xt = x[:, rank * sl:(rank + 1) * sl].reshape(b * sl, d)
    sent = _ep_send(routes, cfg, xt, n)
    recv_x, recv_meta = sharding.all_to_all_grad(group, sent["x"],
                                                 sent["meta"])
    back, _ = _ep_experts(own, cfg, recv_x, recv_meta, b * s)
    y = _ep_combine(sharding.all_to_all_grad(group, back), sent, cfg.top_k)
    y = sharding.gather_cols(group, y.view(b, sl, d), dim=1)
    me, ce, _ = _aux(cfg, sent["probs"], sent["gate_i"])
    me = sharding.reduce_out(group, me) / n
    ce = group.all_reduce(ce.detach().clone(), "sum") / n
    if data is not None and data.size > 1:
        ce = data.all_reduce(ce, "sum") / data.size
    return y, cfg.router_aux_coef * cfg.n_experts * torch.sum(me * ce)


def moe_block_apply(block: nn.Module, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool = True,
                    kv_block: int = 512, batch=None, group=None, data=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full-sequence forward of an MoE block (``ln_attn``, ``attn``,
    ``ln_mlp``, ``moe``; training). x: [B, S, d] -> (x, the load-balance
    aux loss). The attention is the plain ``chunked_attention`` (the
    reference passes no softcap and no kernel route here). With the
    batch's rows split over a rank group ``batch`` (training at (D, 1)),
    x is this rank's rows: the MoE input is gathered over the group
    (``sharding.gather_rows``, whose backward sums each rank's rows'
    gradients back to it) and the whole batch routed at once, as the
    reference's ``moe_apply`` routes its global batch on a model axis of
    one -- one capacity over every token, positions in global token order
    -- and this rank keeps its rows; the aux loss is the whole batch's,
    the same on every rank.

    Over a model ``group`` of N > 1 ranks (x whole on every model rank)
    the attention is this rank's heads (``attention.attention_train``)
    and, where N divides E and S, the MoE the reference's expert-parallel
    form over (``data``, model) (``moe_apply_ep_train``): where the batch
    splits over (pod, data) (``multi_pod``) the reference still shards the
    tokens over the data axis alone, so the rows are gathered over the
    batch group, this data rank's block routed, and its output gathered
    over the data axis for this rank's rows. Else the reference falls back
    to ``moe_apply`` over the global batch, which every model rank runs
    whole (its experts gathered where they are split)."""
    if group is not None and group.size > 1:
        x = attn.attention_train(block, cfg, x, positions, group,
                                 causal=causal, kv_block=kv_block)
        h = rmsnorm(block.ln_mlp, x, cfg.norm_eps)
        n, b = group.size, x.shape[0]
        if not cfg.n_experts % n and not x.shape[1] % n:
            if _size(batch) == _size(data):
                y, aux = moe_apply_ep_train(block.moe, cfg, h, group=group,
                                            data=data)
                return x + y, aux
            rows = sharding.gather_rows(batch, h)
            k = rows.shape[0] // _size(data)
            lo = (0 if data is None else data.rank) * k
            y, aux = moe_apply_ep_train(block.moe, cfg, rows[lo:lo + k],
                                        group=group, data=data)
            y = sharding.gather_rows(data, y)
            return x + y[batch.rank * b:(batch.rank + 1) * b], aux
        whole = block.moe
        if whole.e_gate.shape[0] != cfg.n_experts:
            whole = _Routes(whole.router, *(
                sharding.gather_cols(group, w, dim=0)
                for w in (whole.e_gate, whole.e_up, whole.e_down)))
        rows = (sharding.gather_rows(batch, h) if batch is not None
                else h)
        y, aux = moe_apply(whole, cfg, rows)
        if batch is not None and batch.size > 1:
            y = y[batch.rank * b:(batch.rank + 1) * b]
        return x + y, aux
    h = rmsnorm(block.ln_attn, x, cfg.norm_eps)
    q, k, v = attn.qkv_project(block.attn, cfg, h, positions)
    o = attn.chunked_attention(q, k, v, causal=causal, kv_block=kv_block)
    b, s = x.shape[0], x.shape[1]
    x = x + o.reshape(b, s, cfg.q_dim) @ block.attn.wo
    h = rmsnorm(block.ln_mlp, x, cfg.norm_eps)
    if batch is not None and batch.size > 1:
        y, aux = moe_apply(block.moe, cfg, sharding.gather_rows(batch, h))
        return x + y[batch.rank * b:(batch.rank + 1) * b], aux
    y, aux = moe_apply_ep(block.moe, cfg, h)
    return x + y, aux
