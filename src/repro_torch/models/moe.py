"""Mixture-of-Experts layer: top-k routing at a fixed expert capacity.

The port of the reference's ``repro.models.moe`` for one device. There,
``moe_apply_ep`` (prefill) and ``moe_apply_ep_decode`` (decode) fall back
to ``moe_apply`` when the model axis has one rank, so on one device both
drop (token, expert) pairs past each expert's capacity
``round(capacity_factor · t · k / E)`` -- at decode too, where t counts
every slot of the tick, idle ones included. The expert-parallel forms
(all_to_all dispatch, psum combine) are not ported: they raise for more
than one rank, as the page-sharded decode does. ``moe_block_apply`` is the
training forward of a whole MoE block; ``moe_apply`` returns the
load-balance aux loss the training loss adds.

Routing is f32 (router weight, softmax); the experts' products run in the
model dtype as batched matmuls. The dispatch buffer is written without
accumulation -- each kept pair owns its (expert, position) cell and the
dropped pairs all land in one slack row that is never read -- so it is
bit-stable run to run on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense_init, frozen_param, pdtype,
                                       rmsnorm)


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


def route(moe: MoE, cfg: ModelConfig, xt: torch.Tensor):
    """Routing of t tokens ``xt`` [t, d]: the f32 softmax over E, top-k
    sorted descending, gates normalized before any drop. Returns
    ``(probs [t, E], gate_w [t, k], gate_i [t, k], flat_e [k·t], pos [k·t],
    capacity)``: pairs slot-major (every token's first choice before any
    second), each pair's position in its expert the count of pairs before
    it there."""
    t, e, k = xt.shape[0], cfg.n_experts, cfg.top_k
    probs = torch.softmax(xt.float() @ moe.router, dim=-1)      # [t, E]
    gate_w, gate_i = torch.topk(probs, k, dim=-1)               # [t, k]
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = gate_i.T.reshape(-1)                               # [k*t]
    # each expert's pairs counted along its own row of [E, k*t], a scan of
    # the inner axis: the scan down the k*t rows of [k*t, E] took 0.39 ms
    # a layer at granite's 256-token chunk (H100 80GB HBM3, 700 W)
    mine = torch.arange(e, device=xt.device)[:, None] == flat_e[None]
    pos = torch.cumsum(mine, dim=1).gather(0, flat_e[None])[0] - 1
    capacity = min(_capacity(cfg.capacity_factor, t, k, e), t)
    return probs, gate_w, gate_i, flat_e, pos, capacity


def dropped_pairs(moe: MoE, cfg: ModelConfig,
                  x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(pairs dropped at capacity, a 0-d device tensor; pairs routed) for
    ``x`` [B, S, d] -- what ``moe_apply`` drops on the same input."""
    xt = x.reshape(-1, x.shape[-1])
    *_, pos, capacity = route(moe, cfg, xt)
    return (pos >= capacity).sum(), pos.numel()


def moe_apply(moe: MoE, cfg: ModelConfig,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], the load-balance aux loss). Each
    expert takes at most ``capacity`` pairs; a dropped pair adds nothing
    and the kept gates are not renormalized."""
    b, s, d = x.shape
    t, e, k = b * s, cfg.n_experts, cfg.top_k
    xt = x.reshape(t, d)
    probs, gate_w, gate_i, flat_e, pos, cap = route(moe, cfg, xt)

    # load-balance auxiliary loss (Switch-style)
    ce = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, gate_i.reshape(-1), torch.full((t * k,), 1.0 / (t * k),
                                          device=x.device))
    aux = cfg.router_aux_coef * e * torch.sum(probs.mean(dim=0) * ce)

    keep = pos < cap
    slot_w = gate_w.T.reshape(-1) * keep                        # [k*t]
    # dispatch [E, C, d]: kept pairs into their own cells, dropped ones
    # into the slack row C, which the experts never see
    buf = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=x.device)
    buf[flat_e, torch.where(keep, pos, cap)] = xt.repeat(k, 1)
    buf = buf[:, :cap]
    h = F.silu(torch.bmm(buf, moe.e_gate)) * torch.bmm(buf, moe.e_up)
    y_e = torch.bmm(h, moe.e_down)                              # [E, C, d]

    # gather combine: y = sum_i g_i e_i(x), the gate in the model dtype
    vals = y_e[flat_e, torch.where(keep, pos, cap - 1)]         # [k*t, d]
    vals = (vals * slot_w[:, None].to(vals.dtype)).view(k, t, d)
    y = vals[0]
    for i in range(1, k):
        y = y + vals[i]
    return y.view(b, s, d), aux


def _one_rank(n_ranks: int) -> None:
    if n_ranks > 1:
        raise NotImplementedError("expert-parallel (multi-rank) MoE is not "
                                  "ported yet")


def moe_apply_ep(moe: MoE, cfg: ModelConfig, x: torch.Tensor, *,
                 n_ranks: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The train / prefill MoE: on one rank, ``moe_apply`` (the
    reference's fallback for a model axis of 1)."""
    _one_rank(n_ranks)
    return moe_apply(moe, cfg, x)


def moe_apply_ep_decode(moe: MoE, cfg: ModelConfig, x: torch.Tensor, *,
                        n_ranks: int = 1) -> torch.Tensor:
    """The decode MoE: on one rank, ``moe_apply``'s output, drops included
    (the reference's "no drops" holds only for its multi-rank form)."""
    _one_rank(n_ranks)
    return moe_apply(moe, cfg, x)[0]


def moe_block_apply(block: nn.Module, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool = True,
                    kv_block: int = 512, n_ranks: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full-sequence forward of an MoE block (``ln_attn``, ``attn``,
    ``ln_mlp``, ``moe``; training). x: [B, S, d] -> (x, the load-balance
    aux loss). The attention is the plain ``chunked_attention`` (the
    reference passes no softcap and no kernel route here)."""
    h = rmsnorm(block.ln_attn, x, cfg.norm_eps)
    q, k, v = attn.qkv_project(block.attn, cfg, h, positions)
    o = attn.chunked_attention(q, k, v, causal=causal, kv_block=kv_block)
    b, s = x.shape[0], x.shape[1]
    x = x + o.reshape(b, s, cfg.q_dim) @ block.attn.wo
    h = rmsnorm(block.ln_mlp, x, cfg.norm_eps)
    y, aux = moe_apply_ep(block.moe, cfg, h, n_ranks=n_ranks)
    return x + y, aux
