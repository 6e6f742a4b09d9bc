"""xLSTM blocks for serving: the recurrent mLSTM and sLSTM steps.

mLSTM per head: C_t = f_t C_{t-1} + i_t v_t k_t^T, n_t = f_t n_{t-1} + i_t
k_t, h_t = (C_t q_t) / max(|n_t.q_t|, exp(-m_t)) with exponential gates
stabilized by m_t; its output is gated by the block's silu branch. sLSTM:
scalar cells with a per-head recurrent gate matrix, then a SwiGLU FFN.

Only the recurrent steps are ported (the reference's ``mlstm_step`` and
``slstm_step``), taken over S tokens at once: the reference's prefill
scans ``decode_step`` over a chunk, and S steps here compute what S of its
calls do -- each memory update and each sLSTM cell token by token, from
the state the previous token left -- with the projections, the conv and
the FFN once for the S tokens. The training forms (``mlstm_apply``,
``slstm_apply``, which start from a zero state and carry no conv window)
are not needed here. No Pallas kernel exists for either block: the steps
are plain PyTorch, as the reference's are plain jnp. The states and the
conv windows are f32; every product keeps the reference's dtypes (the
gate weights ``w_gates`` (mLSTM) and ``r_gates`` (sLSTM) are f32, as are
the operands they meet).

Over a rank ``group`` (serving at tp > 1) each rank holds its shard of
the weights (``parallel.sharding``): the columns of ``w_up1`` /
``w_up2`` / ``w_qkv`` and the sLSTM's ``w_gates``, the channels of
``conv_w``, the rows of ``w_down2``, ``w_out`` and the FFN's ``w_down``;
the mLSTM's ``w_gates`` and both ``r_gates`` stay whole (16 divides
neither gate axis), and so do the cells, which every rank runs whole on
its whole states, as the reference's ``cache_specs`` leaves them. The
column products are gathered whole before they are cut (``w_qkv``'s
split falls inside k), each rank convolves its channels and the outputs
are gathered, and the row-split products sum across the ranks in f32.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (MLP, RMSNorm, dense_init,
                                       frozen_param, pdtype, rmsnorm)
from repro_torch.parallel import sharding

# the conv window both blocks carry: 4 taps, 3 past inputs in the state
CONV = 4


def _dims(cfg: ModelConfig):
    d_in = cfg.mlstm_expand * cfg.d_model
    nh = cfg.n_heads
    return d_in, nh, d_in // nh


def _ffn_width(d: int) -> int:
    return max(1, int(d * 4 / 3) // 64 * 64)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


class MLSTM(nn.Module):
    """One mLSTM layer's weights, named as the reference's pytree: ``ln``,
    ``w_up1`` / ``w_up2`` ([d, d_in]), ``conv_w`` ([4, d_in]), ``w_qkv``
    ([d_in, 3 d_in]), f32 ``w_gates`` ([d_in, 2 nh]) and ``gate_bias``
    ([2 nh]), ``ln_head`` and ``w_down2`` ([d_in, d])."""

    def __init__(self, ln: RMSNorm, w_up1, w_up2, conv_w, w_qkv, w_gates,
                 gate_bias, ln_head: RMSNorm, w_down2):
        super().__init__()
        self.ln = ln
        self.w_up1, self.w_up2, self.conv_w, self.w_qkv = (
            frozen_param(w) for w in (w_up1, w_up2, conv_w, w_qkv))
        self.w_gates = frozen_param(w_gates)
        self.gate_bias = frozen_param(gate_bias)
        self.ln_head = ln_head
        self.w_down2 = frozen_param(w_down2)


def mlstm_init(gen: torch.Generator, cfg: ModelConfig, device) -> MLSTM:
    """Draw one mLSTM layer from ``gen``; ``gate_bias`` is the reference's
    fixed value (input gates 0, forget gates 3 + 0.5 h)."""
    d, dt = cfg.d_model, pdtype(cfg)
    d_in, nh, _ = _dims(cfg)
    w_up1 = dense_init(gen, d, d_in, dt, device)
    w_up2 = dense_init(gen, d, d_in, dt, device)
    conv_w = (torch.randn((CONV, d_in), generator=gen, device=device)
              * 0.1).to(dt)
    w_qkv = dense_init(gen, d_in, 3 * d_in, dt, device)
    w_gates = dense_init(gen, d_in, 2 * nh, torch.float32, device)
    f32 = dict(dtype=torch.float32, device=device)
    gate_bias = torch.cat([torch.zeros(nh, **f32),
                           3.0 + torch.arange(nh, **f32) * 0.5])
    w_down2 = dense_init(gen, d_in, d, dt, device)
    return MLSTM(RMSNorm.ones(d, dt, device), w_up1, w_up2, conv_w, w_qkv,
                 w_gates, gate_bias, RMSNorm.ones(d_in, dt, device), w_down2)


def _conv(conv: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
          group=None):
    """The causal conv over S new inputs in f32. conv: [B, 3, C] (the
    carried inputs); x: [B, S, C]; w: [4, C] -> (silu of each token's
    window of 4 taps [B, S, C], the last 3 inputs as the new ``conv``).
    With ``w`` split over a rank ``group`` on its channels, each rank
    convolves its channels and the outputs are gathered whole."""
    full = torch.cat([conv, x.float()], dim=1)                # [B, 3+S, C]
    width = full.shape[-1]
    lo, n = sharding.held_range(group, w.shape[1], width)
    windows = full[..., lo:lo + n].unfold(1, CONV, 1)         # [B, S, n, 4]
    out = F.silu(torch.einsum("bscw,wc->bsc", windows, w.float()))
    return (sharding.whole_columns(group, out, width),
            full[:, full.shape[1] - (CONV - 1):])


def _mlstm_cell(q, k, v, ig, fg, state: Dict[str, torch.Tensor]):
    """One token's matrix-memory update and read, f32. q/k/v: [B, nh,
    dh]; ig/fg: [B, nh] (fg in log space) -> (h [B, nh, dh], the new C /
    n / m)."""
    m_new = torch.maximum(fg + state["m"], ig)
    i_s = torch.exp(ig - m_new)
    f_s = torch.exp(fg + state["m"] - m_new)
    C = (f_s[..., None, None] * state["C"]
         + i_s[..., None, None] * torch.einsum("bhd,bhe->bhde", v, k))
    n = f_s[..., None] * state["n"] + i_s[..., None] * k
    num = torch.einsum("bhde,bhe->bhd", C, q)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n, q).abs(),
                        torch.exp(-m_new))
    return num / den[..., None], {"C": C, "n": n, "m": m_new}


def mlstm_step(m: MLSTM, cfg: ModelConfig, x: torch.Tensor,
               state: Dict[str, torch.Tensor], group=None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Recurrent steps over S tokens, with the residual. x: [B, S, d];
    state ``C`` [B, nh, dh, dh], ``n`` [B, nh, dh], ``m`` [B, nh],
    ``conv`` [B, 3, d_in] (f32) -> ([B, S, d], the state after the last
    token). S = 1 is the reference's ``mlstm_step``; S > 1 equals S calls
    of it (the prefill scan): the memory updates token by token, the
    projections once for the S tokens. Over a rank ``group``, on this
    rank's shard of the weights (module docstring)."""
    d_in, nh, dh = _dims(cfg)
    b, s = x.shape[:2]
    h = rmsnorm(m.ln, x, cfg.norm_eps)
    u = sharding.whole_columns(group, h @ m.w_up1, d_in)
    zg = h @ m.w_up2
    c, conv = _conv(state["conv"], u, m.conv_w, group)
    q, k, _ = sharding.whole_columns(group, c.to(x.dtype) @ m.w_qkv,
                                     3 * d_in).chunk(3, dim=-1)
    gates = sharding.whole_columns(group, c @ m.w_gates, 2 * nh)
    ig, fg = (gates + m.gate_bias).chunk(2, dim=-1)          # [B, S, nh]
    fg = F.logsigmoid(fg)
    q = q.reshape(b, s, nh, dh).float() / (dh ** 0.5)
    k = k.reshape(b, s, nh, dh).float()
    v = u.reshape(b, s, nh, dh).float()  # the value branch: pre-conv u
    cell = {n: state[n] for n in ("C", "n", "m")}
    hs = []
    for t in range(s):
        ht, cell = _mlstm_cell(q[:, t], k[:, t], v[:, t], ig[:, t],
                               fg[:, t], cell)
        hs.append(ht)
    hq = torch.stack(hs, dim=1).reshape(b, s, d_in).to(x.dtype)
    # this rank's channels of the gated output against its w_down2 rows
    lo, n = sharding.held_range(group, zg.shape[-1], d_in)
    hq = rmsnorm(m.ln_head, hq, cfg.norm_eps)[..., lo:lo + n] * F.silu(zg)
    return (x + sharding.row_product(group, hq, m.w_down2, d_in),
            {**cell, "conv": conv})


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


class SLSTM(nn.Module):
    """One sLSTM layer's weights, named as the reference's pytree: ``ln``,
    ``conv_w`` ([4, d]), ``w_gates`` ([d, 4d]), f32 ``r_gates`` ([nh, dh,
    4 dh]) and ``gate_bias`` ([4d]), ``w_out`` ([d, d]), ``ln_ff`` and the
    SwiGLU ``ffn``."""

    def __init__(self, ln: RMSNorm, conv_w, w_gates, r_gates, gate_bias,
                 w_out, ln_ff: RMSNorm, ffn: MLP):
        super().__init__()
        self.ln = ln
        self.conv_w, self.w_gates = (frozen_param(w)
                                     for w in (conv_w, w_gates))
        self.r_gates = frozen_param(r_gates)
        self.gate_bias = frozen_param(gate_bias)
        self.w_out = frozen_param(w_out)
        self.ln_ff = ln_ff
        self.ffn = ffn


def slstm_init(gen: torch.Generator, cfg: ModelConfig, device) -> SLSTM:
    """Draw one sLSTM layer from ``gen`` (zero ``gate_bias``, as the
    reference)."""
    d, dt = cfg.d_model, pdtype(cfg)
    nh = cfg.n_heads
    dh = d // nh
    ff = _ffn_width(d)
    conv_w = (torch.randn((CONV, d), generator=gen, device=device)
              * 0.1).to(dt)
    w_gates = dense_init(gen, d, 4 * d, dt, device)
    r_gates = torch.randn((nh, dh, 4 * dh), generator=gen,
                          device=device) * 0.02
    w_out = dense_init(gen, d, d, dt, device)
    w_gate = dense_init(gen, d, ff, dt, device)
    w_up = dense_init(gen, d, ff, dt, device)
    ffn = MLP(w_up, dense_init(gen, ff, d, dt, device), w_gate)
    return SLSTM(RMSNorm.ones(d, dt, device), conv_w, w_gates, r_gates,
                 torch.zeros(4 * d, dtype=torch.float32, device=device),
                 w_out, RMSNorm.ones(d, dt, device), ffn)


def _slstm_cell(gates: torch.Tensor, state: Dict[str, torch.Tensor],
                nh: int, dh: int):
    """gates: [B, 4d] raw (f32, each unit's four gates adjacent) ->
    (h [B, nh, dh], the new h / c / n / m)."""
    g = gates.reshape(gates.shape[0], nh, dh, 4)
    ig, fg, zg, og = g[..., 0], g[..., 1], g[..., 2], g[..., 3]
    m_new = torch.maximum(fg + state["m"], ig)
    i_s = torch.exp(ig - m_new)
    f_s = torch.exp(fg + state["m"] - m_new)
    c = f_s * state["c"] + i_s * torch.tanh(zg)
    n = f_s * state["n"] + i_s
    h = torch.sigmoid(og) * c / torch.clamp(n, min=1e-6)
    return h, {"h": h, "c": c, "n": n, "m": m_new}


def slstm_step(s: SLSTM, cfg: ModelConfig, x: torch.Tensor,
               state: Dict[str, torch.Tensor], group=None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Recurrent steps over S tokens, with the residual and the FFN. x:
    [B, S, d]; state ``h`` / ``c`` / ``n`` / ``m`` [B, nh, dh] and
    ``conv`` [B, 3, d] (f32) -> ([B, S, d], the state after the last
    token). S = 1 is the reference's ``slstm_step``; S > 1 equals S calls
    of it: the cells (and their recurrent gates) token by token, the
    projections and the FFN once for the S tokens. Over a rank
    ``group``, on this rank's shard of the weights (module docstring)."""
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    b, n_tok = x.shape[:2]
    hpre = rmsnorm(s.ln, x, cfg.norm_eps)
    c_in, conv = _conv(state["conv"], hpre, s.conv_w, group)
    wx = sharding.whole_columns(group, c_in.to(x.dtype) @ s.w_gates, 4 * d)
    wx = wx.float() + s.gate_bias                              # [B, S, 4d]
    cell = {n: state[n] for n in ("h", "c", "n", "m")}
    hs = []
    for t in range(n_tok):
        rec = torch.einsum("bhd,hde->bhe", cell["h"],
                           s.r_gates).reshape(b, 4 * d)
        ht, cell = _slstm_cell(wx[:, t] + rec, cell, nh, dh)
        hs.append(ht)
    h = torch.stack(hs, dim=1).reshape(b, n_tok, d)
    x = x + sharding.row_product(group, h.to(x.dtype), s.w_out, d)
    h2 = rmsnorm(s.ln_ff, x, cfg.norm_eps)
    y = F.silu(h2 @ s.ffn.w_gate) * (h2 @ s.ffn.w_up)
    return (x + sharding.row_product(group, y, s.ffn.w_down,
                                     _ffn_width(d)),
            {**cell, "conv": conv})
