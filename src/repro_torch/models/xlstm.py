"""xLSTM blocks: the recurrent mLSTM and sLSTM steps (serving) and their
training forms.

mLSTM per head: C_t = f_t C_{t-1} + i_t v_t k_t^T, n_t = f_t n_{t-1} + i_t
k_t, h_t = (C_t q_t) / max(|n_t.q_t|, exp(-m_t)) with exponential gates
stabilized by m_t; its output is gated by the block's silu branch. sLSTM:
scalar cells with a per-head recurrent gate matrix, then a SwiGLU FFN.

The recurrent steps (the reference's ``mlstm_step`` and ``slstm_step``)
are taken over S tokens at once: the reference's prefill scans
``decode_step`` over a chunk, and S steps here compute what S of its
calls do -- each memory update and each sLSTM cell token by token, from
the state the previous token left -- with the projections, the conv and
the FFN once for the S tokens. The states and the conv windows are f32;
every product keeps the reference's dtypes (the gate weights ``w_gates``
(mLSTM) and ``r_gates`` (sLSTM) are f32, as are the operands they meet).

The training forms (``mlstm_apply``, ``slstm_apply``) start from the
state initialisers' zero state (m -1e9, the sLSTM's n 1e-6) and carry no
conv window: their conv pads the sequence with zeros and runs in the
model dtype, as the reference's ``_causal_conv``. ``mlstm_apply`` is the
reference's chunkwise form (an intra-chunk quadratic part and an
inter-chunk state carry, chunks of ``min(256, S)`` tokens; its
stabilizers ``m_loc`` and ``m_new`` are detached, as the reference's
``stop_gradient`` leaves them); ``slstm_apply`` the sequential scan of
the cells. No Pallas kernel exists for either block: both are plain
PyTorch, as the reference's are plain jnp; over the FSDP axes the
training path gathers the weights before use.

Over a rank ``group`` of the model axis (serving at tp > 1, and
training) each rank holds its shard of
the weights (``parallel.sharding``): the columns of ``w_up1`` /
``w_up2`` / ``w_qkv`` and the sLSTM's ``w_gates``, the channels of
``conv_w``, the rows of ``w_down2``, ``w_out`` and the FFN's ``w_down``;
the mLSTM's ``w_gates`` and both ``r_gates`` stay whole (16 divides
neither gate axis), and so do the cells, which every rank runs whole on
its whole states, as the reference's ``cache_specs`` leaves them. The
column products are gathered whole before they are cut (``w_qkv``'s
split falls inside k), each rank convolves its channels and the outputs
are gathered, and the row-split products sum across the ranks in f32.
In training the cells are whole on every rank too, and so is the rest
of each layer: its split leaves are gathered whole, differentiably, and
every rank computes the layer as one rank does (``mlstm_apply``,
``slstm_apply``).
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


# the reference's mask value for the intra-chunk log weights past the
# diagonal
NEG = -1e30


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The training forms' causal conv from zeros, in ``x``'s dtype (the
    reference's ``_causal_conv``). x: [B, S, C]; w: [4, C]."""
    width = w.shape[0]
    out = x * w[-1]
    for j in range(1, width):
        shifted = F.pad(x, (0, 0, j, 0))[:, :-j]
        out = out + shifted * w[width - 1 - j]
    return out


def _mlstm_chunk(carry, qq, kk, vv, ii, ff, causal):
    """One chunk of the chunkwise mLSTM, f32. carry: C [B, nh, dh, dh], n
    [B, nh, dh], m [B, nh]; qq / kk / vv [B, Q, nh, dh] (qq scaled); ii /
    ff [B, Q, nh] (ff in log space) -> (h [B, Q, nh, dh], the carry at the
    chunk's end)."""
    C, n, m = carry
    Fc = torch.cumsum(ff, dim=1)                              # [B, Q, nh]
    # intra-chunk log weights D[t, s] = F[t] - F[s] + i[s]
    logd = Fc[:, :, None, :] - Fc[:, None, :, :] + ii[:, None, :, :]
    logd = torch.where(causal[None, :, :, None], logd,
                       torch.full_like(logd, NEG))            # [B, Q, Q, nh]
    b_inter = Fc + m[:, None, :]                              # [B, Q, nh]
    m_loc = torch.maximum(logd.amax(dim=2), b_inter).detach()
    dmat = torch.exp(logd - m_loc[:, :, None, :])
    sc = torch.einsum("bqhd,bshd->bqsh", qq, kk)
    w_inter = torch.exp(b_inter - m_loc)
    num = (torch.einsum("bqsh,bqsh,bshd->bqhd", sc, dmat, vv)
           + torch.einsum("bqh,bhde,bqhe->bqhd", w_inter, C, qq))
    den_vec = torch.einsum("bqsh,bshd->bqhd", dmat, kk)
    den = (torch.einsum("bqhd,bqhd->bqh", den_vec, qq)
           + w_inter * torch.einsum("bhd,bqhd->bqh", n, qq))
    den = torch.maximum(den.abs(), torch.exp(-m_loc))
    hq = num / den[..., None]
    # the state at the chunk's end
    f_last = Fc[:, -1, :]                                     # [B, nh]
    tail = f_last[:, None, :] - Fc + ii                       # [B, Q, nh]
    m_new = torch.maximum(f_last + m, tail.amax(dim=1)).detach()
    r = torch.exp(f_last + m - m_new)
    w_end = torch.exp(tail - m_new[:, None, :])
    C_new = (r[..., None, None] * C
             + torch.einsum("bqh,bqhd,bqhe->bhde", w_end, vv, kk))
    n_new = r[..., None] * n + torch.einsum("bqh,bqhd->bhd", w_end, kk)
    return hq, (C_new, n_new, m_new)


def _mlstm_widths(cfg: ModelConfig):
    """Each mLSTM leaf a model axis may split: (submodule, name, axis,
    whole size)."""
    d_in, nh, _ = _dims(cfg)
    return [("", "w_up1", 1, d_in), ("", "w_up2", 1, d_in),
            ("", "conv_w", 1, d_in), ("", "w_qkv", 1, 3 * d_in),
            ("", "w_gates", 1, 2 * nh), ("", "w_down2", 0, d_in)]


def mlstm_apply(m: MLSTM, cfg: ModelConfig, x: torch.Tensor,
                chunk: int = 256, group=None) -> torch.Tensor:
    """The chunkwise-parallel mLSTM over a whole sequence from a zero
    state, with the residual (training). x: [B, S, d] -> [B, S, d]; S must
    be a multiple of ``min(chunk, S)``, as the reference asserts. Over a
    model ``group`` (x whole on every rank) the layer runs whole and alike
    on every rank, its split leaves gathered whole first
    (``sharding.leaves_train``): the cells are whole on every rank anyway,
    and so each rank's products take one rank's shapes and sums."""
    m = sharding.leaves_train(group, m, _mlstm_widths(cfg))
    d_in, nh, dh = _dims(cfg)
    b, s, _ = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"mlstm_apply: sequence {s} is no multiple of "
                         f"its chunk {chunk}")
    nc = s // chunk
    h = rmsnorm(m.ln, x, cfg.norm_eps)
    u = h @ m.w_up1
    zg = h @ m.w_up2
    c = F.silu(_causal_conv(u, m.conv_w))
    q, k, _ = (c @ m.w_qkv).chunk(3, dim=-1)
    gates = c.float() @ m.w_gates + m.gate_bias
    ig, fg = gates.chunk(2, dim=-1)                           # [B, S, nh]
    fg = F.logsigmoid(fg)
    shape = (b, nc, chunk, nh, dh)
    qc = q.float().reshape(shape) * (1.0 / dh ** 0.5)
    kc = k.float().reshape(shape)
    vc = u.float().reshape(shape)    # the value branch: pre-conv u
    igc, fgc = (t.reshape(b, nc, chunk, nh) for t in (ig, fg))
    idx = torch.arange(chunk, device=x.device)
    causal = idx[:, None] >= idx[None, :]
    f32 = dict(dtype=torch.float32, device=x.device)
    carry = (torch.zeros((b, nh, dh, dh), **f32),
             torch.zeros((b, nh, dh), **f32),
             torch.full((b, nh), -1e9, **f32))
    hs = []
    for i in range(nc):
        hq, carry = _mlstm_chunk(carry, qc[:, i], kc[:, i], vc[:, i],
                                 igc[:, i], fgc[:, i], causal)
        hs.append(hq)
    hq = torch.stack(hs, dim=1).reshape(b, s, d_in).to(x.dtype)
    hq = rmsnorm(m.ln_head, hq, cfg.norm_eps) * F.silu(zg)
    return x + hq @ m.w_down2


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


def _slstm_widths(cfg: ModelConfig):
    """Each sLSTM leaf a model axis may split: (submodule, name, axis,
    whole size)."""
    d, ff = cfg.d_model, _ffn_width(cfg.d_model)
    return [("", "conv_w", 1, d), ("", "w_gates", 1, 4 * d),
            ("", "r_gates", 0, cfg.n_heads), ("", "w_out", 0, d),
            ("ffn", "w_gate", 1, ff), ("ffn", "w_up", 1, ff),
            ("ffn", "w_down", 0, ff)]


def slstm_apply(s: SLSTM, cfg: ModelConfig, x: torch.Tensor,
                group=None) -> torch.Tensor:
    """The sLSTM over a whole sequence from the state initialisers' state
    (h, c 0; n 1e-6; m -1e9), the cells token by token, with the residual
    and the FFN (training). x: [B, S, d] -> [B, S, d]. Over a model
    ``group`` the layer runs whole and alike on every rank, its split
    leaves gathered whole first (``sharding.leaves_train``), as
    ``mlstm_apply``'s."""
    s = sharding.leaves_train(group, s, _slstm_widths(cfg))
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    b, n_tok, _ = x.shape
    hpre = rmsnorm(s.ln, x, cfg.norm_eps)
    c_in = F.silu(_causal_conv(hpre, s.conv_w))
    wx = (c_in @ s.w_gates).float() + s.gate_bias             # [B, S, 4d]
    f32 = dict(dtype=torch.float32, device=x.device)
    zero = torch.zeros((b, nh, dh), **f32)
    cell = {"h": zero, "c": zero, "n": zero + 1e-6,
            "m": torch.full((b, nh, dh), -1e9, **f32)}
    hs = []
    for t in range(n_tok):
        rec = torch.einsum("bhd,hde->bhe", cell["h"],
                           s.r_gates).reshape(b, 4 * d)
        ht, cell = _slstm_cell(wx[:, t] + rec, cell, nh, dh)
        hs.append(ht)
    h = torch.stack(hs, dim=1).reshape(b, n_tok, d).to(x.dtype)
    x = x + h @ s.w_out
    h2 = rmsnorm(s.ln_ff, x, cfg.norm_eps)
    y = F.silu(h2 @ s.ffn.w_gate) * (h2 @ s.ffn.w_up)
    return x + y @ s.ffn.w_down
