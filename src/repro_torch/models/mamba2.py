"""Mamba2 (SSD) blocks: chunked scan for a training sequence or a serving
prefill chunk, recurrent step for decode. Used inside the zamba2 hybrid.

State per head: h in R^{P x N} (head_dim x state), per-step decay
a_t = exp(dt_t * A_h); h_t = a_t h_{t-1} + dt_t x_t (x) B_t; y_t = h_t C_t
+ D_h x_t. The serving prefill chunk runs the SSD scan kernel
(``repro_torch.kernels.mamba2_scan``); the step is plain PyTorch, as the
reference's ``mamba_step`` is plain jnp, and so is the full-sequence
training form (``mamba_apply``), the reference's jnp chunked SSD: the
kernel has no backward.

Over a rank ``group`` of the model axis (serving at tp > 1, and training:
``mamba_apply``'s own form under grad) each rank holds its shard of
the weights (``parallel.sharding``): ``in_proj``'s columns, ``conv_w``'s
channels, ``out_proj``'s rows and, where 16 divides the head count,
``A_log`` / ``D`` / ``dt_bias``. Neither column split falls on a segment
(zamba2's [z | x] splits at z's end, [x | B | C] inside x), so both
products are gathered whole before they are cut into their parts. Each
rank then runs the heads whose ``out_proj`` rows it holds: the scan (or
the step) over them, the skip term and the gate, the gated RMSNorm with
its sum of squares added across the ranks, and its rows of ``out_proj``
summed across the ranks in f32. The states stay whole on every rank, as
the reference's ``cache_specs`` leaves them: the conv window is taken
from the gathered products, and the ranks' heads of ``h`` are gathered
after every step. In training the same split runs on the differentiable
collectives of ``parallel.sharding`` (``mamba_apply``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba2_scan.ops import ssd
from repro_torch.models.layers import (RMSNorm, dense_init, frozen_param,
                                       pdtype)
from repro_torch.parallel import sharding


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    return d_in, nh, cfg.ssm_head_dim, cfg.ssm_state


class Mamba2(nn.Module):
    """One Mamba2 layer's weights, named as the reference's pytree:
    ``in_proj`` ([d, 2 d_in]: z | x), ``bc_proj`` ([d, 2N]: B | C),
    ``dt_proj``, ``dt_bias``, ``A_log``, ``D`` (f32 [nh]), ``conv_w``
    ([W, d_in + 2N]), ``ln_out`` and ``out_proj``."""

    def __init__(self, in_proj, bc_proj, dt_proj, dt_bias, A_log, D, conv_w,
                 ln_out: RMSNorm, out_proj):
        super().__init__()
        self.in_proj, self.bc_proj, self.dt_proj = (
            frozen_param(w) for w in (in_proj, bc_proj, dt_proj))
        self.dt_bias, self.A_log, self.D = (
            frozen_param(w) for w in (dt_bias, A_log, D))
        self.conv_w = frozen_param(conv_w)
        self.ln_out = ln_out
        self.out_proj = frozen_param(out_proj)


def mamba_init(gen: torch.Generator, cfg: ModelConfig, device) -> Mamba2:
    """Draw one layer from ``gen``; ``dt_bias``, ``A_log`` and ``D`` are
    the reference's fixed values."""
    d, dt = cfg.d_model, pdtype(cfg)
    d_in, nh, _, n = _dims(cfg)
    in_proj = dense_init(gen, d, 2 * d_in, dt, device)
    bc_proj = dense_init(gen, d, 2 * n, dt, device)
    dt_proj = dense_init(gen, d, nh, dt, device)
    conv_w = (torch.randn((cfg.ssm_conv, d_in + 2 * n), generator=gen,
                          device=device) * 0.1).to(dt)
    out_proj = dense_init(gen, d_in, d, dt, device)
    f32 = dict(dtype=torch.float32, device=device)
    return Mamba2(in_proj, bc_proj, dt_proj, torch.zeros(nh, **f32),
                  torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
                  torch.ones(nh, **f32), conv_w,
                  RMSNorm.ones(d_in, dt, device), out_proj)


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifted adds. x: [B,S,C]; w: [W,C]."""
    width = w.shape[0]
    out = x * w[-1]
    for j in range(1, width):
        shifted = F.pad(x, (0, 0, j, 0))[:, :-j]
        out = out + shifted * w[width - 1 - j]
    return out


def _heads(m: Mamba2, cfg: ModelConfig, group=None) -> Tuple[int, int]:
    """This rank's heads ``[h0, h0 + n)``: those whose ``out_proj`` rows
    it holds (all of them on one rank)."""
    d_in, _, p, _ = _dims(cfg)
    lo, n = sharding.held_range(group, m.out_proj.shape[0], d_in)
    if lo % p or n % p:
        raise ValueError(f"out_proj rows [{lo}, {lo + n}) split a head of "
                         f"{p}")
    return lo // p, n // p


def _share(group, cfg: ModelConfig, heads: Tuple[int, int], train: bool):
    """For a tensor whole on every rank that this rank uses for its
    ``heads`` only: under grad (``train``) over a model ``group`` whose
    ranks split the heads it enters through ``sharding.copy_in``, its
    gradient summed over the ranks; else it is taken as it is."""
    split = train and heads[1] != _dims(cfg)[1]
    return lambda t: sharding.copy_in(group if split else None, t)


def _head_leaf(t: torch.Tensor, heads: Tuple[int, int],
               share=None) -> torch.Tensor:
    """A per-head leaf ([nh], or the rank's shard of it) at ``heads``; a
    whole one through ``share`` (``_share``) first."""
    h0, n = heads
    if t.shape[0] == n:
        return t
    return (t if share is None else share(t))[h0:h0 + n]


def _project(m: Mamba2, cfg: ModelConfig, u: torch.Tensor, heads,
             group=None, train: bool = False):
    """u: [B,S,d] -> z, x ([B,S,d_in], model dtype, whole), bc ([B,S,2N])
    and dt at ``heads`` ([B,S,n] f32, softplus, clipped to [1e-4, 10]).
    ``in_proj``'s product is gathered whole over a rank ``group`` that
    splits it; with ``train``, under grad (``sharding.col_train``), z and
    dt entering the rank's heads through ``_share``."""
    d_in, nh, _, _ = _dims(cfg)
    share = _share(group, cfg, heads, train)
    zx = (sharding.col_train(group, u, m.in_proj, 2 * d_in) if train else
          sharding.whole_columns(group, u @ m.in_proj, 2 * d_in))
    z, x = zx.chunk(2, dim=-1)
    bc = u @ m.bc_proj
    h0, n = heads
    dt = F.softplus(share(u @ m.dt_proj).float()[..., h0:h0 + n]
                    + _head_leaf(m.dt_bias, heads, share))
    return share(z), x, bc, dt.clamp(1e-4, 10.0)


def _conv_out(m: Mamba2, cfg: ModelConfig, full: torch.Tensor, c: int,
              group=None, step: bool = False) -> torch.Tensor:
    """The depthwise causal conv of the last ``c`` positions of ``full``
    ([B, W-1+c, C] f32: the carried window, then the new inputs) in f32,
    silu applied (the decode ``step``'s one window as one contraction);
    over a rank ``group`` that splits ``conv_w`` each rank
    convolves its channels and the outputs are gathered whole."""
    width = full.shape[-1]
    lo, n = sharding.held_range(group, m.conv_w.shape[1], width)
    part = full[..., lo:lo + n].float()
    wf = m.conv_w.float()
    if step:
        conv = torch.einsum("bwc,wc->bc", part, wf)[:, None]
    else:
        conv = sum(part[:, k:k + c] * wf[k] for k in range(cfg.ssm_conv))
    return sharding.whole_columns(group, F.silu(conv), width)


def _ssd_inputs(m: Mamba2, cfg: ModelConfig, conv: torch.Tensor,
                dt: torch.Tensor, heads, share=None):
    """Split the conv output into the scan's f32 inputs at ``heads``: xh
    [B,S,n,P], xdt, B, C (contiguous) and the per-step log decay [B,S,n]
    (a whole ``A_log`` through ``share``)."""
    d_in, nh, p, n = _dims(cfg)
    b, s = conv.shape[:2]
    x, bmat, cmat = conv.split([d_in, n, n], dim=-1)
    h0, nh_r = heads
    xh = x.reshape(b, s, nh, p)[:, :, h0:h0 + nh_r].float()
    log_a = dt * (-torch.exp(_head_leaf(m.A_log, heads, share)))[
        None, None, :]
    xdt = xh * dt[..., None]
    return (xh, xdt, bmat.float().contiguous(), cmat.float().contiguous(),
            log_a)


def _finish(m: Mamba2, cfg: ModelConfig, u: torch.Tensor, y: torch.Tensor,
            xh: torch.Tensor, z: torch.Tensor, heads,
            group=None, train: bool = False) -> torch.Tensor:
    """Skip term, gate, norm and output projection: y [B,S,n,P] f32 at
    ``heads``; over a rank ``group``, the norm's squares and the
    projection's partial sums added across the ranks (with ``train``,
    under grad: the f32 sums through ``sharding.reduce_out``)."""
    d_in, nh, p, _ = _dims(cfg)
    b, s = y.shape[:2]
    h0, n = heads
    share = _share(group, cfg, heads, train)
    y = y + xh * _head_leaf(m.D, heads, share)[None, None, :, None]
    y = y.reshape(b, s, -1).to(u.dtype)
    y = sharding.split_rmsnorm(group, m.ln_out.scale,
                               y * F.silu(z[..., h0 * p:(h0 + n) * p]),
                               d_in, cfg.norm_eps)
    if train and n != nh:
        return sharding.reduce_out(group, sharding.product_f32(
            y, m.out_proj), u.dtype)
    return sharding.row_product(group, y, m.out_proj, d_in)


def _ssd_train(xdt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
               log_a: torch.Tensor, chunk: int) -> torch.Tensor:
    """The reference's chunked SSD from a zero state (``mamba_apply``'s
    ``chunk_step``), differentiable. xdt [B,S,nh,P]; b/c [B,S,N]; log_a
    [B,S,nh] (f32) -> y [B,S,nh,P] f32. The log decays above the diagonal
    are masked before ``exp``: masking after it would give ``inf * 0``,
    NaN gradients."""
    b, s, nh, p = xdt.shape
    n = bmat.shape[2]
    nc = s // chunk
    xc = xdt.reshape(b, nc, chunk, nh, p)
    bc, cc = (t.reshape(b, nc, chunk, n) for t in (bmat, cmat))
    la = torch.cumsum(log_a.reshape(b, nc, chunk, nh), dim=2)
    idx = torch.arange(chunk, device=xdt.device)
    causal = idx[:, None] >= idx[None, :]                     # [Q, Q]
    h = torch.zeros((b, nh, p, n), dtype=torch.float32, device=xdt.device)
    ys = []
    for ci in range(nc):
        xq, bq, cq, laq = xc[:, ci], bc[:, ci], cc[:, ci], la[:, ci]
        g = torch.einsum("bqn,bmn->bqm", cq, bq)              # [B,Q,Q]
        logdec = laq[:, :, None, :] - laq[:, None, :, :]
        logdec = torch.where(causal[None, :, :, None], logdec, -1e30)
        y = torch.einsum("bqm,bqmh,bmhp->bqhp", g, torch.exp(logdec), xq)
        y = y + torch.einsum("bqn,bhpn,bqh->bqhp", cq, h, torch.exp(laq))
        la_last = laq[:, -1:, :]                              # [B,1,nh]
        w = torch.exp(la_last - laq)                          # [B,Q,nh]
        h = (torch.einsum("bh,bhpn->bhpn", torch.exp(la_last[:, 0, :]), h)
             + torch.einsum("bqhp,bqn,bqh->bhpn", xq, bq, w))
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(b, s, nh, p)


def mamba_apply(m: Mamba2, cfg: ModelConfig, u: torch.Tensor,
                chunk: int = 256, group=None) -> torch.Tensor:
    """The full-sequence forward of one layer (training; the reference's
    ``mamba_apply``): the SSD from a zero state in plain, differentiable
    PyTorch, the conv in the model dtype. u: [B, S, d] -> [B, S, d]; S a
    multiple of ``min(chunk, S)``.

    Over a model ``group`` (``u`` whole on every rank, this rank's shard of
    the weights) the products and the conv are whole on every rank
    (``in_proj``'s columns and ``conv_w``'s channels gathered:
    ``sharding.col_train``, ``channels_train``); from there each rank runs
    the heads whose ``out_proj`` rows it holds (``_project``, ``_finish``
    with ``train``): dt, the SSD, the skip term, the gated norm
    (``split_rmsnorm``) and its rows of ``out_proj`` in f32, summed over
    the ranks (``reduce_out``)."""
    s = u.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"chunk {chunk} does not divide {s} tokens")
    heads = _heads(m, cfg, group)
    share = _share(group, cfg, heads, True)
    z, x, bc, dt = _project(m, cfg, u, heads, group, train=True)
    conv = sharding.channels_train(
        group, lambda t, w: F.silu(_causal_conv(t, w)),
        torch.cat([x, bc], dim=-1), m.conv_w)
    # the conv output in f32 before its gradient is summed: B and C feed
    # every rank's heads, so the ranks' parts of their gradient are added
    # before the one cast back, as one rank's are
    xh, xdt, bmat, cmat, log_a = _ssd_inputs(m, cfg, share(conv.float()),
                                             dt, heads, share)
    y = _ssd_train(xdt, bmat, cmat, log_a, chunk)
    return _finish(m, cfg, u, y, xh, z, heads, group, train=True)


def mamba_state_init(cfg: ModelConfig, batch: int, *, device,
                     dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Zero recurrent state: ``h`` [B,nh,P,N] and ``conv`` [B,W-1,C]."""
    d_in, nh, p, n = _dims(cfg)
    return {"h": torch.zeros((batch, nh, p, n), dtype=dtype, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_in + 2 * n),
                                dtype=dtype, device=device)}


def _whole_state(group, h: torch.Tensor, nh: int) -> torch.Tensor:
    """The rank's heads of a state [B, n, P, N] gathered whole over a rank
    ``group`` (as they are on one rank)."""
    if h.shape[1] == nh:
        return h
    return sharding.gather_columns(group, h, dim=1)


def mamba_step(m: Mamba2, cfg: ModelConfig, u: torch.Tensor,
               state: Dict[str, torch.Tensor], group=None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Recurrent decode step. u: [B, 1, d] -> ([B, 1, d], new state); the
    conv window and the state update run in f32. Over a rank ``group``,
    the step runs this rank's heads (module docstring)."""
    d_in, nh, p, n = _dims(cfg)
    b = u.shape[0]
    heads = _heads(m, cfg, group)
    h0, nh_r = heads
    z, x, bc, dt = _project(m, cfg, u, heads, group)
    conv_in = torch.cat([x, bc], dim=-1)[:, 0]                 # [B, C]
    window = torch.cat([state["conv"],
                        conv_in[:, None].to(state["conv"].dtype)], dim=1)
    conv = _conv_out(m, cfg, window, 1, group, step=True)[:, 0]
    x1, b1, c1 = conv.split([d_in, n, n], dim=-1)
    xh = x1.reshape(b, nh, p)[:, h0:h0 + nh_r]
    dt1 = dt[:, 0]                                             # [B, n]
    a = torch.exp(dt1 * (-torch.exp(_head_leaf(m.A_log, heads)))[None, :])
    h = (state["h"][:, h0:h0 + nh_r] * a[..., None, None]
         + torch.einsum("bhp,bn,bh->bhpn", xh, b1, dt1))
    y = torch.einsum("bhpn,bn->bhp", h, c1)
    out = _finish(m, cfg, u, y[:, None], xh[:, None], z, heads, group)
    return out, {"h": _whole_state(group, h, nh), "conv": window[:, 1:]}


def mamba_prefill_chunk(m: Mamba2, cfg: ModelConfig, u: torch.Tensor,
                        state: Dict[str, torch.Tensor], group=None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The serving prefill of a C-token chunk from a carried state.

    u: [B, C, d]; state {"h": [B,nh,P,N], "conv": [B,W-1,C]} (f32). The
    conv runs over ``[state conv; chunk]`` in f32 and the scan starts from
    ``h0 = state["h"]``, so this equals C calls of :func:`mamba_step` (what
    the reference engine's prefill scan computes). Over a rank ``group``
    the scan runs this rank's heads (module docstring). Returns ([B, C,
    d], the new state)."""
    w = cfg.ssm_conv
    c = u.shape[1]
    nh = _dims(cfg)[1]
    heads = _heads(m, cfg, group)
    h0, nh_r = heads
    z, x, bc, dt = _project(m, cfg, u, heads, group)
    conv_in = torch.cat([x, bc], dim=-1).to(state["conv"].dtype)
    full = torch.cat([state["conv"], conv_in], dim=1)          # [B,W-1+C,C]
    conv = _conv_out(m, cfg, full, c, group)
    xh, xdt, bmat, cmat, log_a = _ssd_inputs(m, cfg, conv, dt, heads)
    y, h = ssd(xdt, bmat, cmat, log_a,
               h0=state["h"][:, h0:h0 + nh_r].float().contiguous())
    return (_finish(m, cfg, u, y, xh, z, heads, group),
            {"h": _whole_state(group, h, nh),
             "conv": full[:, full.shape[1] - (w - 1):]})
