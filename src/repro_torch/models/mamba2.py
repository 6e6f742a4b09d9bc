"""Mamba2 (SSD) blocks: chunked scan for a training sequence or a serving
prefill chunk, recurrent step for decode. Used inside the zamba2 hybrid.

State per head: h in R^{P x N} (head_dim x state), per-step decay
a_t = exp(dt_t * A_h); h_t = a_t h_{t-1} + dt_t x_t (x) B_t; y_t = h_t C_t
+ D_h x_t. The serving prefill chunk runs the SSD scan kernel
(``repro_torch.kernels.mamba2_scan``); the step is plain PyTorch, as the
reference's ``mamba_step`` is plain jnp, and so is the full-sequence
training form (``mamba_apply``), the reference's jnp chunked SSD: the
kernel has no backward.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba2_scan.ops import ssd
from repro_torch.models.layers import (RMSNorm, dense_init, frozen_param,
                                       pdtype, rmsnorm)


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


def _project(m: Mamba2, cfg: ModelConfig, u: torch.Tensor):
    """u: [B,S,d] -> z, x ([B,S,d_in], model dtype), bc ([B,S,2N]) and
    dt ([B,S,nh] f32, softplus, clipped to [1e-4, 10])."""
    z, x = (u @ m.in_proj).chunk(2, dim=-1)
    bc = u @ m.bc_proj
    dt = F.softplus((u @ m.dt_proj).float() + m.dt_bias)
    return z, x, bc, dt.clamp(1e-4, 10.0)


def _ssd_inputs(m: Mamba2, cfg: ModelConfig, conv: torch.Tensor,
                dt: torch.Tensor):
    """Split the conv output into the scan's f32 inputs: xh [B,S,nh,P],
    xdt, B, C (contiguous) and the per-step log decay [B,S,nh]."""
    d_in, nh, p, n = _dims(cfg)
    b, s = conv.shape[:2]
    x, bmat, cmat = conv.split([d_in, n, n], dim=-1)
    xh = x.reshape(b, s, nh, p).float()
    log_a = dt * (-torch.exp(m.A_log))[None, None, :]
    xdt = xh * dt[..., None]
    return (xh, xdt, bmat.float().contiguous(), cmat.float().contiguous(),
            log_a)


def _finish(m: Mamba2, cfg: ModelConfig, u: torch.Tensor, y: torch.Tensor,
            xh: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Skip term, gate, norm and output projection: y [B,S,nh,P] f32."""
    b, s = y.shape[:2]
    y = y + xh * m.D[None, None, :, None]
    y = y.reshape(b, s, -1).to(u.dtype)
    y = rmsnorm(m.ln_out, y * F.silu(z), cfg.norm_eps)
    return y @ m.out_proj


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
                chunk: int = 256) -> torch.Tensor:
    """The full-sequence forward of one layer (training; the reference's
    ``mamba_apply``): the SSD from a zero state in plain, differentiable
    PyTorch, the conv in the model dtype. u: [B, S, d] -> [B, S, d]; S a
    multiple of ``min(chunk, S)``."""
    s = u.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"chunk {chunk} does not divide {s} tokens")
    z, x, bc, dt = _project(m, cfg, u)
    conv = F.silu(_causal_conv(torch.cat([x, bc], dim=-1), m.conv_w))
    xh, xdt, bmat, cmat, log_a = _ssd_inputs(m, cfg, conv, dt)
    y = _ssd_train(xdt, bmat, cmat, log_a, chunk)
    return _finish(m, cfg, u, y, xh, z)


def mamba_state_init(cfg: ModelConfig, batch: int, *, device,
                     dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Zero recurrent state: ``h`` [B,nh,P,N] and ``conv`` [B,W-1,C]."""
    d_in, nh, p, n = _dims(cfg)
    return {"h": torch.zeros((batch, nh, p, n), dtype=dtype, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_in + 2 * n),
                                dtype=dtype, device=device)}


def mamba_step(m: Mamba2, cfg: ModelConfig, u: torch.Tensor,
               state: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Recurrent decode step. u: [B, 1, d] -> ([B, 1, d], new state); the
    conv window and the state update run in f32."""
    d_in, nh, p, n = _dims(cfg)
    b = u.shape[0]
    z, x, bc, dt = _project(m, cfg, u)
    conv_in = torch.cat([x, bc], dim=-1)[:, 0]                 # [B, C]
    window = torch.cat([state["conv"],
                        conv_in[:, None].to(state["conv"].dtype)], dim=1)
    conv = F.silu(torch.einsum("bwc,wc->bc", window.float(),
                               m.conv_w.float()))
    x1, b1, c1 = conv.split([d_in, n, n], dim=-1)
    xh = x1.reshape(b, nh, p)
    dt1 = dt[:, 0]                                             # [B, nh]
    a = torch.exp(dt1 * (-torch.exp(m.A_log))[None, :])
    h = (state["h"] * a[..., None, None]
         + torch.einsum("bhp,bn,bh->bhpn", xh, b1, dt1))
    y = torch.einsum("bhpn,bn->bhp", h, c1) + xh * m.D[None, :, None]
    y = y.reshape(b, 1, d_in).to(u.dtype)
    y = rmsnorm(m.ln_out, y * F.silu(z), cfg.norm_eps)
    return y @ m.out_proj, {"h": h, "conv": window[:, 1:]}


def mamba_prefill_chunk(m: Mamba2, cfg: ModelConfig, u: torch.Tensor,
                        state: Dict[str, torch.Tensor]
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The serving prefill of a C-token chunk from a carried state.

    u: [B, C, d]; state {"h": [B,nh,P,N], "conv": [B,W-1,C]} (f32). The
    conv runs over ``[state conv; chunk]`` in f32 and the scan starts from
    ``h0 = state["h"]``, so this equals C calls of :func:`mamba_step` (what
    the reference engine's prefill scan computes). Returns ([B, C, d], the
    new state)."""
    w = cfg.ssm_conv
    c = u.shape[1]
    z, x, bc, dt = _project(m, cfg, u)
    conv_in = torch.cat([x, bc], dim=-1).to(state["conv"].dtype)
    full = torch.cat([state["conv"], conv_in], dim=1)          # [B,W-1+C,C]
    wf = m.conv_w.float()
    conv = sum(full[:, k:k + c].float() * wf[k] for k in range(w))
    xh, xdt, bmat, cmat, log_a = _ssd_inputs(m, cfg, F.silu(conv), dt)
    y, h = ssd(xdt, bmat, cmat, log_a, h0=state["h"].float().contiguous())
    return (_finish(m, cfg, u, y, xh, z),
            {"h": h, "conv": full[:, full.shape[1] - (w - 1):]})

