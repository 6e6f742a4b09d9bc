"""Plain PyTorch versions of the chunked SSD scan kernel.

Two forms of one function, both in the model layout (xdt [B,S,H,P] f32;
b/c [B,S,N]; log_a [B,S,H], the per-step log decay, <= 0), both starting
from an initial state ``h0`` [B,H,P,N] (zero when None) and returning
``(y [B,S,H,P], h_last [B,H,P,N])`` in f32:

* ``ssd_recurrent_ref`` -- the sequential recurrence of the reference's
  oracle (``repro/kernels/mamba2_scan/ref.py::ssd_scan_ref``):
  ``h_t = exp(log_a_t) h_{t-1} + xdt_t (x) b_t``, ``y_t = h_t c_t``;
* ``ssd_chunked_ref`` -- the chunked einsum form of the reference's
  ``mamba_apply`` ``chunk_step`` (``repro/models/mamba2.py:94-113``): a
  masked quadratic inside each chunk, the carried state decayed into each
  position, and the state update to the chunk end. A ragged tail is padded
  with ``xdt = 0`` and ``log_a = 0``, which carries the state through
  exactly;
* ``ssd_split_ref`` -- the arithmetic of ``csrc/ssd_scan.cu`` written
  plainly: the token axis cut into spans of whole sub-chunks, each span
  scanned from a zero state (its end state S_c and log decay L_c), then
  the chain ``h_in(c+1) = exp(L_c) h_in(c) + S_c`` from ``h0`` in split
  order, and ``exp(L_before + la_i) C_i h_in(c)^T`` added to each span's
  output. Its four products go through ``mm`` (f32 ``torch.matmul`` by
  default; the CPU tests pass ``tf32.matmul_3xtf32``, the kernel's
  tensor-core arithmetic).

The CPU tests run them; ``chip_smoke.py`` holds ``csrc/ssd_scan.cu``
against ``ssd_chunked_ref`` on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _state0(xdt: torch.Tensor, n: int,
            h0: Optional[torch.Tensor]) -> torch.Tensor:
    b, _, h, p = xdt.shape
    if h0 is None:
        return torch.zeros((b, h, p, n), dtype=torch.float32,
                           device=xdt.device)
    return h0.float().clone()


def ssd_recurrent_ref(xdt: torch.Tensor, bmat: torch.Tensor,
                      cmat: torch.Tensor, log_a: torch.Tensor,
                      h0: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step through time; see the module docstring for layouts."""
    s = xdt.shape[1]
    state = _state0(xdt, bmat.shape[2], h0)
    x, bm, cm, la = (t.float() for t in (xdt, bmat, cmat, log_a))
    ys = []
    for t in range(s):
        state = (state * torch.exp(la[:, t])[..., None, None]
                 + torch.einsum("bhp,bn->bhpn", x[:, t], bm[:, t]))
        ys.append(torch.einsum("bhpn,bn->bhp", state, cm[:, t]))
    return torch.stack(ys, dim=1), state


def ssd_chunked_ref(xdt: torch.Tensor, bmat: torch.Tensor,
                    cmat: torch.Tensor, log_a: torch.Tensor,
                    h0: Optional[torch.Tensor] = None, chunk: int = 256
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunks of ``chunk`` tokens (the last one padded); see the module
    docstring for layouts."""
    b, s, h, p = xdt.shape
    n = bmat.shape[2]
    q = max(1, min(chunk, s))
    nc = -(-s // q)
    pad = nc * q - s

    def chunks(t, *tail):
        t = F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(b, nc, q, *tail)

    xc, bc, cc = chunks(xdt, h, p), chunks(bmat, n), chunks(cmat, n)
    la = torch.cumsum(chunks(log_a, h), dim=2)               # [B,nc,Q,H]
    idx = torch.arange(q, device=xdt.device)
    causal = idx[:, None] >= idx[None, :]                    # [Q, Q]
    state = _state0(xdt, n, h0)
    ys = []
    for ci in range(nc):
        xq, bq, cq, laq = xc[:, ci], bc[:, ci], cc[:, ci], la[:, ci]
        g = torch.einsum("bqn,bmn->bqm", cq, bq)             # [B,Q,Q]
        logdec = laq[:, :, None, :] - laq[:, None, :, :]     # [B,Q,Q,H]
        logdec = torch.where(causal[None, :, :, None], logdec, NEG_INF)
        y = torch.einsum("bqm,bqmh,bmhp->bqhp", g, torch.exp(logdec), xq)
        y = y + torch.einsum("bqn,bhpn,bqh->bqhp", cq, state,
                             torch.exp(laq))
        la_last = laq[:, -1:, :]                             # [B,1,H]
        w = torch.exp(la_last - laq)                         # [B,Q,H]
        state = (torch.exp(la_last[:, 0, :])[..., None, None] * state
                 + torch.einsum("bqhp,bqn,bqh->bhpn", xq, bq, w))
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, nc * q, h, p)[:, :s]
    return y, state


def split_spans(s: int, splits: int, sub: int):
    """The spans of ``csrc/ssd_scan.cu``: ``[lo, hi)`` token ranges of
    whole ``sub``-token sub-chunks (the last one ragged), at most
    ``splits`` of them, shared out as evenly as whole sub-chunks allow,
    every one non-empty."""
    n_sub = -(-s // sub)
    span = -(-n_sub // max(1, min(splits, n_sub)))
    return [(lo, min(s, lo + span * sub))
            for lo in range(0, s, span * sub)]


def ssd_split_ref(xdt: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                  log_a: torch.Tensor, h0: Optional[torch.Tensor] = None,
                  splits: int = 4, sub: int = 64, mm=torch.matmul
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spans scanned from zero, then chained; see the module docstring
    for layouts. ``sub`` is the kernel's sub-chunk (64 tokens)."""
    x = xdt.float().permute(0, 2, 1, 3)                      # [B,H,S,P]
    bm, cm = bmat.float()[:, None], cmat.float()[:, None]    # [B,1,S,N]
    la = log_a.float().permute(0, 2, 1)                      # [B,H,S]
    y = torch.empty_like(x)
    h_in = _state0(xdt, bmat.shape[2], h0)
    spans = []
    for lo, hi in split_spans(x.shape[2], splits, sub):
        state = torch.zeros_like(h_in)
        big_l = torch.zeros(la.shape[:2], dtype=torch.float32,
                            device=x.device)
        parts = []
        for t0 in range(lo, hi, sub):
            t1 = min(hi, t0 + sub)
            xq, bq, cq = x[:, :, t0:t1], bm[:, :, t0:t1], cm[:, :, t0:t1]
            lq = torch.cumsum(la[:, :, t0:t1], dim=-1)        # [B,H,q]
            q = t1 - t0
            causal = torch.ones(q, q, dtype=torch.bool,
                                device=x.device).tril()
            g = mm(cq, bq.transpose(-1, -2))                 # [B,1,q,q]
            m = torch.where(causal, g * torch.exp(lq[..., :, None]
                                                  - lq[..., None, :]), 0.0)
            yq = mm(m, xq) + torch.exp(lq)[..., None] * mm(
                cq, state.transpose(-1, -2))
            parts.append((t0, t1, yq, big_l, cq, lq))
            w = torch.exp(lq[..., -1:] - lq)                 # [B,H,q]
            state = (torch.exp(lq[..., -1])[..., None, None] * state
                     + mm((xq * w[..., None]).transpose(-1, -2), bq))
            big_l = big_l + lq[..., -1]
        spans.append((state, big_l, parts))
    for state, big_l, parts in spans:
        for t0, t1, yq, l_before, cq, lq in parts:
            y[:, :, t0:t1] = yq + torch.exp(
                l_before[..., None] + lq)[..., None] * mm(
                    cq, h_in.transpose(-1, -2))
        h_in = torch.exp(big_l)[..., None, None] * h_in + state
    return y.permute(0, 2, 1, 3), h_in
