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
  exactly.

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
