"""Speculative read -- the layer stream of the training forward.

The paper's SR unit pre-shares upcoming load addresses with the endpoint
(``MemSpecRd``) so that the endpoint's DRAM already holds a page when the
real read arrives. The reference realizes it on a TPU mesh: each layer's
parameters are gathered from the pool tier ahead of their use
(``materialize``), with ``prefetch_depth`` layers in flight.

On one rank no parameter is sharded, so ``materialize`` is the identity
and the stream is a loop over the model's layers. The schedule is kept:
``mode="infer"`` runs the reference's prefetch slots in their order (slot
0 computes, layer ``i + depth`` enters the last slot), though there is no
data movement to hide; ``mode="train"`` runs the plain loop, each layer's
body rematerialized for the backward pass with ``remat``
(``torch.utils.checkpoint``, non-reentrant): ``remat_policy="none"``
saves nothing of the body, ``"dots"`` saves the outputs of its matrix
products without batch dimensions (``aten.mm`` / ``aten.addmm``: the
weight products, not the attention's or the experts' batched ones), as the
reference's ``dots_with_no_batch_dims_saveable``.

Body contract: ``body(carry, layer) -> carry``, where ``carry`` is a
tensor or a tuple of tensors and ``layer`` one element of the layer
sequence. (The reference's body also takes and returns a per-layer slice
of stacked extras, for its decode step's cache; no caller of the port's
stream has one.)
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Sequence

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def materialize(layer: Any, granularity: int = 1) -> Any:
    """One layer's parameters in their resident form: on one rank they are
    resident already (the reference's gather of the FSDP axis, in
    ``granularity`` pieces, has nothing to gather)."""
    del granularity
    return layer


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn: Callable, carry: Any, remat_policy: str):
    """``fn(carry)`` under activation checkpointing."""
    tup = isinstance(carry, tuple)
    args = carry if tup else (carry,)
    kw = {}
    if remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    elif remat_policy != "none":
        raise ValueError(f"unknown remat_policy {remat_policy!r}")
    return checkpoint(lambda *c: fn(c if tup else c[0]), *args,
                      use_reentrant=False, **kw)


def stream_layers(body: Callable, x0: Any, layers: Sequence[Any], *,
                  prefetch_depth: int = 1, granularity: int = 1,
                  mode: str = "train", remat: bool = True,
                  remat_policy: str = "none") -> Any:
    """Run ``layers`` under the SR schedule; returns the final carry."""
    if mode == "infer" and prefetch_depth > 0:
        return _stream_infer(body, x0, layers, depth=prefetch_depth,
                             granularity=granularity)
    x = x0
    for layer in layers:
        layer = materialize(layer, granularity)

        def step(c, layer=layer):
            return body(c, layer)
        x = _remat(step, x, remat_policy) if remat else step(x)
    return x


def _stream_infer(body, x0, layers, *, depth, granularity):
    """The reference's literal SR: ``depth`` prefetch slots; layer i
    computes from slot 0 and the read of layer ``(i + depth) mod n``
    enters the last slot (the tail's reads wrap, idle slots past the end
    of the trace). On one rank every read is of a resident layer: the
    order is kept, but there is no data movement to hide."""
    n = len(layers)
    depth = min(depth, n)
    bufs = [materialize(layers[i], granularity) for i in range(depth)]
    x = x0
    for i in range(n):
        x = body(x, bufs[0])
        bufs = bufs[1:] + [materialize(layers[(i + depth) % n],
                                       granularity)]
    return x
