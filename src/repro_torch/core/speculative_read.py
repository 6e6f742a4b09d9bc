"""Speculative read -- the layer stream of the forward passes.

The paper's SR unit pre-shares upcoming load addresses with the endpoint
(``MemSpecRd``) so that the endpoint's DRAM already holds a page when the
real read arrives. The reference realizes it on a TPU mesh: each layer's
parameters are gathered from the pool tier ahead of their use
(``materialize``), with ``prefetch_depth`` layers in flight.

In the port the pool tier is a layer's FSDP shards (``parallel.sharding``:
each rank of the FSDP ``group`` holds a contiguous part of every leaf's
FSDP axis), and ``materialize`` all-gathers them over the group
(``sharding.FsdpRead``: ``granularity`` gathers a layer, each a piece of
every leaf, as the reference's ``gather_leaf`` splits them). Without a
group of more than one rank nothing is sharded, and ``materialize`` is the
identity.

``mode="infer"`` with ``prefetch_depth`` > 0 runs the reference's
prefetch slots: slot 0 computes while the gathers of the next ``depth``
layers are in flight. Layer i + depth's gathers are issued, without
waiting, before layer i computes, and waited for before its first use
(on the card, gloo orders their result before the current stream's later
work). The reference's reads past the last layer wrap to the first ones
and are idle; the port leaves them out, on every rank alike.
``prefetch_depth`` 0 (and ``mode="train"``) gathers each layer in line,
as the reference's other branch does. ``mode="train"`` gathers each
layer inside the function it rematerializes (``sharding.gather_train``:
differentiable, its backward the deterministic store's ``reducer``), as
the reference's ``materialize`` runs inside ``jax.checkpoint``: the
gathered layer is not saved for the backward pass, whose recompute
gathers it again (two all-gathers and one reduce-scatter a layer a
step), so the saved residuals stay sharded. Issuing layer i + depth's
gathers ahead in training is left to the HOST tier's stream; here the
depth changes nothing. ``mode="train"`` rematerializes
each layer's body for the backward pass with ``remat``
(``torch.utils.checkpoint``, non-reentrant): ``remat_policy="none"``
saves nothing of the body, ``"dots"`` saves the outputs of its matrix
products without batch dimensions (``aten.mm`` / ``aten.addmm``: the
weight products, not the attention's or the experts' batched ones), as the
reference's ``dots_with_no_batch_dims_saveable``.

Body contract: ``body(carry, layer) -> carry``, or with ``extras`` (one
per layer: the serving steps' slice of the cache, updated in place)
``body(carry, layer, extra) -> carry``, where ``carry`` is a tensor or a
tuple of tensors and ``layer`` one element of the layer sequence with its
FSDP axes gathered.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Sequence

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.parallel.sharding import FsdpRead, gather_train

_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def materialize(layer: Any, granularity: int = 1, group=None) -> Any:
    """One layer's parameters with their FSDP axes gathered over
    ``group`` (in ``granularity`` pieces): the speculative read's load,
    in line."""
    return FsdpRead(layer, group, granularity).wait()


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


def _call(body: Callable, x: Any, layer: Any, extras, i: int) -> Any:
    return body(x, layer) if extras is None else body(x, layer, extras[i])


def stream_layers(body: Callable, x0: Any, layers: Sequence[Any], *,
                  prefetch_depth: int = 1, granularity: int = 1,
                  mode: str = "train", remat: bool = True,
                  remat_policy: str = "none", group=None,
                  extras: Optional[Sequence[Any]] = None,
                  reducer=None) -> Any:
    """Run ``layers`` under the SR schedule, their FSDP axes gathered
    over ``group``; returns the final carry. In ``mode="train"`` the
    gathers are differentiable, their gradients reduced by ``reducer``
    (``core.deterministic_store.GradReducer``)."""
    if mode == "infer" and prefetch_depth > 0:
        return _stream_infer(body, x0, layers, depth=prefetch_depth,
                             granularity=granularity, group=group,
                             extras=extras)
    x = x0
    for i, layer in enumerate(layers):
        if mode == "train":
            def step(c, layer=layer, i=i):
                whole = gather_train(layer, group, granularity, reducer)
                return _call(body, c, whole, extras, i)
        else:
            layer = materialize(layer, granularity, group)

            def step(c, layer=layer, i=i):
                return _call(body, c, layer, extras, i)
        x = _remat(step, x, remat_policy) if remat else step(x)
    return x


def _stream_infer(body, x0, layers, *, depth, granularity, group, extras):
    """The reference's literal SR: ``depth`` prefetch slots; layer i
    computes from slot 0 once the read of layer ``i + depth`` is issued
    into the last slot."""
    n = len(layers)
    depth = min(depth, n)
    reads = [FsdpRead(layers[i], group, granularity) for i in range(depth)]
    x = x0
    for i in range(n):
        if i + depth < n:
            reads.append(FsdpRead(layers[i + depth], group, granularity))
        x = _call(body, x, reads.pop(0).wait(), extras, i)
    return x
