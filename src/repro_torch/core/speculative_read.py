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
every leaf, as the reference's ``gather_leaf`` splits them). On the HOST
tier (``core.hdm``, ``enable_host_tier``) a layer's leaves live in pinned
host memory: its read first copies them onto the card on a side stream
(``sharding.HostRead``), then gathers the copied shards. Without a group
of more than one rank nothing is gathered, and without HOST leaves
nothing is copied: ``materialize`` is then the identity.

``mode="infer"`` with ``prefetch_depth`` > 0 runs the reference's
prefetch slots: slot 0 computes while the reads of the next ``depth``
layers are in flight. Layer i + depth's read (its copies, or its POOL
gathers) is issued, without waiting, before layer i computes, and waited
for before its first use (the current stream waits for the copies; on the
card gloo orders the gathers' result before the stream's later work).
The reference's reads past the last layer wrap to the first ones and are
idle; the port leaves them out, on every rank alike. ``prefetch_depth``
0 reads each layer in line, as the reference's other branch does.

``mode="train"`` reads each layer inside the function it rematerializes
(over the FSDP ``group`` alone: on a model axis the body runs the rank's
shard of the layer, its collectives over the model group its own, and
the gathers and HOST copies stay over the data axes)
(``sharding.gather_train``: differentiable, its backward the deterministic
store's ``reducer``), as the reference's ``materialize`` runs inside
``jax.checkpoint``: the gathered (or copied) layer is not saved for the
backward pass, whose recompute reads it again (two all-gathers and one
reduce-scatter a layer a step on POOL), so the saved residuals stay
sharded and on the HOST tier no layer stays on the card. POOL gathers
run in line. On the HOST tier the depth moves the copies: in the forward
pass layer i + depth's copy is issued before layer i's body runs; in the
backward pass the copy of layer i - depth is issued when layer i's
backward begins (a hook on layer i's output gradient, which fires before
the non-reentrant checkpoint unpacks the layer's first saved tensor and
so recomputes it), so that at most depth + 1 copied layers are alive
besides the graph's saved tensors; at depth 0 every copy runs in line,
inside the body. The reference overlaps its training gathers by unrolling
the scan ``depth + 1`` layers instead. The copied leaves' gradients go to
the step's ``host_grads`` (``sharding.HostGrads``). ``mode="train"``
rematerializes each layer's body for the backward pass with ``remat``
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

from repro_torch.parallel.sharding import (FsdpRead, HostRead,
                                          gather_train, on_host)

_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def materialize(layer: Any, granularity: int = 1, group=None,
                label=None) -> Any:
    """One layer's parameters on the card (HOST leaves copied), their
    FSDP axes gathered over ``group`` (in ``granularity`` pieces): the
    speculative read's load, in line."""
    return FsdpRead(layer, group, granularity, label).wait()


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


class _TrainReads:
    """The HOST tier's copies of a train-mode stream's ``layers``: issued
    ``depth`` layers ahead in the forward pass (``ahead``), and in the
    backward pass from ``hook``s on the layers' outputs; ``take(i)`` hands
    the body layer i's read, issued now if none is pending (depth 0, or
    without a hook's)."""

    def __init__(self, layers, depth):
        self.layers, self.depth = layers, depth
        self.pending, self.back = {}, set()

    def issue(self, i: int) -> None:
        if 0 <= i < len(self.layers) and i not in self.pending:
            self.pending[i] = HostRead(self.layers[i], label=i)

    def ahead(self, i: int) -> None:
        """Before layer i's body in the forward pass: the copies of
        layers up to i + depth (at depth 0, none: ``take`` copies)."""
        if self.depth:
            for j in range(i, i + self.depth + 1):
                self.issue(j)

    def take(self, i: int) -> HostRead:
        self.issue(i)
        return self.pending.pop(i)

    def hook(self, i: int, outputs, inputs) -> None:
        """When layer i's backward begins: the copies of layers i down to
        i - depth that its backward pass has not issued yet."""
        def issue_back(grad):
            for j in range(i, i - self.depth - 1, -1):
                if j >= 0 and j not in self.back:
                    self.back.add(j)
                    self.issue(j)
        seen = {id(t) for t in inputs}
        for t in outputs:
            if t.requires_grad and id(t) not in seen:
                t.register_hook(issue_back)


def _tensors(carry) -> tuple:
    return carry if isinstance(carry, tuple) else (carry,)


def stream_layers(body: Callable, x0: Any, layers: Sequence[Any], *,
                  prefetch_depth: int = 1, granularity: int = 1,
                  mode: str = "train", remat: bool = True,
                  remat_policy: str = "none", group=None,
                  extras: Optional[Sequence[Any]] = None,
                  reducer=None, host_grads=None) -> Any:
    """Run ``layers`` under the SR schedule, their HOST leaves copied and
    their FSDP axes gathered over ``group``; returns the final carry. In
    ``mode="train"`` the reads are differentiable, their gradients reduced
    by ``reducer`` (``core.deterministic_store.GradReducer``), the HOST
    leaves' handed to ``host_grads`` (``sharding.HostGrads``)."""
    if mode == "infer" and prefetch_depth > 0:
        return _stream_infer(body, x0, layers, depth=prefetch_depth,
                             granularity=granularity, group=group,
                             extras=extras)
    host = mode == "train" and len(layers) > 0 and on_host(layers[0])
    reads = _TrainReads(layers, prefetch_depth if host else 0)
    x = x0
    for i, layer in enumerate(layers):
        if mode == "train":
            reads.ahead(i)

            def step(c, layer=layer, i=i):
                whole = gather_train(layer, group, granularity, reducer,
                                     read=reads.take(i) if host else None,
                                     sink=host_grads)
                return _call(body, c, whole, extras, i)
        else:
            layer = materialize(layer, granularity, group, label=i)

            def step(c, layer=layer, i=i):
                return _call(body, c, layer, extras, i)
        y = _remat(step, x, remat_policy) if remat else step(x)
        if reads.depth and remat and torch.is_grad_enabled():
            reads.hook(i, _tensors(y), _tensors(x))
        x = y
    return x


def _stream_infer(body, x0, layers, *, depth, granularity, group, extras):
    """The reference's literal SR: ``depth`` prefetch slots; layer i
    computes from slot 0 once the read of layer ``i + depth`` is issued
    into the last slot."""
    n = len(layers)
    depth = min(depth, n)
    reads = [FsdpRead(layers[i], group, granularity, label=i)
             for i in range(depth)]
    x = x0
    for i in range(n):
        if i + depth < n:
            reads.append(FsdpRead(layers[i + depth], group, granularity,
                                  label=i + depth))
        x = _call(body, x, reads.pop(0).wait(), extras, i)
    return x
