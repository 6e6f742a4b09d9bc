"""The rank mesh of multi-rank serving and training: the port's
counterpart of the reference's JAX mesh (``repro.launch.mesh``).

The reference runs one process over a (data, model) or (pod, data,
model) mesh of devices; the port runs one process per rank, joined by a
``torch.distributed`` process group. Ranks are numbered row-major, as
``jax.make_mesh`` orders its devices: rank ``(p D + d) N + m`` sits at
pod p, data row d and model column m of a (P, D, N) mesh. The backend
follows the devices:

 * gloo for CPU tensors (the tests);
 * NCCL when every rank has a card of its own (rank r on ``cuda:r``);
 * gloo carrying CUDA tensors when the ranks share one card, as on a
   machine with one H100: NCCL refuses two ranks on one device.

Every collective of the port goes through a :class:`RankGroup`, one axis
(or a product of axes) of the mesh: ``all_reduce`` (max or sum),
``all_gather`` (also issued asynchronously, for the speculative read's
gathers one layer ahead), ``all_to_all`` (equal splits,
``all_to_all_single``), ``broadcast``, ``reduce_scatter`` (the
deterministic store's gradients in training) and ``sum_ranked`` (one
``all_gather`` and a sum in rank order: the training step's sums over the
model axis). Gloo carries the first
four for CUDA tensors on the H100 with torch 2.11 (it stages them
through host memory itself; ``chip_smoke.py``'s tp and dp phases); the
reduce-scatter is built from one ``all_to_all`` and a sum in rank order
on every backend (``RankGroup.reduce_scatter``). A group of one rank runs no
collective. ``COLLECTIVES`` counts the calls of each in this process, by
axis: ``"all_reduce"`` on the model axis, ``"data:all_gather"`` on the
data axis and so on, for the collectives per step that ``chip_smoke.py``
reports.

``init_mesh`` builds a :class:`RankMesh`: the world and its model, data,
pod, (pod, data) and (data, model) sub-groups, every sub-group created by
every process in the same order (``dist.new_group``). ``spawn`` starts
the ranks (``torch.multiprocessing``, spawn context) with a ``file://``
rendezvous, runs one function on each with its group (or, given
``mesh_shape``, its mesh) and returns what each returned, pickled by
value in the rank (tensors included); a rank that fails or outlives the
timeout fails the call, and every process it started is stopped.
"""
from __future__ import annotations

import collections
import dataclasses
import datetime
import math
import os
import pickle
import queue as queue_mod
import time
import traceback
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


# calls of each collective in this process, by axis (read and reset by
# callers): the model axis's under the op's name, another axis's as
# "<axis>:<op>"
COLLECTIVES: collections.Counter = collections.Counter()


class _Pending:
    """An asynchronous ``all_gather`` in flight: ``wait()`` returns
    [size, *shape] as ``RankGroup.all_gather`` does."""

    def __init__(self, work, parts, like: torch.Tensor, size: int):
        self.work, self.parts, self.like, self.size = work, parts, like, size

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
        t = self.like
        return torch.stack(self.parts).view(t.dtype).reshape(
            (self.size,) + t.shape)


@dataclasses.dataclass(frozen=True)
class RankGroup:
    """This process's place in one axis of the mesh: ``rank`` of ``size``,
    the ``device`` its tensors live on, the ``backend`` that joins them,
    the process group ``pg`` (None: the world), the ``axis`` it spans
    ("model", "data", "pod", or a product such as "pod,data") and the
    world ranks of its members in group order."""

    rank: int
    size: int
    device: torch.device
    backend: str
    pg: Optional[object] = None
    axis: str = "model"
    members: Tuple[int, ...] = ()

    def _count(self, op: str) -> None:
        COLLECTIVES[op if self.axis == "model" else
                    f"{self.axis}:{op}"] += 1

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """In place over the ranks: ``op`` "max" or "sum"; returns ``t``.
        Every rank gets the same bits."""
        red = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}[op]
        if self.size == 1:
            return t
        self._count("all_reduce")
        dist.all_reduce(t, op=red, group=self.pg)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[size, *t.shape]: every rank's ``t`` in rank order. The bytes
        travel as uint8, so any dtype (bf16, int8 codes) crosses."""
        return self.all_gather_async(t).wait()

    def all_gather_async(self, t: torch.Tensor) -> _Pending:
        """``all_gather`` issued without waiting: the handle's ``wait()``
        returns its result, ordered before the current stream's later
        work. ``t`` must not change until then."""
        t = t.contiguous()
        flat = t.reshape(-1).view(torch.uint8)
        if self.size == 1:
            return _Pending(None, [flat], t, 1)
        parts = [torch.empty_like(flat) for _ in range(self.size)]
        self._count("all_gather")
        work = dist.all_gather(parts, flat, group=self.pg, async_op=True)
        return _Pending(work, parts, t, self.size)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` [size, ...] split equally over the ranks: slice j goes to
        rank j, and row i of the result is what rank i sent this rank
        (the reference's tiled ``all_to_all`` over axis 0). The bytes
        travel as uint8, as in ``all_gather``."""
        if self.size == 1:
            return t
        t = t.contiguous()
        flat = t.view(torch.uint8).reshape(self.size, -1)
        out = torch.empty_like(flat)
        self._count("all_to_all")
        dist.all_to_all_single(out, flat, group=self.pg)
        return out.view(t.dtype).reshape(t.shape)

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The sum of every rank's ``t``, cut into ``size`` contiguous
        parts along ``dim``: this rank's part (``t.shape[dim]`` must
        divide by ``size``), in ``t``'s dtype. One ``all_to_all`` (part j
        to rank j) and the received parts added in rank order, on every
        backend: the path the CPU tests and the shared card run, with one
        summation order. NCCL's own ``reduce_scatter_tensor`` waits for a
        run on cards of their own that can time it against this."""
        if self.size == 1:
            return t
        if t.shape[dim] % self.size:
            raise ValueError(f"reduce_scatter: axis {dim} of "
                             f"{tuple(t.shape)} does not split over "
                             f"{self.size} ranks")
        parts = t.movedim(dim, 0).reshape((self.size, -1) + tuple(
            t.movedim(dim, 0).shape[1:]))
        self._count("reduce_scatter")
        flat = parts.contiguous().view(torch.uint8).reshape(self.size, -1)
        recv = torch.empty_like(flat)
        dist.all_to_all_single(recv, flat, group=self.pg)
        got = recv.view(t.dtype).reshape(parts.shape)
        out = got[0].clone()
        for i in range(1, self.size):
            out += got[i]
        return out.movedim(0, dim)

    def sum_ranked(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t`` in f32, added in rank order
        from one ``all_gather``: the same bits on every rank and every
        backend (the training step's sums over the model axis)."""
        t = t.float()
        if self.size == 1:
            return t
        parts = self.all_gather(t)
        out = parts[0].clone()
        for i in range(1, self.size):
            out += parts[i]
        return out

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """``t`` of the group's rank ``src`` on every rank, in place;
        returns ``t``."""
        if self.size == 1:
            return t
        self._count("broadcast")
        dist.broadcast(t, src=self.members[src], group=self.pg)
        return t


def _single(rank: int, device: torch.device, backend: str,
            axis: str) -> RankGroup:
    return RankGroup(0, 1, device, backend, None, axis, (rank,))


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """This process's place in a (pod, data, model) mesh of ``shape`` (P,
    D, N): its world ``rank``, at coordinates ``(p, d, m)``, and the
    groups of each axis it belongs to -- ``model`` (N ranks), ``data``
    (D), ``pod`` (P), ``pod_data`` (the (pod, data) product, P D ranks,
    pod-major: the reference's FSDP and batch axes with ``multi_pod``),
    ``plane`` (the (data, model) product, D N ranks: the page axes of the
    reference's batch-1 cache) and ``world``."""

    shape: Tuple[int, int, int]
    rank: int
    model: RankGroup
    data: RankGroup
    pod: RankGroup
    pod_data: RankGroup
    plane: RankGroup
    world: RankGroup

    @property
    def coords(self) -> Tuple[int, int, int]:
        return coords(self.rank, self.shape)

    @property
    def device(self) -> torch.device:
        return self.world.device

    def dp(self, multi_pod: bool) -> RankGroup:
        """The FSDP and batch axes: (pod, data) with ``multi_pod``, else
        data (the pod ranks are then replicas)."""
        return self.pod_data if multi_pod else self.data

    def all_axes(self, multi_pod: bool) -> RankGroup:
        """(pod, data, model) with ``multi_pod``, else (data, model)."""
        return self.world if multi_pod else self.plane

    @classmethod
    def of_group(cls, group: RankGroup) -> "RankMesh":
        """A (1, 1, N) mesh whose model axis is ``group`` (the world)."""
        one = _single(group.rank, group.device, group.backend, "")
        return cls((1, 1, group.size), group.rank, group,
                   dataclasses.replace(one, axis="data"),
                   dataclasses.replace(one, axis="pod"),
                   dataclasses.replace(one, axis="pod,data"), group, group)


def mesh_shape3(shape: Sequence[int]) -> Tuple[int, int, int]:
    """A (data, model) or (pod, data, model) shape as (P, D, N)."""
    shape = tuple(int(s) for s in shape)
    if len(shape) not in (2, 3) or any(s < 1 for s in shape):
        raise ValueError(f"mesh shape must be a 2- or 3-tuple of positive "
                         f"ints, got {shape!r}")
    return shape if len(shape) == 3 else (1,) + shape


def coords(rank: int, shape: Sequence[int]) -> Tuple[int, int, int]:
    """(p, d, m) of world ``rank`` in a (P, D, N) mesh, row-major."""
    _, d_n, n = mesh_shape3(shape)
    return rank // (d_n * n), rank // n % d_n, rank % n


def init_group(rank: int, size: int, init_method: str,
               device: str = "cuda",
               timeout_s: float = 600.0) -> RankGroup:
    """Join the process group as ``rank`` of ``size`` (``init_method``:
    ``file://<path>`` or ``env://``). ``device`` "cpu" takes gloo; "cuda"
    takes NCCL with a card per rank when there are enough cards, else gloo
    with every rank on ``cuda:0``.
    """
    if device == "cpu":
        backend, dev = "gloo", torch.device("cpu")
    elif device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch.cuda is not "
                               "available")
        if torch.cuda.device_count() >= size:
            backend, dev = "nccl", torch.device("cuda", rank)
        else:
            backend, dev = "gloo", torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    else:
        raise ValueError(f"device {device!r}: 'cpu' or 'cuda'")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return RankGroup(rank, size, dev, backend, members=tuple(range(size)))


def init_mesh(rank: int, shape: Sequence[int], init_method: str = "", *,
              device: str = "cuda", timeout_s: float = 600.0) -> RankMesh:
    """World ``rank``'s place in a mesh of ``shape`` ((data, model) or
    (pod, data, model)): joins the process group first where this
    process has not (``init_method``, ``device`` as in ``init_group``),
    then builds every sub-group. Every process of the world must call it
    with the same shape, as ``dist.new_group`` requires; a group of one
    rank, or of the whole world, creates no process group."""
    p_n, d_n, n = mesh_shape3(shape)
    size = p_n * d_n * n
    if not dist.is_initialized():
        world = init_group(rank, size, init_method, device, timeout_s)
    else:
        if dist.get_world_size() != size:
            raise ValueError(f"mesh {tuple(shape)} needs {size} ranks; the "
                             f"world has {dist.get_world_size()}")
        dev = (torch.device("cpu") if device == "cpu" else
               torch.device("cuda", torch.cuda.current_device()))
        world = RankGroup(rank, size, dev, dist.get_backend(),
                          members=tuple(range(size)))
    world = dataclasses.replace(world, axis="pod,data,model")
    timeout = datetime.timedelta(seconds=timeout_s)

    def rank_of(p, d, m):
        return (p * d_n + d) * n + m

    def axis(name, groups):
        """Create every group of ``groups`` (lists of world ranks) and
        return the one holding this rank."""
        mine = None
        for members in groups:
            pg = None
            if 1 < len(members) < size:
                pg = dist.new_group(list(members), timeout=timeout)
            if rank in members:
                mine = RankGroup(members.index(rank), len(members),
                                 world.device, world.backend, pg, name,
                                 tuple(members))
        return mine

    model = axis("model", [[rank_of(p, d, m) for m in range(n)]
                           for p in range(p_n) for d in range(d_n)])
    data = axis("data", [[rank_of(p, d, m) for d in range(d_n)]
                         for p in range(p_n) for m in range(n)])
    pod = axis("pod", [[rank_of(p, d, m) for p in range(p_n)]
                       for d in range(d_n) for m in range(n)])
    pod_data = axis("pod,data", [[rank_of(p, d, m) for p in range(p_n)
                                  for d in range(d_n)] for m in range(n)])
    plane = axis("data,model", [[rank_of(p, d, m) for d in range(d_n)
                                 for m in range(n)] for p in range(p_n)])
    return RankMesh((p_n, d_n, n), rank, model, data, pod, pod_data, plane,
                    world)


def _rank_main(rank: int, size: int, init_method: str, device: str,
               timeout_s: float, fn: Callable, args: Sequence,
               results, mesh_shape=None) -> None:
    """One spawned rank: join, run ``fn(group, *args)`` (``fn(mesh,
    *args)`` given ``mesh_shape``), report."""
    if device == "cpu":
        torch.set_num_threads(1)      # ranks share the host's cores
    try:
        if mesh_shape:
            group = init_mesh(rank, mesh_shape, init_method, device=device,
                              timeout_s=timeout_s)
        else:
            group = init_group(rank, size, init_method, device, timeout_s)
        # by value: a queue would share a tensor's storage by file
        # descriptor, which the parent can open only while this process
        # is alive, and the rank exits right after
        out = pickle.dumps(fn(group, *args))
        results.put((rank, True, out))
    except Exception:                 # reported to the parent, which fails
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, size: int, args: Sequence = (), *,
          rendezvous_dir: str, device: str = "cuda",
          timeout_s: float = 600.0, mesh_shape=None) -> List:
    """Run ``fn(group, *args)`` on ``size`` new rank processes joined by a
    ``file://`` rendezvous in ``rendezvous_dir`` and return the ranks'
    results in rank order; given ``mesh_shape``, ``size`` is its product
    and each rank runs ``fn(mesh, *args)`` with its ``RankMesh``. ``fn``
    and ``args`` must pickle (``fn`` a module-level function). Raises if
    a rank raises, dies or is still running after ``timeout_s``; every
    rank is stopped before it returns.
    """
    import torch.multiprocessing as mp
    if mesh_shape:
        mesh_shape = mesh_shape3(mesh_shape)
        if size != math.prod(mesh_shape):
            raise ValueError(f"mesh {mesh_shape} has {math.prod(mesh_shape)}"
                             f" ranks, not {size}")
    os.makedirs(rendezvous_dir, exist_ok=True)
    store = os.path.join(rendezvous_dir, f"rendezvous.{os.getpid()}."
                         f"{time.monotonic_ns()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, size, f"file://{store}", device, timeout_s,
                               fn, tuple(args), results, mesh_shape),
                         daemon=True)
             for r in range(size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got = {}
    try:
        while len(got) < size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{size - len(got)} of {size} ranks "
                                   f"still running after {timeout_s}s")
            try:
                rank, ok, out = results.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    raise RuntimeError(f"ranks {dead} died (exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = pickle.loads(out)
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        if os.path.exists(store):
            os.remove(store)
    return [got[r] for r in range(size)]
