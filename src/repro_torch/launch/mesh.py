"""The rank group of multi-rank serving (weights split by
``param_specs``, pages sharded, expert-parallel MoE): the port's
counterpart of the reference's JAX mesh (``repro.launch.mesh``).

The reference runs one process over a (data, model) mesh of devices; the
port runs one process per rank of the model axis, joined by a
``torch.distributed`` process group. The backend follows the devices:

 * gloo for CPU tensors (the tests);
 * NCCL when every rank has a card of its own (rank r on ``cuda:r``);
 * gloo carrying CUDA tensors when the ranks share one card, as on a
   machine with one H100: NCCL refuses two ranks on one device.

Every collective of the port goes through :class:`RankGroup`:
``all_reduce`` (max or sum), ``all_gather`` and ``all_to_all`` (equal
splits, ``all_to_all_single``). Gloo carries each of them for CUDA tensors
on the H100 with torch 2.11 (it stages them through host memory itself),
so no collective is staged by hand or built from another
(``chip_smoke.py``'s tp phase). ``COLLECTIVES`` counts the calls of each
in this process, for the collectives per step that ``chip_smoke.py``
reports.

``spawn`` starts the ranks (``torch.multiprocessing``, spawn context) with
a ``file://`` rendezvous, runs one function on each with its group and
returns what each returned, pickled by value in the rank (tensors
included); a rank that fails or outlives the timeout fails the call, and
every process it started is stopped.
"""
from __future__ import annotations

import collections
import dataclasses
import datetime
import os
import pickle
import queue as queue_mod
import time
import traceback
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist


# calls of each collective in this process (read and reset by callers)
COLLECTIVES: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class RankGroup:
    """This process's place in the model axis: ``rank`` of ``size``, the
    ``device`` its tensors live on and the ``backend`` that joins them."""

    rank: int
    size: int
    device: torch.device
    backend: str

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """In place over the ranks: ``op`` "max" or "sum"; returns ``t``.
        Every rank gets the same bits."""
        red = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}[op]
        COLLECTIVES["all_reduce"] += 1
        dist.all_reduce(t, op=red)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[size, *t.shape]: every rank's ``t`` in rank order. The bytes
        travel as uint8, so any dtype (bf16, int8 codes) crosses."""
        t = t.contiguous()
        flat = t.reshape(-1).view(torch.uint8)
        parts = [torch.empty_like(flat) for _ in range(self.size)]
        COLLECTIVES["all_gather"] += 1
        dist.all_gather(parts, flat)
        return torch.stack(parts).view(t.dtype).reshape(
            (self.size,) + t.shape)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` [size, ...] split equally over the ranks: slice j goes to
        rank j, and row i of the result is what rank i sent this rank
        (the reference's tiled ``all_to_all`` over axis 0). The bytes
        travel as uint8, as in ``all_gather``."""
        t = t.contiguous()
        flat = t.view(torch.uint8).reshape(self.size, -1)
        out = torch.empty_like(flat)
        COLLECTIVES["all_to_all"] += 1
        dist.all_to_all_single(out, flat)
        return out.view(t.dtype).reshape(t.shape)


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
    return RankGroup(rank, size, dev, backend)


def _rank_main(rank: int, size: int, init_method: str, device: str,
               timeout_s: float, fn: Callable, args: Sequence,
               results) -> None:
    """One spawned rank: join, run ``fn(group, *args)``, report."""
    if device == "cpu":
        torch.set_num_threads(1)      # ranks share the host's cores
    try:
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
          timeout_s: float = 600.0) -> List:
    """Run ``fn(group, *args)`` on ``size`` new rank processes joined by a
    ``file://`` rendezvous in ``rendezvous_dir`` and return the ranks'
    results in rank order. ``fn`` and ``args`` must pickle (``fn`` a
    module-level function). Raises if a rank raises, dies or is still
    running after ``timeout_s``; every rank is stopped before it returns.
    """
    import torch.multiprocessing as mp
    os.makedirs(rendezvous_dir, exist_ok=True)
    store = os.path.join(rendezvous_dir, f"rendezvous.{os.getpid()}."
                         f"{time.monotonic_ns()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, size, f"file://{store}", device, timeout_s,
                               fn, tuple(args), results), daemon=True)
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
