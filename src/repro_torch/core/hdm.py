"""HDMStore -- the tier map of a parameter (or optimizer-state) tree.

The paper's HDM decoder maps each CXL root port's endpoint into one system
address space, so compute units issue plain loads and stores against
expanded memory. The reference assigns each leaf a tier and realizes it
as a sharding on the TPU mesh; the port realizes it over a mesh of ranks
(``launch.mesh.RankMesh``):

  DEVICE : replicated across the data axis -- always resident on the card.
  POOL   : sharded across the data axis (the DRAM-EP expander): each rank
           holds a contiguous part of every leaf's FSDP axis, and a layer
           is gathered on use, ahead of its consumer (speculative read,
           ``core.speculative_read``).
  HOST   : POOL's sharding; with ``enable_host_tier`` this rank's shard of
           every leaf lives in pinned host memory (the SSD-EP expander),
           and the speculative read copies a layer onto the card on a side
           stream ahead of its use (``parallel.sharding.HostRead``).
           Without ``enable_host_tier`` HOST is POOL in card memory, as the
           reference's HOST is without its ``pinned_host`` memory kind.

Both sharded tiers also split the model axis (``parallel.sharding.
param_specs``). Without a mesh, or on a data axis of one rank, POOL is
resident like DEVICE. The optimizer state (m, v, the f32 master) and the
int8-EF residuals are placed under the optimizer tier
(``launch.steps.init_state``).

Pinned host memory comes in arenas (``host_empty``): anonymous mappings of
at most ``ARENA_BYTES`` each (a larger leaf gets one of its own size),
page-locked with ``cudaHostRegister``, the leaves packed in as views. One
pinned allocation per leaf through PyTorch's caching host allocator would
round each block up to a power of two (a 2.45 GB layer would hold 4 GB)
and keep freed blocks pinned. ``host_bytes`` reports the bytes pinned
against the bytes the leaves hold. A failed pin raises; no leaf is ever
kept pageable or moved to the card instead. On the CPU (a CPU device, the
tests) the arenas are plain host memory and every copy onto the "card" is
a copy within it.
"""
from __future__ import annotations

import copy
import dataclasses
import mmap
import weakref
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.parallel import sharding

DEVICE, POOL, HOST = "device", "pool", "host"
TIERS = (DEVICE, POOL, HOST)

# the largest arena; a leaf above it gets an arena of its own size
ARENA_BYTES = 1 << 30
# each leaf's offset in its arena
ALIGN = 512
_PAGE = mmap.PAGESIZE

# live arenas: bytes pinned (page-rounded mappings) and bytes the leaves
# placed in them hold
_HOST_BYTES = {"allocated": 0, "held": 0, "arenas": 0}


@dataclasses.dataclass
class HDMStore:
    """Tiered placement for a parameter (or optimizer-state) tree over a
    rank ``mesh`` (None: one rank)."""

    mesh: Optional[object] = None    # launch.mesh.RankMesh
    tier: str = POOL                 # default tier for large leaves
    enable_host_tier: bool = False   # HOST in pinned host memory
    multi_pod_fsdp: bool = False     # ZeRO across pods as well

    def __post_init__(self):
        if self.tier not in TIERS:
            raise ValueError(f"unknown tier {self.tier!r}")

    @property
    def pinned(self) -> bool:
        """Whether ``place`` moves the leaves into host memory."""
        return self.tier == HOST and self.enable_host_tier

    def specs(self, params: nn.Module) -> Dict[str, sharding.Spec]:
        """The spec of every leaf of the whole model (resident form):
        HOST's are POOL's."""
        return sharding.param_specs(params, tier=self.tier,
                                    multi_pod_fsdp=self.multi_pod_fsdp)

    def fsdp_group(self):
        """The rank group POOL and HOST shard over (None: no FSDP)."""
        if self.mesh is None or self.tier == DEVICE:
            return None
        group = self.mesh.dp(self.multi_pod_fsdp)
        return group if group.size > 1 else None

    def place(self, params: nn.Module) -> nn.Module:
        """This rank's resident shard of the whole ``params``: its model
        rank's part of every leaf, on POOL and HOST its FSDP rank's part
        of that; with ``pinned``, every leaf of the shard in host arenas,
        streamed to the device ``params`` lie on. Without a mesh the
        leaves are not cut."""
        if self.mesh is None:
            out = params
        else:
            fsdp = self.fsdp_group()
            out = sharding.shard_params(
                params, self.mesh.model.rank, self.mesh.model.size,
                self.specs(params),
                fsdp=(0, 1) if fsdp is None else (fsdp.rank, fsdp.size))
        return to_host(out) if self.pinned else out


host_target = sharding.host_target


def _mark(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    setattr(t, sharding.HOST_TARGET, device)
    return t


def compute_device(t: torch.Tensor) -> torch.device:
    """Where ``t`` is computed on: its card for a HOST-tier tensor, else
    its own device."""
    return host_target(t) or t.device


def host_bytes() -> Dict[str, int]:
    """The live host arenas: bytes pinned (``allocated``), bytes their
    leaves hold (``held``), and how many."""
    return dict(_HOST_BYTES)


def _release(ptr: int, size: int, held: int, pinned: bool) -> None:
    if pinned:
        try:
            torch.cuda.cudart().cudaHostUnregister(ptr)
        except Exception:       # the CUDA context is gone at exit
            pass
    _HOST_BYTES["allocated"] -= size
    _HOST_BYTES["held"] -= held
    _HOST_BYTES["arenas"] -= 1


def _arena(size: int, held: int, pin: bool) -> torch.Tensor:
    """A zeroed host arena of ``size`` bytes (page-rounded), page-locked
    for the card with ``pin``: a uint8 tensor over an anonymous mapping,
    unregistered and unmapped when its last view is gone."""
    size = -(-size // _PAGE) * _PAGE
    mm = mmap.mmap(-1, size, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS)
    if pin and hasattr(mmap, "MADV_HUGEPAGE"):
        mm.madvise(mmap.MADV_HUGEPAGE)   # fewer pages to fault and lock
    arr = np.frombuffer(mm, dtype=np.uint8)
    t = torch.from_numpy(arr)
    ptr = t.data_ptr()
    if pin:
        rc = torch.cuda.cudart().cudaHostRegister(ptr, size, 0)
        if int(rc) != 0:
            raise RuntimeError(
                f"cudaHostRegister of a {size}-byte host arena failed "
                f"({rc}): the HOST tier cannot pin its leaves")
        if not t.is_pinned():
            raise RuntimeError("a registered host arena is not pinned")
    _HOST_BYTES["allocated"] += size
    _HOST_BYTES["held"] += held
    _HOST_BYTES["arenas"] += 1
    weakref.finalize(arr, _release, ptr, size, held, pin)
    return t


def host_empty(metas: Sequence[Tuple[Tuple[int, ...], torch.dtype]],
               device) -> List[torch.Tensor]:
    """Zeroed host tensors of ``metas`` (shape, dtype), packed in order
    into arenas of at most ``ARENA_BYTES`` (a larger one alone in its
    own), each marked as streaming to ``device``: pinned for a CUDA
    ``device``; plain host memory for a CPU one."""
    device = torch.device(device)
    pin = device.type == "cuda"
    sizes = [int(np.prod(shape, dtype=np.int64)) * torch.empty(
        (), dtype=dt).element_size() for shape, dt in metas]
    out: List[Optional[torch.Tensor]] = [None] * len(metas)
    i = 0
    while i < len(metas):
        offs, end, j = [], 0, i
        while j < len(metas):
            start = -(-end // ALIGN) * ALIGN
            if offs and start + sizes[j] > ARENA_BYTES:
                break
            offs.append(start)
            end = start + sizes[j]
            j += 1
        arena = _arena(max(end, 1), sum(sizes[i:j]), pin)
        for k, off in zip(range(i, j), offs):
            shape, dt = metas[k]
            out[k] = _mark(arena[off:off + sizes[k]].view(dt).view(shape),
                           device)
        i = j
    return out


def host_like(tensors: Sequence[torch.Tensor], device,
              dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """``host_empty`` of ``tensors``' shapes (and dtypes, or ``dtype``)."""
    return host_empty([(tuple(t.shape), dtype or t.dtype) for t in tensors],
                      device)


def to_host(params: nn.Module) -> nn.Module:
    """``params`` with every leaf in host arenas (pinned where the leaves
    lie on a card), marked to stream back to that device: a structural
    copy (its own modules; the FSDP axes and the shard it was cut as
    kept), copied leaf by leaf; ``params`` is left as it is."""
    leaves = list(params.parameters())
    if not leaves:
        return params
    device = leaves[0].device
    out = copy.deepcopy(params, memo={id(p): p for p in leaves})
    host = host_like(leaves, device)
    with torch.no_grad():
        moved = {}
        for p, h in zip(leaves, host):
            h.copy_(p.detach())
            moved[id(p)] = _mark(nn.Parameter(h, requires_grad=False),
                                 device)
    for mod in out.modules():
        for attr, p in list(mod._parameters.items()):
            if p is not None and id(p) in moved:
                mod._parameters[attr] = moved[id(p)]
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def bytes_per_device(params: Union[nn.Module, Iterable[torch.Tensor]],
                     store: HDMStore) -> int:
    """Resident bytes on one rank under the tier map (wherever they live:
    the HOST tier's in host memory). A whole model over the store's mesh
    counts each leaf's share by its spec (the product of the sizes of the
    mesh axes it is split on, as the reference's does); tensors, a shard
    (``shard_params``' result) or a model without a mesh count every byte
    they hold. A training state (``launch.steps.TrainState``: this rank's
    parameters, m, v, masters and residuals) counts every byte of each;
    the AdamW step counter is left out, as the reference's
    ``bytes_per_device`` over ``state_specs`` counts the parameter-shaped
    trees."""
    if hasattr(params, "opt"):
        opt = params.opt
        return sum(bytes_per_device(part, store) for part in (
            params.params, opt.m, opt.v, opt.master or (),
            params.residuals or ()))
    if (not isinstance(params, nn.Module) or store.mesh is None
            or hasattr(params, "shard")):
        tensors = (params.parameters() if isinstance(params, nn.Module)
                   else params)
        return sum(_nbytes(t) for t in tensors)
    p_n, d_n, n = store.mesh.shape
    sizes = {"pod": p_n, "data": d_n, "model": n}
    specs = store.specs(params)
    total = 0
    for name, p in params.named_parameters():
        split = 1
        for a in specs[name]:
            for ax in (a if isinstance(a, tuple) else (a,)):
                split *= sizes.get(ax, 1)
        total += _nbytes(p) // split
    return total
