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
  HOST   : POOL plus pinned host memory (the SSD-EP expander; TPU only in
           the reference).

Both tiers also split the model axis (``parallel.sharding.param_specs``).
Without a mesh, or on a data axis of one rank, POOL is resident like
DEVICE. The optimizer state (m, v, the f32 master) and the int8-EF
residuals take the placement of the parameters they belong to, under the
optimizer tier (``launch.steps.init_state``: training needs the two tiers
equal), so on POOL each rank holds their FSDP shards too. ``HOST``
raises, as the reference's ``enable_host_tier=False`` leaves it unusable
off a TPU; its GPU counterpart (pinned host memory streamed in by SR on a
side stream) is not built yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Union

import torch
from torch import nn

from repro_torch.parallel import sharding

DEVICE, POOL, HOST = "device", "pool", "host"


@dataclasses.dataclass
class HDMStore:
    """Tiered placement for a parameter (or optimizer-state) tree over a
    rank ``mesh`` (None: one rank)."""

    mesh: Optional[object] = None    # launch.mesh.RankMesh
    tier: str = POOL                 # default tier for large leaves
    enable_host_tier: bool = False   # the SSD-EP analogue
    multi_pod_fsdp: bool = False     # ZeRO across pods as well

    def __post_init__(self):
        if self.tier == HOST or self.enable_host_tier:
            raise NotImplementedError(
                "the HOST tier (pinned host memory streamed to the card) "
                "is not ported yet; use DEVICE or POOL")
        if self.tier not in (DEVICE, POOL):
            raise ValueError(f"unknown tier {self.tier!r}")

    def specs(self, params: nn.Module) -> Dict[str, sharding.Spec]:
        """The spec of every leaf of the whole model (resident form)."""
        return sharding.param_specs(params, tier=self.tier,
                                    multi_pod_fsdp=self.multi_pod_fsdp)

    def fsdp_group(self):
        """The rank group the POOL tier shards over (None: no FSDP)."""
        if self.mesh is None or self.tier != POOL:
            return None
        group = self.mesh.dp(self.multi_pod_fsdp)
        return group if group.size > 1 else None

    def place(self, params: nn.Module) -> nn.Module:
        """This rank's resident shard of the whole ``params``: its model
        rank's part of every leaf, and on POOL its FSDP rank's part of
        that."""
        fsdp = self.fsdp_group()
        return sharding.shard_params(
            params, self.mesh.model.rank, self.mesh.model.size,
            self.specs(params),
            fsdp=(0, 1) if fsdp is None else (fsdp.rank, fsdp.size))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def bytes_per_device(params: Union[nn.Module, Iterable[torch.Tensor]],
                     store: HDMStore) -> int:
    """Resident bytes on one rank under the tier map. A whole model over
    the store's mesh counts each leaf's share by its spec (the product of
    the sizes of the mesh axes it is split on, as the reference's does);
    tensors, a shard (``shard_params``' result) or a model without a mesh
    count every byte they hold. A training state (``launch.steps.
    TrainState``: this rank's parameters, m, v, masters and residuals)
    counts every byte of each; the AdamW step counter is left out, as the
    reference's ``bytes_per_device`` over ``state_specs`` counts the
    parameter-shaped trees."""
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
