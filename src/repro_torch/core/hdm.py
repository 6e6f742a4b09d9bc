"""HDMStore -- the tier map of a parameter (or optimizer-state) tree.

The paper's HDM decoder maps each CXL root port's endpoint into one system
address space, so compute units issue plain loads and stores against
expanded memory. The reference assigns each leaf a tier and realizes it
as a sharding on the TPU mesh:

  DEVICE : replicated across the data axis -- always resident in HBM.
  POOL   : sharded across the data axis (the DRAM-EP expander); a layer is
           gathered on use, ahead of its consumer (speculative read).
  HOST   : POOL plus pinned host memory (the SSD-EP expander; TPU only).

On one rank nothing is sharded: ``POOL`` is resident like ``DEVICE`` (the
layer stream's ``materialize`` is the identity). ``HOST`` raises, as the
reference's ``enable_host_tier=False`` leaves it unusable off a TPU; its
GPU counterpart (pinned host memory streamed in by SR on a side stream) is
not built yet.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import torch

DEVICE, POOL, HOST = "device", "pool", "host"


@dataclasses.dataclass
class HDMStore:
    """Tiered placement for a parameter (or optimizer-state) tree on one
    rank."""

    tier: str = POOL                 # default tier for large leaves
    enable_host_tier: bool = False   # the SSD-EP analogue

    def __post_init__(self):
        if self.tier == HOST or self.enable_host_tier:
            raise NotImplementedError(
                "the HOST tier (pinned host memory streamed to the card) "
                "is not ported yet; use DEVICE or POOL")
        if self.tier not in (DEVICE, POOL):
            raise ValueError(f"unknown tier {self.tier!r}")


def bytes_per_device(tensors: Iterable[torch.Tensor],
                     store: HDMStore) -> int:
    """Resident bytes on the one device under the tier map: every byte,
    as no tier shards on one rank."""
    del store
    return sum(t.numel() * t.element_size() for t in tensors)
