"""The kernels' work on the meta device (the dry run, ``launch.dryrun``).

A kernel wrapper given meta tensors launches nothing: it returns outputs
of the kernel's shapes and charges the kernel's own work in one launch --
its ``cost(...)``, flops and bytes in closed form -- to every count open
here. The same ``cost`` functions give ``chip_smoke.py``'s bound column,
so the dry run and the bound agree on what a launch does.
"""
from __future__ import annotations

from typing import List

# the counts open now, innermost last: each has ``kernel(name, flops,
# n_bytes)``
COUNTS: List = []


def charge(name: str, flops: float, n_bytes: float) -> None:
    """One launch of kernel ``name`` doing ``flops`` and moving
    ``n_bytes``, charged to every open count."""
    for count in COUNTS:
        count.kernel(name, flops, n_bytes)
