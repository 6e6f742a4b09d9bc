"""The page-axis split of the paged KV cache over the ranks of one model
axis: the part of the reference's ``repro.parallel.sharding`` (and of
``models.model.cache_specs``) that serving needs.

The reference's ``cache_specs`` puts the model axis on the page axis of
every paged leaf: the pages [L, B, P, page, Hkv, D] and the int8 scales
[L, B, P, Hkv] alike, so rank r holds pages ``[r P/N, (r+1) P/N)`` with
their scales and a contiguous token range of every slot. Parameters stay
whole on every rank here; the reference shards them by ``param_specs``,
with the same math (ROADMAP, Queue 1: weight sharding is still to port).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

# the page axis of a cache "kv" leaf [L, B, P, ...] and of one layer's
# leaf [B, P, ...]
PAGE_AXIS, LAYER_PAGE_AXIS = 2, 1


def check_pages(n_pages: int, n_ranks: int, max_seq: int,
                kv_page_size: int) -> None:
    """The reference engine's construction-time check
    (``repro.serving.engine``): the page axis must divide by the ranks."""
    if n_pages % n_ranks:
        raise ValueError(
            f"sharded decode needs the page axis divisible by the model "
            f"axis: {n_pages} pages (max_seq={max_seq}, kv_page_size="
            f"{kv_page_size}) % {n_ranks} ranks != 0 — lower kv_page_size "
            f"or adjust max_seq")


def page_range(n_pages: int, rank: int, n_ranks: int) -> Tuple[int, int]:
    """The pages ``[lo, hi)`` of ``n_pages`` that ``rank`` holds."""
    per = n_pages // n_ranks
    return rank * per, (rank + 1) * per


def shard_cache(cache: Dict, rank: int, n_ranks: int) -> Dict:
    """``cache`` with every "kv" leaf cut to ``rank``'s pages (new,
    contiguous tensors); the other leaves (``pos``) stay whole."""
    out = dict(cache)
    n_pages = next(iter(cache["kv"].values())).shape[PAGE_AXIS]
    lo, hi = page_range(n_pages, rank, n_ranks)
    out["kv"] = {name: t.narrow(PAGE_AXIS, lo, hi - lo).clone()
                 for name, t in cache["kv"].items()}
    return out


def gather_pages(group, kv: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """One layer's leaves ([B, P/N, ...] on each rank) gathered whole:
    [B, P, ...] on every rank, pages in rank order."""
    out = {}
    for name, t in kv.items():
        parts = group.all_gather(t)                      # [N, B, P/N, ...]
        out[name] = torch.cat(list(parts), dim=LAYER_PAGE_AXIS)
    return out
