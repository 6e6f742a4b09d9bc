"""Sharding over the ranks of one model axis: the parameters by the
reference's rules (``repro.parallel.sharding``: ``_RULES``, ``AXIS_SIZES``,
``_divisible``, ``spec_for``, ``param_specs``) and the page axis of the
paged KV cache (the reference's ``models.model.cache_specs``).

A spec is a tuple with one entry per axis of a leaf -- ``"model"``, the
FSDP axis ``"data"`` or None -- in place of the reference's
``PartitionSpec``, resolved for the port's per-layer leaves (the
reference's specs without their leading stacked axes). Serving runs the
model axis only: ``"data"`` has one rank there, so ``shard_params`` cuts
each leaf on its ``"model"`` axis alone, rank r taking the contiguous
``[r n/N, (r+1) n/N)`` of it. The divisibility guard tests the production
axis sizes, not N, as the reference's does, so a leaf that 16 does not
divide stays whole (granite's vocabulary of 49155; smoke granite's 8
experts, which ``models.moe``'s expert-parallel forms split themselves,
as the reference's ``shard_map`` does).

The reference's ``cache_specs`` puts the model axis on the page axis of
every paged leaf: the pages [L, B, P, page, Hkv, D] and the int8 scales
[L, B, P, Hkv] alike, so rank r holds pages ``[r P/N, (r+1) P/N)`` with
their scales and a contiguous token range of every slot.
"""
from __future__ import annotations

import copy
import re
from typing import Dict, Optional, Tuple

import torch
from torch import nn

Spec = Tuple[Optional[str], ...]

# the page axis of a cache "kv" leaf [L, B, P, ...] and of one layer's
# leaf [B, P, ...]
PAGE_AXIS, LAYER_PAGE_AXIS = 2, 1

# (regex over param path, spec WITHOUT the leading layer-stack axis)
# "F" marks the FSDP-shardable axis (replaced by fsdp axis for POOL tier,
# None for DEVICE tier). "M" is the tensor-parallel axis.
_RULES = [
    # embeddings
    (r"embedding$",            ("M", "F")),
    (r"unembed$",              ("F", "M")),
    # attention
    (r"\bwq$|\bwk$|\bwv$",     ("F", "M")),
    (r"\bwo$",                 ("M", "F")),
    (r"q_norm$|k_norm$",       (None,)),
    # dense mlp
    (r"w_gate$|w_up$",         ("F", "M")),
    (r"w_down$",               ("M", "F")),
    # moe
    (r"router$",               ("F", None)),
    (r"e_gate$|e_up$",         ("M", "F", None)),
    (r"e_down$",               ("M", None, "F")),
    # mamba2
    (r"in_proj$",              ("F", "M")),
    (r"out_proj$",             ("M", "F")),
    (r"conv_w$",               (None, "M")),
    (r"A_log$|\bD$|dt_bias$",  ("M",)),
    # xlstm (mLSTM / sLSTM)
    (r"w_up1$|w_up2$|w_qkv$|w_gates$",  ("F", "M")),
    (r"w_down2$|w_out$",       ("M", "F")),
    (r"r_gates$",              ("M", None, None)),
    # vlm cross-attention follows attention rules (same names)
    # norms / scalars / gates
    (r"scale$|bias$|gate$",    (None,)),
]

# production mesh axis sizes — the divisibility guard below drops a mesh
# axis from a dim it does not divide (e.g. granite's vocab 49155 % 16 != 0,
# xlstm's 2*nh gate dim). Guarding against the production sizes keeps the
# specs identical between smoke (1x1) and production (16x16 / 2x16x16)
# meshes.
AXIS_SIZES = {"pod": 2, "data": 16, "model": 16}


def _divisible(axes, dim: int) -> bool:
    if axes is None:
        return True
    group = axes if isinstance(axes, tuple) else (axes,)
    n = 1
    for a in group:
        n *= AXIS_SIZES.get(a, 1)
    return dim % n == 0


def spec_for(path_str: str, shape, *, fsdp_axis, stacked: bool) -> Spec:
    """Resolve the spec for one param leaf."""
    ndim = len(shape)
    for pat, spec in _RULES:
        if re.search(pat, path_str):
            out = []
            for s in spec:
                if s == "F":
                    out.append(fsdp_axis)
                elif s == "M":
                    out.append("model")
                else:
                    out.append(None)
            # normalize to actual rank (norm scales etc. may be rank-1)
            base = len(out)
            eff_ndim = ndim - (1 if stacked else 0)
            if eff_ndim < base:
                out = out[-eff_ndim:] if eff_ndim > 0 else []
            elif eff_ndim > base:
                out = [None] * (eff_ndim - base) + out
            if stacked:
                out = [None] + out
            out = [a if _divisible(a, shape[i]) else None
                   for i, a in enumerate(out)]
            return tuple(out)
    # default: replicate
    return (None,) * ndim


# the port's module path (its leading name) -> the reference's path and
# the number of stacked index levels the port's name carries there
_STACKED = {"blocks": ("blocks", 1), "groups": ("groups", 2),
            "self_blocks": ("groups/self_blocks", 2),
            "cross": ("groups/cross", 1), "mlstm": ("groups/mlstm", 2),
            "slstm": ("groups/slstm", 1)}


def ref_path(name: str) -> Tuple[str, int]:
    """A port parameter name (``model.named_parameters()``:
    ``"blocks.3.attn.wq"``) as the reference's pytree path
    (``"blocks/attn/wq"``) and the stacked axes the reference's leaf has
    in front of the port's (the layer index, or group and layer)."""
    parts = name.split(".")
    head, n_idx = _STACKED.get(parts[0], (parts[0], 0))
    return "/".join([head] + parts[1 + n_idx:]), n_idx


def param_specs(params: nn.Module, *, tier: str = "pool") -> Dict[str, Spec]:
    """``{name: spec}`` for every parameter of the port's model: the
    reference's ``param_specs(..., tier)`` of the same leaf, without its
    stacked axes. ``tier`` "device" has no FSDP axis; "pool" / "host" put
    "data" there (the reference's single-pod mesh)."""
    fsdp_axis = "data" if tier in ("pool", "host") else None
    return {name: spec_for(ref_path(name)[0], tuple(p.shape),
                           fsdp_axis=fsdp_axis, stacked=False)
            for name, p in params.named_parameters()}


def _owner(root: nn.Module, name: str) -> Tuple[nn.Module, str]:
    *path, attr = name.split(".")
    mod = root
    for part in path:
        mod = getattr(mod, part)
    return mod, attr


def shard_params(params: nn.Module, rank: int, n_ranks: int,
                 specs: Optional[Dict[str, Spec]] = None) -> nn.Module:
    """Rank ``rank``'s shard of the whole ``params``: a new model whose
    leaves with a ``"model"`` axis in their spec (``param_specs`` of the
    whole model, or ``specs``) hold the rank's contiguous 1/N of that axis
    in new tensors; every other leaf is the same tensor as in ``params``,
    which is left whole. The result carries ``shard = (rank, n_ranks)``."""
    if specs is None:
        specs = param_specs(params)
    shared = {id(p): p for p in params.parameters()}
    out = copy.deepcopy(params, memo=shared)
    for name, p in params.named_parameters():
        if "model" not in specs[name]:
            continue
        axis = specs[name].index("model")
        n = p.shape[axis] // n_ranks
        mod, attr = _owner(out, name)
        setattr(mod, attr, nn.Parameter(
            p.detach().narrow(axis, rank * n, n).clone(),
            requires_grad=False))
    out.shard = (rank, n_ranks)
    return out


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
    contiguous tensors); the other leaves (``pos``, the recurrent states,
    the vision K/V) stay whole, as the reference's ``cache_specs`` leaves
    them on the model axis. A cache without pages (xLSTM) stays whole."""
    out = dict(cache)
    if "kv" not in cache:
        return out
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


def gather_columns(group, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """A column-parallel product ([..., n/N] on each rank) put together:
    [..., n] on every rank, columns in rank order (or the parts along
    ``dim``: a state split on its heads)."""
    return torch.cat(list(group.all_gather(t)), dim=dim)


def whole_columns(group, t: torch.Tensor, width: int) -> torch.Tensor:
    """``t``, a product over a weight that may be split on its columns:
    gathered to its ``width`` columns where it is short of them (the
    weight split over the rank ``group``), else as it is."""
    if group is None or t.shape[-1] == width:
        return t
    return gather_columns(group, t)


def held_range(group, held: int, whole: int) -> Tuple[int, int]:
    """The ``[lo, lo + held)`` of an axis of ``whole`` entries that this
    rank holds: all of it, or the rank's contiguous 1/N where ``held`` is
    short of ``whole`` (``shard_params``'s cut)."""
    if group is None or held == whole:
        return 0, whole
    if held * group.size != whole:
        raise ValueError(f"{held} of {whole} entries is no 1/{group.size} "
                         f"share")
    return group.rank * held, held


def reduce_sum(group, t: torch.Tensor, dtype=None) -> torch.Tensor:
    """The ranks' partial sums ``t`` added in f32 (every rank gets the
    same bits), cast once to ``dtype`` (default ``t``'s)."""
    return group.all_reduce(t.to(torch.float32, copy=True),
                            "sum").to(dtype or t.dtype)


def product_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated and returned in f32. On the card a bf16 or
    f16 product stays one cuBLAS call on the tensor cores with an f32
    output (``out_dtype``); on the CPU, which has no such call, the same
    sum is taken from f32 copies."""
    if x.is_cuda and x.dtype != torch.float32:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.view(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


def row_parallel(group, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for ``w`` split over the ranks on its rows (``x`` this
    rank's columns of the input): each rank's product kept in f32
    (``product_f32``) and the partial sums added across the ranks in f32,
    cast once to ``x``'s dtype -- the whole product but for the order of
    its f32 additions, as one rank's bf16 product accumulates in f32 and
    rounds once."""
    return reduce_sum(group, product_f32(x, w), x.dtype)


def row_product(group, x: torch.Tensor, w: torch.Tensor,
                width: int) -> torch.Tensor:
    """``x @ w`` over ``width`` input channels. Where ``w`` is split over
    the rank ``group`` on its rows, ``x`` is whole (its rank's columns are
    taken) or already this rank's columns, and the products are summed
    across the ranks (``row_parallel``); else one product."""
    if w.shape[0] == width:
        return x @ w
    if x.shape[-1] == width:
        lo, n = held_range(group, w.shape[0], width)
        x = x[..., lo:lo + n]
    return row_parallel(group, x, w)


def split_rmsnorm(group, scale: torch.Tensor, x: torch.Tensor, width: int,
                  eps: float) -> torch.Tensor:
    """RMSNorm over ``width`` channels of which ``x`` holds this rank's
    contiguous share ([..., width/N], at ``held_range``): the squares
    summed in f32 on each rank and across the ranks, then each rank's
    channels scaled by their slice of the whole ``scale`` [width] -- the
    whole norm's result, but for the order of its f32 additions. Without
    a split, the plain RMSNorm."""
    lo, n = held_range(group, x.shape[-1], width)
    xf = x.float()
    if n == width:
        var = (xf * xf).mean(dim=-1, keepdim=True)
    else:
        var = group.all_reduce((xf * xf).sum(dim=-1, keepdim=True),
                               "sum") / width
    return (xf * torch.rsqrt(var + eps)
            * scale[lo:lo + n].float()).to(x.dtype)
