"""Carry weights and paged caches across from the JAX package.

The reference draws its weights with ``jax.random``, which torch cannot
reproduce, so a comparison carries the reference's parameter pytree over
as numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``; this
module never imports JAX). bf16 crosses as a ``uint16`` view: numpy has no
bf16 of its own (the reference's arrays use ml_dtypes' ``bfloat16``, which
``np.save`` turns into ``|V2``), so two-byte void or bfloat16 arrays are
reinterpreted bit for bit. Weights keep their ``[d_in, d_out]``
orientation; the stacked leading layer axis of ``params["blocks"]`` is
sliced into one ``Block`` (the MoE family: ``MoEBlock``) per layer, and
the hybrid's ``params["groups"]`` ([g, period, ...]) into one ``Mamba2``
per (group, layer). The audio family's embedding crosses as it is: K
codebook tables stacked into [K·V, d], and its untied [d, K·V] unembed.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, Embed, RMSNorm
from repro_torch.models.mamba2 import Mamba2
from repro_torch.models.moe import MoE
from repro_torch.models.transformer import Block, MoEBlock

_NP_TO_TORCH = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float16): torch.float16,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int8): torch.int8}


def _is_bf16(arr: np.ndarray) -> bool:
    return arr.dtype.itemsize == 2 and (arr.dtype.kind == "V"
                                        or arr.dtype.name == "bfloat16")


def to_tensor(arr, device) -> torch.Tensor:
    """One numpy array as a tensor on ``device`` (bf16 via uint16 bits)."""
    arr = np.ascontiguousarray(arr)
    if _is_bf16(arr):
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    elif arr.dtype in _NP_TO_TORCH:
        t = torch.from_numpy(arr.copy())
    else:
        raise TypeError(f"unsupported array dtype {arr.dtype}")
    return t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bf16 widens to float32 (lossless)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _block(blk: Dict, t, idx) -> Block | MoEBlock:
    """One dense block (an MoE block where the pytree has ``"moe"``) from
    a pytree whose leaves are indexed by ``idx`` (a layer index into
    stacked leaves, or ``()`` for unstacked ones)."""
    a = blk["attn"]
    attention = Attention(
        t(a["wq"][idx]), t(a["wk"][idx]), t(a["wv"][idx]), t(a["wo"][idx]),
        t(a["q_norm"][idx]) if "q_norm" in a else None,
        t(a["k_norm"][idx]) if "k_norm" in a else None)
    norms = (RMSNorm(t(blk["ln_attn"]["scale"][idx])),
             RMSNorm(t(blk["ln_mlp"]["scale"][idx])))
    if "moe" in blk:
        e = blk["moe"]
        experts = MoE(*(t(e[n][idx]) for n in ("router", "e_gate", "e_up",
                                                "e_down")))
        return MoEBlock(norms[0], attention, norms[1], experts)
    m = blk["mlp"]
    mlp = MLP(t(m["w_up"][idx]), t(m["w_down"][idx]),
              t(m["w_gate"][idx]) if "w_gate" in m else None)
    return Block(norms[0], attention, norms[1], mlp)


def _mamba(grp: Dict, t, idx) -> Mamba2:
    names = ("in_proj", "bc_proj", "dt_proj", "dt_bias", "A_log", "D",
             "conv_w")
    return Mamba2(*(t(grp[n][idx]) for n in names),
                  RMSNorm(t(grp["ln_out"]["scale"][idx])),
                  t(grp["out_proj"][idx]))


def params_from_jax(np_tree: Dict, cfg: ModelConfig,
                    device="cuda") -> torch.nn.Module:
    """The reference's parameter pytree (numpy leaves) as a
    ``DenseModel`` (dense, MoE or audio) or ``HybridModel`` on
    ``device``."""
    M.check_family(cfg)
    dev = resolve_device(device)

    def t(a):
        return to_tensor(a, dev)

    emb = np_tree["embed"]
    embed = Embed(t(emb["embedding"]),
                  t(emb["unembed"]) if "unembed" in emb else None)
    ln_f = RMSNorm(t(np_tree["ln_f"]["scale"]))
    if cfg.family == "hybrid":
        grp, sp = np_tree["groups"], np_tree["shared"]
        groups = [[_mamba(grp, t, (gi, i))
                   for i in range(cfg.shared_block_period)]
                  for gi in range(M.n_groups(cfg))]
        shared = M.SharedBlock(t(sp["in_map"]), _block(sp["block"], t, ()),
                               t(sp["out_map"]))
        return M.HybridModel(embed, groups, shared, ln_f)
    blocks = [_block(np_tree["blocks"], t, i) for i in range(cfg.n_layers)]
    return M.DenseModel(embed, blocks, ln_f)


def cache_from_jax(np_cache: Dict, device="cuda") -> Dict:
    """The reference's cache (numpy leaves: paged ``kv`` -- int8 codes with
    their f32 ``k_scale``/``v_scale`` under ``kv_quant="int8"`` --, ``pos``
    and, for the hybrid, ``h``/``conv``) as the port's cache."""
    dev = resolve_device(device)
    out = {"kv": {name: to_tensor(a, dev)
                  for name, a in np_cache["kv"].items()},
           "pos": to_tensor(np.asarray(np_cache["pos"], np.int32), dev)}
    for name in ("h", "conv"):
        if name in np_cache:
            out[name] = to_tensor(np_cache[name], dev)
    return out


def cache_to_numpy(cache: Dict) -> Dict:
    """The port's cache as numpy arrays (bf16 widened to f32)."""
    return {name: ({n: to_numpy(t) for n, t in a.items()} if name == "kv"
                   else to_numpy(a)) for name, a in cache.items()}
