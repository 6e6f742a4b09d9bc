"""Carry weights and paged caches across from the JAX package.

The reference draws its weights with ``jax.random``, which torch cannot
reproduce, so a comparison carries the reference's parameter pytree over
as numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``; this
module never imports JAX). bf16 crosses as a ``uint16`` view: numpy has no
bf16 of its own (the reference's arrays use ml_dtypes' ``bfloat16``, which
``np.save`` turns into ``|V2``), so two-byte void or bfloat16 arrays are
reinterpreted bit for bit. Weights keep their ``[d_in, d_out]``
orientation; the stacked leading layer axis of ``params["blocks"]`` is
sliced into one ``Block`` per layer.
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
from repro_torch.models.transformer import Block

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


def params_from_jax(np_tree: Dict, cfg: ModelConfig,
                    device="cuda") -> M.DenseModel:
    """The reference's dense parameter pytree (numpy leaves) as a
    ``DenseModel`` on ``device``."""
    M.check_family(cfg)
    dev = resolve_device(device)

    def t(a):
        return to_tensor(a, dev)

    emb = np_tree["embed"]
    embed = Embed(t(emb["embedding"]),
                  t(emb["unembed"]) if "unembed" in emb else None)
    blk = np_tree["blocks"]
    blocks = []
    for i in range(cfg.n_layers):
        a, m = blk["attn"], blk["mlp"]
        attention = Attention(
            t(a["wq"][i]), t(a["wk"][i]), t(a["wv"][i]), t(a["wo"][i]),
            t(a["q_norm"][i]) if "q_norm" in a else None,
            t(a["k_norm"][i]) if "k_norm" in a else None)
        mlp = MLP(t(m["w_up"][i]), t(m["w_down"][i]),
                  t(m["w_gate"][i]) if "w_gate" in m else None)
        blocks.append(Block(RMSNorm(t(blk["ln_attn"]["scale"][i])),
                            attention,
                            RMSNorm(t(blk["ln_mlp"]["scale"][i])), mlp))
    return M.DenseModel(embed, blocks, RMSNorm(t(np_tree["ln_f"]["scale"])))


def cache_from_jax(np_cache: Dict, device="cuda") -> Dict:
    """The reference's paged cache (numpy leaves) as the port's cache."""
    dev = resolve_device(device)
    return {"kv": {name: to_tensor(a, dev)
                   for name, a in np_cache["kv"].items()},
            "pos": to_tensor(np.asarray(np_cache["pos"], np.int32), dev)}


def cache_to_numpy(cache: Dict) -> Dict:
    """The port's paged cache as numpy arrays (bf16 widened to f32)."""
    return {"kv": {name: to_numpy(a) for name, a in cache["kv"].items()},
            "pos": to_numpy(cache["pos"])}
