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
per (group, layer), the VLM's ``groups.self_blocks`` ([g, period - 1,
...]) and ``groups.cross`` ([g, ...]) into ``Block``s and ``CrossBlock``s,
and xLSTM's ``groups.mlstm`` ([g, slstm_every - 1, ...]) and
``groups.slstm`` ([g, ...]) into ``MLSTM``s and ``SLSTM``s. The audio
family's embedding crosses as it is: K codebook tables stacked into [K·V,
d], and its untied [d, K·V] unembed.

For training, ``params_to_numpy`` turns the port's parameters (or any
tensors aligned with ``model.parameters()``: gradients, f32 masters) back
into the reference's pytree layout, so a step's result can be compared;
``adamw_state_from_jax`` carries the reference's ``AdamWState`` over as
the port's, its moments and masters aligned with ``model.parameters()``.
``train_state_from_jax`` carries a whole ``TrainState`` (params, m, v,
master, int8-EF residuals) into one rank's shards of a mesh, and
``train_state_to_numpy`` puts a rank's state back together over its FSDP
group as the reference's whole numpy trees.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as M
from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, Embed, RMSNorm
from repro_torch.models.mamba2 import Mamba2
from repro_torch.models.moe import MoE
from repro_torch.models.transformer import Block, CrossBlock, MoEBlock
from repro_torch.models.xlstm import MLSTM, SLSTM
from repro_torch.optim.adamw import AdamWState
from repro_torch.parallel import sharding

_NP_TO_TORCH = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float16): torch.float16,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int8): torch.int8}


def _is_bf16(arr: np.ndarray) -> bool:
    return arr.dtype.itemsize == 2 and (arr.dtype.kind == "V"
                                        or arr.dtype.name == "bfloat16")


def to_tensor(arr, device) -> torch.Tensor:
    """One numpy array as a tensor on ``device`` (bf16 via uint16 bits)."""
    shape = np.shape(arr)              # ascontiguousarray makes 0-d 1-d
    arr = np.ascontiguousarray(arr)
    if _is_bf16(arr):
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    elif arr.dtype in _NP_TO_TORCH:
        t = torch.from_numpy(arr.copy())
    else:
        raise TypeError(f"unsupported array dtype {arr.dtype}")
    return t.reshape(shape).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bf16 widens to float32 (lossless)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _mlp(m: Dict, t, idx) -> MLP:
    return MLP(t(m["w_up"][idx]), t(m["w_down"][idx]),
               t(m["w_gate"][idx]) if "w_gate" in m else None)


def _block(blk: Dict, t, idx) -> Block | MoEBlock | CrossBlock:
    """One dense block (an MoE block where the pytree has ``"moe"``, a
    cross-attention block where it has ``"attn_gate"``) from a pytree
    whose leaves are indexed by ``idx`` (a layer index into stacked
    leaves, a (group, layer) pair, or ``()`` for unstacked ones)."""
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
    if "attn_gate" in blk:
        return CrossBlock(norms[0], attention, t(blk["attn_gate"][idx]),
                          norms[1], _mlp(blk["mlp"], t, idx),
                          t(blk["mlp_gate"][idx]))
    return Block(norms[0], attention, norms[1], _mlp(blk["mlp"], t, idx))


def _mlstm(grp: Dict, t, idx) -> MLSTM:
    w = [t(grp[n][idx]) for n in ("w_up1", "w_up2", "conv_w", "w_qkv",
                                  "w_gates", "gate_bias")]
    return MLSTM(RMSNorm(t(grp["ln"]["scale"][idx])), *w,
                 RMSNorm(t(grp["ln_head"]["scale"][idx])),
                 t(grp["w_down2"][idx]))


def _slstm(grp: Dict, t, idx) -> SLSTM:
    w = [t(grp[n][idx]) for n in ("conv_w", "w_gates", "r_gates",
                                  "gate_bias", "w_out")]
    return SLSTM(RMSNorm(t(grp["ln"]["scale"][idx])), *w,
                 RMSNorm(t(grp["ln_ff"]["scale"][idx])),
                 _mlp(grp["ffn"], t, idx))


def _mamba(grp: Dict, t, idx) -> Mamba2:
    names = ("in_proj", "bc_proj", "dt_proj", "dt_bias", "A_log", "D",
             "conv_w")
    return Mamba2(*(t(grp[n][idx]) for n in names),
                  RMSNorm(t(grp["ln_out"]["scale"][idx])),
                  t(grp["out_proj"][idx]))


def params_from_jax(np_tree: Dict, cfg: ModelConfig, device="cuda", *,
                    rank: int = 0, n_ranks: int = 1, mesh_shape=(),
                    multi_pod_fsdp: bool = False) -> torch.nn.Module:
    """The reference's parameter pytree (numpy leaves) as a
    ``DenseModel`` (dense, MoE or audio), ``HybridModel``, ``VLMModel`` or
    ``XLSTMModel`` on ``device``. With ``n_ranks > 1``, rank ``rank``'s
    shard of it on the model axis (``parallel.sharding.shard_params``).
    With ``mesh_shape`` ((data, model) or (pod, data, model)), ``rank``
    is the world rank of that mesh (row-major, ``launch.mesh``) and the
    shard is its model rank's, cut again to its FSDP rank's part on the
    POOL tier (the data axis, or pod and data with ``multi_pod_fsdp``).
    The whole model is built on ``device`` first and cut there: a
    transient whole copy on each rank (3.4 GB of bf16 weights at
    qwen3-1.7b's width), released to the card before this returns."""
    fsdp = (0, 1)
    if mesh_shape:
        p_n, d_n, n_ranks = mesh_lib.mesh_shape3(mesh_shape)
        p, d, rank = mesh_lib.coords(rank, mesh_shape)
        fsdp = (p * d_n + d, p_n * d_n) if multi_pod_fsdp else (d, d_n)
    if n_ranks > 1 or fsdp[1] > 1:
        whole = params_from_jax(np_tree, cfg, device)
        out = sharding.shard_params(
            whole, rank, n_ranks,
            sharding.param_specs(whole, multi_pod_fsdp=multi_pod_fsdp),
            fsdp=fsdp)
        del whole
        if resolve_device(device).type == "cuda":
            torch.cuda.empty_cache()
        return out
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
    if cfg.family in ("vlm", "ssm"):
        vlm = cfg.family == "vlm"
        grp = np_tree["groups"]
        (inner, make_inner), (outer, make_outer) = (
            (("self_blocks", _block), ("cross", _block)) if vlm
            else (("mlstm", _mlstm), ("slstm", _slstm)))
        g = M.n_groups(cfg)
        first = [[make_inner(grp[inner], t, (gi, i))
                  for i in range(cfg.n_layers // g - 1)] for gi in range(g)]
        last = [make_outer(grp[outer], t, gi) for gi in range(g)]
        return (M.VLMModel if vlm else M.XLSTMModel)(embed, first, last,
                                                     ln_f)
    blocks = [_block(np_tree["blocks"], t, i) for i in range(cfg.n_layers)]
    return M.DenseModel(embed, blocks, ln_f)


def cache_from_jax(np_cache: Dict, device="cuda") -> Dict:
    """The reference's cache (numpy leaves: paged ``kv`` -- int8 codes with
    their f32 ``k_scale``/``v_scale`` under ``kv_quant="int8"`` --, ``pos``
    and the family's own leaves: the hybrid's ``h``/``conv``, the VLM's
    ``cross_k``/``cross_v``, xLSTM's states, which has no ``kv``) as the
    port's cache."""
    dev = resolve_device(device)
    out = {name: ({n: to_tensor(x, dev) for n, x in a.items()}
                  if name == "kv" else to_tensor(a, dev))
           for name, a in np_cache.items() if name != "pos"}
    out["pos"] = to_tensor(np.asarray(np_cache["pos"], np.int32), dev)
    return out


def cache_to_numpy(cache: Dict) -> Dict:
    """The port's cache as numpy arrays (bf16 widened to f32)."""
    return {name: ({n: to_numpy(t) for n, t in a.items()} if name == "kv"
                   else to_numpy(a)) for name, a in cache.items()}


# ---------------------------------------------------------------------------
# back to the reference's layout (training)
# ---------------------------------------------------------------------------


def _stack(trees):
    """Leaf-wise ``np.stack`` of equally shaped trees (a new leading axis)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _np_mlp(m: MLP, leaf) -> Dict:
    out = {"w_up": leaf(m.w_up), "w_down": leaf(m.w_down)}
    if m.w_gate is not None:
        out["w_gate"] = leaf(m.w_gate)
    return out


def _np_block(blk, leaf) -> Dict:
    a = blk.attn
    attn = {n: leaf(getattr(a, n)) for n in ("wq", "wk", "wv", "wo")}
    for n in ("q_norm", "k_norm"):
        if getattr(a, n) is not None:
            attn[n] = leaf(getattr(a, n))
    out = {"ln_attn": {"scale": leaf(blk.ln_attn.scale)}, "attn": attn,
           "ln_mlp": {"scale": leaf(blk.ln_mlp.scale)}}
    if isinstance(blk, MoEBlock):
        out["moe"] = {n: leaf(getattr(blk.moe, n))
                      for n in ("router", "e_gate", "e_up", "e_down")}
    else:
        out["mlp"] = _np_mlp(blk.mlp, leaf)
    if isinstance(blk, CrossBlock):
        out["attn_gate"] = leaf(blk.attn_gate)
        out["mlp_gate"] = leaf(blk.mlp_gate)
    return out


def _np_mamba(m: Mamba2, leaf) -> Dict:
    out = {n: leaf(getattr(m, n)) for n in ("in_proj", "bc_proj", "dt_proj",
                                           "dt_bias", "A_log", "D",
                                           "conv_w", "out_proj")}
    out["ln_out"] = {"scale": leaf(m.ln_out.scale)}
    return out


def _np_mlstm(m: MLSTM, leaf) -> Dict:
    out = {n: leaf(getattr(m, n)) for n in ("w_up1", "w_up2", "conv_w",
                                           "w_qkv", "w_gates", "gate_bias",
                                           "w_down2")}
    out["ln"] = {"scale": leaf(m.ln.scale)}
    out["ln_head"] = {"scale": leaf(m.ln_head.scale)}
    return out


def _np_slstm(m: SLSTM, leaf) -> Dict:
    out = {n: leaf(getattr(m, n)) for n in ("conv_w", "w_gates", "r_gates",
                                           "gate_bias", "w_out")}
    out["ln"] = {"scale": leaf(m.ln.scale)}
    out["ln_ff"] = {"scale": leaf(m.ln_ff.scale)}
    out["ffn"] = _np_mlp(m.ffn, leaf)
    return out


def params_to_numpy(model: torch.nn.Module, cfg: ModelConfig,
                    tensors: Optional[Sequence[torch.Tensor]] = None
                    ) -> Dict:
    """The reference's parameter pytree (numpy leaves, stacked layer axes;
    bf16 widened to f32) of ``model``'s parameters or, with ``tensors``
    (aligned with ``model.parameters()``: gradients, masters), of those
    tensors in the parameters' places. The inverse of
    ``params_from_jax``."""
    sub = None
    if tensors is not None:
        sub = {id(p): t for p, t in zip(model.parameters(), tensors)}

    def leaf(p):
        return to_numpy(sub[id(p)] if sub is not None else p)

    emb = {"embedding": leaf(model.embed.embedding)}
    if model.embed.unembed is not None:
        emb["unembed"] = leaf(model.embed.unembed)
    out = {"embed": emb, "ln_f": {"scale": leaf(model.ln_f.scale)}}
    if isinstance(model, M.HybridModel):
        out["groups"] = _stack([_stack([_np_mamba(m, leaf) for m in g])
                                for g in model.groups])
        sp = model.shared
        out["shared"] = {"in_map": leaf(sp.in_map),
                         "block": _np_block(sp.block, leaf),
                         "out_map": leaf(sp.out_map)}
    elif isinstance(model, M.VLMModel):
        out["groups"] = {
            "self_blocks": _stack([_stack([_np_block(b, leaf) for b in g])
                                   for g in model.self_blocks]),
            "cross": _stack([_np_block(c, leaf) for c in model.cross])}
    elif isinstance(model, M.XLSTMModel):
        out["groups"] = {
            "mlstm": _stack([_stack([_np_mlstm(m, leaf) for m in g])
                             for g in model.mlstm]),
            "slstm": _stack([_np_slstm(m, leaf) for m in model.slstm])}
    else:
        out["blocks"] = _stack([_np_block(b, leaf) for b in model.blocks])
    return out


def adamw_state_from_jax(np_state, cfg: ModelConfig,
                         device="cuda") -> AdamWState:
    """The reference's ``AdamWState`` (numpy leaves: ``step``, the f32
    ``m`` / ``v`` / ``master`` trees, ``master`` possibly None) as the
    port's, each list aligned with the parameters of
    ``params_from_jax(params, cfg)``."""
    dev = resolve_device(device)

    def flat(tree):
        if tree is None:
            return None
        return [p.detach() for p in params_from_jax(tree, cfg,
                                                    device=dev).parameters()]

    step = to_tensor(np.asarray(np_state.step, np.int32), dev)
    return AdamWState(step=step, m=flat(np_state.m), v=flat(np_state.v),
                      master=flat(np_state.master))


def train_state_from_jax(np_state, cfg: ModelConfig, device="cuda", *,
                         rank: int = 0, mesh_shape=(),
                         multi_pod_fsdp: bool = False):
    """The reference's ``TrainState`` (numpy leaves: ``params``, ``opt``
    with ``step`` and the f32 ``m`` / ``v`` / ``master`` trees, ``master``
    possibly None, and ``residuals`` or None) as world rank ``rank``'s
    ``launch.steps.TrainState`` of a POOL-tier mesh of ``mesh_shape``
    (``params_from_jax``: every tree cut alike, so m, v, the masters and
    the residuals are the shards of the parameters they belong to);
    gradients on for the parameters."""
    from repro_torch.launch.steps import TrainState
    dev = resolve_device(device)
    kw = dict(rank=rank, mesh_shape=mesh_shape,
              multi_pod_fsdp=multi_pod_fsdp)

    def flat(tree):
        if tree is None:
            return None
        return [p.detach() for p in params_from_jax(
            tree, cfg, device=dev, **kw).parameters()]

    params = params_from_jax(np_state.params, cfg, device=dev, **kw)
    params.requires_grad_(True)
    opt = np_state.opt
    state = AdamWState(step=to_tensor(np.asarray(opt.step, np.int32), dev),
                       m=flat(opt.m), v=flat(opt.v), master=flat(opt.master))
    return TrainState(params, state, flat(np_state.residuals))


def train_state_to_numpy(state, cfg: ModelConfig, group=None,
                         model=None) -> Dict:
    """A rank's training state put back together: every FSDP shard
    gathered over ``group`` (its FSDP group; None: the state is whole),
    then every leaf cut on the model axis gathered over ``model`` (its
    model group), as the reference's whole numpy trees ``{"params", "m",
    "v", "master", "residuals"}`` (bf16 widened to f32; ``master`` and
    ``residuals`` None where the state has none) and ``"step"``."""
    params = state.params
    axes = sharding.fsdp_axes(params)
    specs = getattr(params, "specs", None)
    m_axes = [None if specs is None or "model" not in specs[n]
              else specs[n].index("model")
              for n, _ in params.named_parameters()]

    def gather(tensors, axes, grp):
        moved = [i for i, a in enumerate(axes) if a is not None]
        if grp is None or grp.size == 1 or not moved:
            return
        got = sharding._Gathers([tensors[i] for i in moved],
                                [axes[i] for i in moved], grp).wait()
        for i, t in zip(moved, got):
            tensors[i] = t

    def whole(tensors):
        if tensors is None:
            return None
        tensors = [t.detach() for t in tensors]
        gather(tensors, axes, group)
        gather(tensors, m_axes, model)
        return params_to_numpy(params, cfg, tensors)

    opt = state.opt
    return {"params": whole(list(params.parameters())), "m": whole(opt.m),
            "v": whole(opt.v), "master": whole(opt.master),
            "residuals": whole(state.residuals), "step": int(opt.step)}
