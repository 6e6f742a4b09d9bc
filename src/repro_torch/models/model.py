"""Model assembly for the dense, MoE, audio, hybrid, VLM and xLSTM
families: init, paged cache, decode and chunked prefill steps, on-device
sampling, and the training loss (every family; on one rank or over the
data and pod mesh axes).

The reference streams a stacked layer axis through its speculative-read
scan; the port streams its per-layer modules through
``core.speculative_read.stream_layers``: the training loss with remat,
the serving steps in ``mode="infer"`` over ``DenseModel.blocks``,
``HybridModel.groups``, ``VLMModel.self_blocks`` with ``cross`` or
``XLSTMModel.mlstm`` with ``slstm``, each step's slice of the cache beside
it. With POOL-tier weights (``Ranks.fsdp``) each layer's FSDP shards are
gathered there, ``rc.sr_prefetch_depth`` layers ahead (the serving
engine sets the depth to 0 where the FSDP axes have one rank, as the
reference's does); the leaves outside the stream (the embedding, the
hybrid's shared block) are gathered once a step, first. The MoE family
(granite) is a ``DenseModel`` of ``MoEBlock``s; the audio family
(musicgen) a ``DenseModel`` of dense blocks over K codebook tables: its
tokens are [B, K, S], their K rows summed, sinusoidal positions added at
each row's own positions, and its logits [B, K, S, V]. All three share the dense cache
layout and the chunked prefill, one parallel chunk forward per layer.
Caches keep the reference's layout -- dense
``{"kv": {"k","v"}: [L, B, P, page, Hkv, D], "pos": [B]}``, with int8
``k``/``v`` codes and f32 ``k_scale``/``v_scale`` [L, B, P, Hkv] under
``kv_quant="int8"``; hybrid adds the f32 Mamba2 states ``"h"`` [g, period,
B, nh, P, N] and ``"conv"`` [g, period, B, W-1, C], with one shared-block
K/V cache per group; the VLM has one K/V layer per self-attention layer
(L = g (period - 1), group-major) and the vision K/V ``"cross_k"`` /
``"cross_v"`` [g, B, Nv, Hkv, D] in the model dtype; xLSTM has no ``"kv"``
at all, only its f32 states (``"mC"``, ``"mn"``, ``"mm"``, ``"mconv"`` [g,
period - 1, B, ...] and ``"sh"``, ``"sc"``, ``"sn"``, ``"sm"``,
``"sconv"`` [g, B, ...]), zeroed as the reference's ``cache_init`` zeroes
them -- and are updated **in place**: the steps return the same cache dict
they were given, where the reference returns new arrays (its engine
donates them).

The hybrid and VLM prefill chunks differ from the reference in form, not
in function: the reference scans ``decode_step`` over the chunk's tokens;
here the Mamba2 layers run the chunked SSD kernel from the carried state,
the attention blocks the chunked flash prefill and the VLM's cross layers
one attention of the whole chunk over the vision K/V, which computes the
same logits and caches (``tests/test_torch_hybrid.py``,
``tests/test_torch_vlm.py``). With int8 pages the two forms differ (each
decode step attends to the chunk's earlier tokens through their codes), so
those attention blocks then run the chunk token by token through the int8
decode, as the reference does. The xLSTM prefill takes each layer over
the whole chunk: its memory updates and cells token by token from the
carried state, as the reference's scan does, its projections once for the
chunk (``models/xlstm.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import speculative_read as sr
from repro_torch.device import resolve_device
from repro_torch.models import kv_quant, mamba2, moe, transformer, xlstm
from repro_torch.parallel import sharding
from repro_torch.models.layers import (Embed, RMSNorm, embed_apply,
                                       embed_init, frozen_param, pdtype,
                                       rmsnorm, sinusoidal_positions,
                                       softmax_xent, table_split,
                                       unembed_apply, vocab_parallel_xent)

PORTED_FAMILIES = ("dense", "moe", "audio", "hybrid", "vlm", "ssm")
# families with a training forward (``loss_fn``)
TRAINED_FAMILIES = PORTED_FAMILIES


def check_family(cfg: ModelConfig) -> None:
    """Raise for a model family this port does not serve yet."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  f"(ported: {PORTED_FAMILIES})")


class DenseModel(nn.Module):
    """A decoder of per-layer ``blocks`` (dense ``Block``s, or ``MoEBlock``s
    for the MoE family) between ``embed`` and ``ln_f``."""

    def __init__(self, embed: Embed, blocks, ln_f: RMSNorm):
        super().__init__()
        self.embed = embed
        self.blocks = nn.ModuleList(blocks)
        self.ln_f = ln_f


class SharedBlock(nn.Module):
    """zamba2's shared attention block: ``in_map`` ([2d, d]), one dense
    ``block`` and ``out_map`` ([d, d])."""

    def __init__(self, in_map: torch.Tensor, block: transformer.Block,
                 out_map: torch.Tensor):
        super().__init__()
        self.in_map = frozen_param(in_map)
        self.block = block
        self.out_map = frozen_param(out_map)


class HybridModel(nn.Module):
    """zamba2: ``embed``, ``groups`` of ``shared_block_period`` Mamba2
    layers, the ``shared`` block called after each group, and ``ln_f``."""

    def __init__(self, embed: Embed, groups, shared: SharedBlock,
                 ln_f: RMSNorm):
        super().__init__()
        self.embed = embed
        self.groups = nn.ModuleList(nn.ModuleList(g) for g in groups)
        self.shared = shared
        self.ln_f = ln_f


class VLMModel(nn.Module):
    """llama-3.2-vision: ``embed``, ``groups`` of ``cross_attn_period - 1``
    dense ``self_blocks`` each followed by one ``cross`` block, and
    ``ln_f``."""

    def __init__(self, embed: Embed, self_blocks, cross, ln_f: RMSNorm):
        super().__init__()
        self.embed = embed
        self.self_blocks = nn.ModuleList(nn.ModuleList(g)
                                         for g in self_blocks)
        self.cross = nn.ModuleList(cross)
        self.ln_f = ln_f


class XLSTMModel(nn.Module):
    """xLSTM: ``embed``, ``groups`` of ``slstm_every - 1`` ``mlstm``
    layers each followed by one ``slstm`` layer, and ``ln_f``."""

    def __init__(self, embed: Embed, mlstm, slstm, ln_f: RMSNorm):
        super().__init__()
        self.embed = embed
        self.mlstm = nn.ModuleList(nn.ModuleList(g) for g in mlstm)
        self.slstm = nn.ModuleList(slstm)
        self.ln_f = ln_f


def n_groups(cfg: ModelConfig) -> int:
    """The number of stacked groups of the hybrid (Mamba2 groups = shared-
    block calls), the VLM (self-attention groups = cross layers) and xLSTM
    (mLSTM groups = sLSTM layers); the reference's ``n_stacked``."""
    period = {"hybrid": cfg.shared_block_period,
              "vlm": cfg.cross_attn_period,
              "ssm": cfg.slstm_every}[cfg.family]
    return cfg.n_layers // period


def n_stacked(cfg: ModelConfig) -> int:
    """The reference's stacked layer axis (its scan's trip count): every
    layer of the dense, MoE and audio families, else ``n_groups``."""
    if cfg.family in ("dense", "moe", "audio"):
        return cfg.n_layers
    return n_groups(cfg)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_model(cfg: ModelConfig, *, seed: int = 0,
               device="cuda") -> nn.Module:
    """Random weights (N(0, 0.02^2)) drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``. The draws cannot reproduce
    the reference's ``jax.random`` bits; to compare with it, carry its
    weights across with ``repro_torch.bridge.params_from_jax``. On the
    ``meta`` device (the dry run) the weights are shapes and dtypes only,
    drawn from no generator."""
    check_family(cfg)
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    dt = pdtype(cfg)
    with torch.no_grad():
        embed = embed_init(gen, cfg, dev)
        ln_f = RMSNorm.ones(cfg.d_model, dt, dev)
        if cfg.family == "vlm":
            per, g = cfg.cross_attn_period - 1, n_groups(cfg)
            self_blocks = [[transformer.block_init(gen, cfg, dev)
                            for _ in range(per)] for _ in range(g)]
            cross = [transformer.cross_block_init(gen, cfg, dev)
                     for _ in range(g)]
            return VLMModel(embed, self_blocks, cross, ln_f)
        if cfg.family == "ssm":
            per, g = cfg.slstm_every - 1, n_groups(cfg)
            mlstm = [[xlstm.mlstm_init(gen, cfg, dev) for _ in range(per)]
                     for _ in range(g)]
            slstm = [xlstm.slstm_init(gen, cfg, dev) for _ in range(g)]
            return XLSTMModel(embed, mlstm, slstm, ln_f)
        if cfg.family == "hybrid":
            groups = [[mamba2.mamba_init(gen, cfg, dev)
                       for _ in range(cfg.shared_block_period)]
                      for _ in range(n_groups(cfg))]
            d = cfg.d_model
            in_map = (torch.randn((2 * d, d), generator=gen, device=dev)
                      * 0.02).to(dt)
            block = transformer.block_init(gen, cfg, dev)
            out_map = (torch.randn((d, d), generator=gen, device=dev)
                       * 0.02).to(dt)
            return HybridModel(embed, groups,
                               SharedBlock(in_map, block, out_map), ln_f)
        init = (transformer.moe_block_init if cfg.family == "moe"
                else transformer.block_init)
        blocks = [init(gen, cfg, dev) for _ in range(cfg.n_layers)]
        return DenseModel(embed, blocks, ln_f)


# ---------------------------------------------------------------------------
# KV cache (paged layout)
# ---------------------------------------------------------------------------


def cache_init(cfg: ModelConfig, rc: RunConfig, batch: int, max_seq: int,
               *, device="cuda") -> Dict:
    """Zeroed paged cache ``{"kv": {"k","v"}: [L,B,P,page,Hkv,D],
    "pos": int32 [B]}`` in the model dtype; a hybrid model has one K/V
    layer per group (L = groups) and zeroed f32 ``"h"``/``"conv"``
    states; a VLM one per self-attention layer and zeroed vision K/V
    ``"cross_k"``/``"cross_v"`` [g,B,Nv,Hkv,D]; xLSTM no ``"kv"``, only
    its zeroed f32 states (the reference's engine cache: not the state
    initialisers' -1e9 and 1e-6). With ``rc.kv_quant == "int8"`` the
    ``k``/``v`` leaves are int8 codes and gain f32 ``k_scale``/``v_scale``
    leaves [L,B,P,Hkv] filled with ``kv_quant.INIT_SCALE``."""
    check_family(cfg)
    quant = kv_quant.validate_mode(rc.kv_quant) == "int8"
    dev = resolve_device(device)
    fam = cfg.family
    f32 = dict(dtype=torch.float32, device=dev)
    pos = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if fam == "ssm":
        g, m = n_groups(cfg), cfg.slstm_every - 1
        d_in, nh = cfg.mlstm_expand * cfg.d_model, cfg.n_heads
        dh_m, dh_s = d_in // nh, cfg.d_model // nh
        conv = xlstm.CONV - 1
        cache = {"mC": (g, m, batch, nh, dh_m, dh_m),
                 "mn": (g, m, batch, nh, dh_m), "mm": (g, m, batch, nh),
                 "mconv": (g, m, batch, conv, d_in),
                 "sh": (g, batch, nh, dh_s), "sc": (g, batch, nh, dh_s),
                 "sn": (g, batch, nh, dh_s), "sm": (g, batch, nh, dh_s),
                 "sconv": (g, batch, conv, cfg.d_model)}
        cache = {name: torch.zeros(shape, **f32)
                 for name, shape in cache.items()}
        cache["pos"] = pos
        return cache
    page = min(rc.kv_page_size, max_seq)
    n_pages = max(max_seq // page, 1)
    n_kv = cfg.n_layers
    if fam == "hybrid":
        n_kv = n_groups(cfg)
    elif fam == "vlm":
        n_kv = n_groups(cfg) * (cfg.cross_attn_period - 1)
    shape = (n_kv, batch, n_pages, page, cfg.n_kv_heads, cfg.head_dim)
    kv_dt = torch.int8 if quant else pdtype(cfg)
    kv = {"k": torch.zeros(shape, dtype=kv_dt, device=dev),
          "v": torch.zeros(shape, dtype=kv_dt, device=dev)}
    if quant:
        for name in ("k_scale", "v_scale"):
            kv[name] = torch.full(shape[:3] + shape[4:5],
                                  kv_quant.INIT_SCALE, **f32)
    cache = {"kv": kv, "pos": pos}
    if fam == "hybrid":
        lead = (n_groups(cfg), cfg.shared_block_period)
        for name, a in mamba2.mamba_state_init(cfg, batch,
                                               device=dev).items():
            cache[name] = a.expand(lead + a.shape).contiguous()
    if fam == "vlm":
        vshape = (n_groups(cfg), batch, cfg.n_vision_tokens,
                  cfg.n_kv_heads, cfg.head_dim)
        for name in ("cross_k", "cross_v"):
            cache[name] = torch.zeros(vshape, dtype=pdtype(cfg), device=dev)
    return cache


def decode_axes(rc: RunConfig, batch: int):
    """(batch axes, page axes) of the page-sharded decode cache, as the
    reference names them: a batch of more than one row over the data
    axes (with ``multi_pod`` the (pod, data) product), the pages over the
    model axis; one row's pages over every axis."""
    dp = ("pod", "data") if rc.mesh.multi_pod else "data"
    if batch == 1:
        return None, (dp if isinstance(dp, tuple) else (dp,)) + ("model",)
    return dp, "model"


def cache_specs(cfg: ModelConfig, rc: RunConfig, batch: int) -> Dict:
    """The reference's ``cache_specs``: the spec of every leaf of
    ``cache_init(cfg, rc, batch, ...)`` (a tuple of axis names or None a
    dimension, leading stack axes included), as
    ``parallel.sharding.shard_cache`` cuts a rank's part: the K/V pages
    and their int8 scales over the batch and page axes, the vision K/V
    and ``pos`` over the batch axes, a recurrent state over the batch
    axes at its batch axis."""
    batch_axes, page_axes = decode_axes(rc, batch)
    cache = cache_init(cfg, rc, batch, max_seq=rc.kv_page_size,
                       device="meta")
    out = {}
    for name, a in cache.items():
        if name == "kv":
            out["kv"] = {n: (None, batch_axes, page_axes) + (None,) * (
                t.dim() - 3) for n, t in a.items()}
            continue
        spec = [None] * a.dim()
        spec[_BATCH_AXIS[name]] = batch_axes
        out[name] = tuple(spec)
    return out


# batch axis of each cache leaf ("kv" leaves: 1)
_BATCH_AXIS = sharding.CACHE_BATCH_AXIS


def slot_view(cache: Dict, slot: int) -> Dict:
    """Views of one batch row of every cache leaf, each along its own
    batch axis: writes through them land in ``cache``."""
    out = {}
    for name, a in cache.items():
        if name == "kv":
            out["kv"] = {n: t[:, slot:slot + 1] for n, t in a.items()}
        else:
            out[name] = a.narrow(_BATCH_AXIS[name], slot, 1)
    return out


def _layer_kv(cache: Dict, i: int) -> Dict[str, torch.Tensor]:
    return {name: a[i] for name, a in cache["kv"].items()}


def _mamba_layers(layers, cfg: ModelConfig, x: torch.Tensor, state: Dict,
                  step, group=None) -> torch.Tensor:
    """One group's Mamba2 ``layers`` through ``step`` (``mamba_step`` or
    ``mamba_prefill_chunk``, over a rank ``group``), residual added; the
    group's states (``state["h"]`` / ``["conv"]`` [period, B, ...]) are
    written in place."""
    for i, layer in enumerate(layers):
        st = {name: state[name][i] for name in ("h", "conv")}
        y, new = step(layer, cfg, x, st, group)
        x = x + y
        for name in ("h", "conv"):
            st[name].copy_(new[name])
    return x


# the xLSTM steps' state names -> the cache's leaves
_MLSTM_STATE = {"C": "mC", "n": "mn", "m": "mm", "conv": "mconv"}
_SLSTM_STATE = {"h": "sh", "c": "sc", "n": "sn", "m": "sm", "conv": "sconv"}


def _state_step(fn, layer, cfg: ModelConfig, x: torch.Tensor, leaves: Dict,
                names: Dict[str, str], idx, group=None) -> torch.Tensor:
    """``x, new = fn(layer, cfg, x, state, group)`` on the state held in
    the cache leaves ``names`` (of ``leaves``) at ``idx``, which take
    ``new`` in place."""
    state = {k: leaves[n][idx] for k, n in names.items()}
    x, new = fn(layer, cfg, x, state, group)
    for k, t in state.items():
        t.copy_(new[k])
    return x


def _shared_in(sp: SharedBlock, x: torch.Tensor,
               emb: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, emb], dim=-1) @ sp.in_map


def _embed(embed: Embed, cfg: ModelConfig, tokens: torch.Tensor,
           positions: torch.Tensor, group=None,
           train: bool = False) -> torch.Tensor:
    """The token embedding (over a rank ``group`` where its table is
    split; differentiably with ``train``), plus the sinusoidal positions
    (positions [B, S]) for a model without rope (musicgen, xLSTM)."""
    x = embed_apply(embed, cfg, tokens, group, train=train)
    if cfg.family == "audio" or not cfg.use_rope:
        x = x + sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
    return x


# ---------------------------------------------------------------------------
# train forward + loss
# ---------------------------------------------------------------------------


def _shared_block_apply(sp: SharedBlock, cfg: ModelConfig, x: torch.Tensor,
                        emb: torch.Tensor, positions: torch.Tensor,
                        group=None) -> torch.Tensor:
    """zamba2's shared block over a sequence: concat(x, emb) -> in_map ->
    the dense block -> out_map, added to x. Over a model ``group`` the
    dense block runs its shard (``transformer.block_apply``); ``in_map``
    and ``out_map`` are whole and used alike on every rank, on whole
    activations."""
    z = transformer.block_apply(sp.block, cfg, _shared_in(sp, x, emb),
                                positions, group=group)
    return x + z @ sp.out_map


def _body_train(cfg: ModelConfig, rc: RunConfig, positions: torch.Tensor,
                shared=None, vision=None, batch=None, model=None,
                data=None):
    """The layer stream's body for one stacked step of ``cfg``'s family:
    ``body((x, aux), layer) -> (x, aux)``; ``aux`` sums the MoE layers'
    load-balance losses. ``batch``: the rank group the batch's rows are
    split over (the MoE routes the whole batch, or at a model axis of
    more than one rank its rows); ``model``: the model axis's group, over
    which the dense, audio and MoE blocks run their shards (Megatron's
    form, ``transformer.block_apply``); ``data``: the MoE's token rows
    beside the model axis (``moe.moe_block_apply``). Over a model axis
    the hybrid's Mamba2 layers run their heads and its shared block its
    shard (``mamba2.mamba_apply``), the VLM's cross layers Megatron's form
    from the vision embeddings (``transformer.cross_block_train``), and
    xLSTM's layers whole and alike on every rank from their split
    leaves gathered whole (``xlstm.mlstm_apply``, ``slstm_apply``)."""
    fam = cfg.family

    def body(carry, layer):
        x, aux = carry
        if fam in ("dense", "audio"):
            return transformer.block_apply(layer, cfg, x, positions,
                                           use_pallas=rc.use_pallas,
                                           group=model), aux
        if fam == "moe":
            x, a = moe.moe_block_apply(layer, cfg, x, positions, batch=batch,
                                       group=model, data=data)
            return x, aux + a
        if fam == "vlm":
            self_blocks, cross = layer
            for blk in self_blocks:
                x = transformer.block_apply(blk, cfg, x, positions,
                                            group=model)
            return transformer.cross_block_train(cross, cfg, x, vision,
                                                 model), aux
        if fam == "hybrid":
            for m in layer:
                x = x + mamba2.mamba_apply(m, cfg, x, group=model)
            return _shared_block_apply(shared["params"], cfg, x,
                                       shared["emb"], positions,
                                       group=model), aux
        if fam == "ssm":
            mlstm, slstm = layer
            for m in mlstm:
                x = xlstm.mlstm_apply(m, cfg, x, group=model)
            return xlstm.slstm_apply(slstm, cfg, x, group=model), aux
        raise ValueError(fam)

    return body


def check_trainable(cfg: ModelConfig) -> None:
    """Raise for a family without training forms. A trained family trains
    on any mesh -- over the data, pod and model axes -- and on every tier
    pair."""
    if cfg.family not in TRAINED_FAMILIES:
        raise NotImplementedError(
            f"training the {cfg.family!r} family is not ported "
            f"(trained: {TRAINED_FAMILIES})")


def loss_fn(params: nn.Module, cfg: ModelConfig, rc: RunConfig,
            batch: Dict[str, torch.Tensor], *, group=None,
            reducer=None, host_grads=None,
            ranks: Optional["Ranks"] = None) -> torch.Tensor:
    """The training loss: mean next-token cross-entropy (plus the MoE
    layers' load-balance loss). batch: ``tokens`` and ``labels`` [B, S]
    (audio [B, K, S]) and, for the VLM, ``vision_embeds`` [B, Nv, d].

    The layers run through the speculative-read stream
    (``rc.sr_prefetch_depth``, ``rc.sr_granularity``) with ``rc.remat`` and
    ``rc.remat_policy``; with ``rc.use_pallas`` the dense and audio blocks'
    attention runs the flash-prefill kernel, which has no backward (a
    forward under ``torch.no_grad`` only).

    Over a rank ``group`` (the data axis, or pod and data: the FSDP and
    batch axes; ``ranks.fsdp``) ``params`` is this rank's POOL-tier shard
    and ``batch`` its rows of the global batch: the leaves outside the
    stream (the embedding, tied or not, and the hybrid's shared block) are
    gathered once, differentiably, the stream's layers each in its
    remat'd body (``core.speculative_read``), their gradients reduced to
    the shards by ``reducer`` (the deterministic store). The loss
    returned is the global mean: each rank's mean averaged over the group
    (``sharding.mean_over``), each rank's gradient its share of it; the
    MoE routes the whole batch, so its aux loss counts once. With the
    weights on the HOST tier every read copies its leaves onto the card
    first (the leaves outside the stream once a step, the final norm
    among them), the layers ``rc.sr_prefetch_depth`` ahead, and the
    leaves' card gradients go to ``host_grads`` (``sharding.HostGrads``).

    Over a model axis (``ranks.model``, N > 1; every family) ``params``
    holds this rank's shard of every leaf ``param_specs`` splits on
    "model", and the activations are whole on every model rank between
    blocks (Megatron's form): the embedding looked up over the rank's
    vocabulary rows and summed, each block over its heads, d_ff columns
    and experts (``transformer.block_apply``, ``moe.moe_block_apply``,
    the VLM's ``transformer.cross_block_train``), the Mamba2 layers over
    their heads (``mamba2.mamba_apply``), xLSTM's layers whole on every
    rank from gathered leaves (``xlstm.mlstm_apply``, ``slstm_apply``), the
    cross-entropy over the rank's vocabulary columns
    (``layers.vocab_parallel_xent``). Every model rank computes
    the same loss; the gathers, copies and reductions stay over the data
    axes."""
    check_trainable(cfg)
    if ranks is None:
        ranks = Ranks(fsdp=group, batch=group)
    group, model = ranks.fsdp, ranks.model
    train = model is not None and model.size > 1
    tokens = batch["tokens"]
    bsz, seq = tokens.shape[0], tokens.shape[-1]
    positions = torch.arange(seq, dtype=torch.int32,
                             device=tokens.device)[None].expand(bsz, seq)
    top = sharding.gather_train(_outside(params, cfg), group,
                                rc.sr_granularity, reducer, sink=host_grads)
    x = _embed(top[0], cfg, tokens, positions, model, train=train)
    shared = ({"params": top[2], "emb": x}
              if cfg.family == "hybrid" else None)
    body = _body_train(cfg, rc, positions, shared=shared,
                       vision=batch.get("vision_embeds"), batch=ranks.batch,
                       model=model if train else None, data=ranks.data)
    aux0 = torch.zeros((), dtype=torch.float32, device=x.device)
    x, aux = sr.stream_layers(
        body, (x, aux0), _units(params, cfg),
        prefetch_depth=rc.sr_prefetch_depth, granularity=rc.sr_granularity,
        mode="train", remat=rc.remat, remat_policy=rc.remat_policy,
        group=group, reducer=reducer, host_grads=host_grads)
    x = rmsnorm(top[1], x, cfg.norm_eps)
    loss = _chunked_xent(top[0], cfg, x, batch["labels"],
                         group=model if train else None) + aux
    return sharding.mean_over(group, loss)


def _chunked_xent(embed: Embed, cfg: ModelConfig, x: torch.Tensor,
                  labels: torch.Tensor, n_chunks: int = 8,
                  group=None) -> torch.Tensor:
    """Cross-entropy over ``n_chunks`` slices of the sequence (one when S
    does not divide), so the [T, V] logits are never whole; audio labels
    keep their [B, K, S] layout. Under grad each chunk is recomputed in
    the backward pass, so no chunk's logits are held across the loss.
    With the vocabulary split over a model ``group`` each chunk is the
    vocabulary-parallel cross-entropy (``layers.vocab_parallel_xent``)."""
    b, s, _ = x.shape
    if s % n_chunks or s // n_chunks == 0:
        n_chunks = 1
    cs = s // n_chunks
    split = group is not None and table_split(embed, cfg)

    def chunk(xc, lc):
        if split:
            return vocab_parallel_xent(embed, cfg, xc, lc, group)
        return softmax_xent(unembed_apply(embed, cfg, xc), lc)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        xc, lc = x[:, i * cs:(i + 1) * cs], labels[..., i * cs:(i + 1) * cs]
        if torch.is_grad_enabled() and xc.requires_grad:
            total = total + checkpoint(chunk, xc, lc, use_reentrant=False)
        else:
            total = total + chunk(xc, lc)
    return total / n_chunks


# ---------------------------------------------------------------------------
# decode / prefill
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Ranks:
    """The rank groups (``launch.mesh.RankGroup``; None: one rank) a
    serving step runs over: ``model`` for the weights split on the model
    axis, ``pages`` for the cache's page axis, ``fsdp`` for the POOL
    tier's gathers (the speculative read), ``batch`` for the rows of slots
    the decode batch is split into (the MoE routes the whole batch);
    in training, ``data`` for the data axis alone, over which the MoE
    shards its tokens beside the model axis even where the batch splits
    over (pod, data) (the reference's ``moe_apply_ep`` default)."""

    model: Optional[object] = None
    pages: Optional[object] = None
    fsdp: Optional[object] = None
    batch: Optional[object] = None
    data: Optional[object] = None


def _ranks(group, ranks: Optional[Ranks]) -> Ranks:
    """``ranks``, or the model axis alone: a rank ``group`` for the
    weights and the pages."""
    return ranks if ranks is not None else Ranks(model=group, pages=group)


def check_ranks(cfg: ModelConfig, mesh_shape, multi_pod: bool = False
                ) -> None:
    """Raise for a mesh this family does not serve on. Every family
    serves over the model axis (tp: a page-sharded cache, weights split
    by ``parallel.sharding.param_specs``, expert-parallel MoE, whole
    per-slot states) and over the data and pod axes (POOL-tier weights
    gathered by the speculative read, slots split over the batch axes);
    the MoE family not over both at once, as the reference's does not
    (``moe.check_mesh``)."""
    if not mesh_shape:
        return
    p_n, d_n, n = (1,) * (3 - len(mesh_shape)) + tuple(mesh_shape)
    if cfg.family == "moe":
        moe.check_mesh(d_n * (p_n if multi_pod else 1), n)


def _units(params: nn.Module, cfg: ModelConfig):
    """The layer stream's steps, in training and serving: a block (dense,
    MoE, audio), a group of Mamba2 layers (hybrid), a group's
    self-attention blocks with its cross layer (VLM), or a group's mLSTM
    layers with its sLSTM layer (xLSTM) -- the reference's stacked
    axis."""
    if cfg.family == "vlm":
        return list(zip(params.self_blocks, params.cross))
    if cfg.family == "ssm":
        return list(zip(params.mlstm, params.slstm))
    if cfg.family == "hybrid":
        return params.groups
    return params.blocks


def _outside(params: nn.Module, cfg: ModelConfig) -> tuple:
    """The leaves a step uses outside the layer stream, read once a step:
    the embedding (and unembedding), the final norm, and the hybrid's
    shared block."""
    if cfg.family == "hybrid":
        return (params.embed, params.ln_f, params.shared)
    return (params.embed, params.ln_f)


def _unit_extras(cfg: ModelConfig, cache: Dict, n: int):
    """Each stream step's slice of the cache (updated in place): a
    block's pages; a hybrid group's shared-block pages and Mamba2
    states; a VLM group's self-attention pages and vision K/V; an xLSTM
    group's states."""
    fam = cfg.family
    if fam == "ssm":
        return [{name: cache[name][gi] for name in
                 (*_MLSTM_STATE.values(), *_SLSTM_STATE.values())}
                for gi in range(n)]
    if fam == "hybrid":
        return [{"kv": _layer_kv(cache, gi), "h": cache["h"][gi],
                 "conv": cache["conv"][gi]} for gi in range(n)]
    if fam == "vlm":
        per = cfg.cross_attn_period - 1
        return [{"kv": [_layer_kv(cache, gi * per + i) for i in range(per)],
                 "cross_k": cache["cross_k"][gi],
                 "cross_v": cache["cross_v"][gi]} for gi in range(n)]
    return [_layer_kv(cache, i) for i in range(n)]


def _stream(params: nn.Module, cfg: ModelConfig, rc: RunConfig,
            x: torch.Tensor, cache: Dict, r: Ranks, shared, attend,
            mamba_step) -> torch.Tensor:
    """``x`` through every layer on the speculative-read stream
    (``rc.sr_prefetch_depth`` layers in flight, their FSDP axes gathered
    over ``r.fsdp``); ``attend(block, x, kv)`` is the attention block's
    step (decode or chunked prefill), ``mamba_step`` the Mamba2 layers',
    ``shared`` the gathered leaves outside the stream but the embedding
    (the hybrid's shared block)."""
    fam, g = cfg.family, r.model
    units = _units(params, cfg)
    if fam == "hybrid":
        emb, (shared,) = x, shared

        def body(x, layers, st):
            x = _mamba_layers(layers, cfg, x, st, mamba_step, g)
            z = attend(shared.block, _shared_in(shared, x, emb), st["kv"])
            return x + z @ shared.out_map
    elif fam == "vlm":
        def body(x, unit, st):
            blocks, cross = unit
            for blk, kv in zip(blocks, st["kv"]):
                x = attend(blk, x, kv)
            return transformer.cross_block_apply(cross, cfg, x,
                                                 st["cross_k"],
                                                 st["cross_v"], group=g)
    elif fam == "ssm":
        def body(x, unit, st):
            mlstm, slstm = unit
            for i, layer in enumerate(mlstm):
                x = _state_step(xlstm.mlstm_step, layer, cfg, x, st,
                                _MLSTM_STATE, i, g)
            return _state_step(xlstm.slstm_step, slstm, cfg, x, st,
                               _SLSTM_STATE, slice(None), g)
    else:
        def body(x, block, kv):
            return attend(block, x, kv)
    return sr.stream_layers(body, x, units,
                            prefetch_depth=rc.sr_prefetch_depth,
                            granularity=rc.sr_granularity, mode="infer",
                            remat=False, group=r.fsdp,
                            extras=_unit_extras(cfg, cache, len(units)))


def join_fsdp_reads(params: nn.Module, cfg: ModelConfig, rc: RunConfig, *,
                    ranks: Ranks) -> None:
    """A step's POOL-tier gathers over ``ranks.fsdp``, in the step's order
    (the leaves outside the stream, then the stream's), and nothing
    else: what a rank of the data axis runs while another row prefills
    one of its own slots, so that every rank of the group enters the
    same gathers."""
    sr.materialize(_outside(params, cfg), rc.sr_granularity, ranks.fsdp,
                   label="outside")
    sr.stream_layers(lambda x, layer: x, None, _units(params, cfg),
                     prefetch_depth=rc.sr_prefetch_depth,
                     granularity=rc.sr_granularity, mode="infer",
                     remat=False, group=ranks.fsdp)


@torch.no_grad()
def decode_step(params: nn.Module, cfg: ModelConfig, rc: RunConfig,
                tokens: torch.Tensor, cache: Dict, *, group=None,
                ranks: Optional[Ranks] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode for every row. tokens: [B, 1] -> logits [B, 1, V]
    (audio: [B, K, 1] -> [B, K, 1, V]).

    Writes each row's new K/V at its ``cache["pos"]`` and advances every
    row's position by one, in place. The layers stream through the
    speculative read (``core.speculative_read.stream_layers``,
    ``mode="infer"``). With a rank ``group`` (the model axis) or
    ``ranks``, the cache's pages are this rank's shard and the weights
    this rank's (``parallel.sharding``): the attention is the page-sharded
    decode, the MoE the expert-parallel one, the Mamba2 layers run this
    rank's heads; the recurrent states and the vision K/V are whole on
    every rank of the model axis and stay equal there. With POOL-tier
    weights (``ranks.fsdp``) each layer's FSDP axes are gathered before
    use; the leaves outside the stream once, first. With the batch split
    (``ranks.batch``) the rows are this rank's slots."""
    check_family(cfg)
    r = _ranks(group, ranks)
    top = sr.materialize(_outside(params, cfg), rc.sr_granularity, r.fsdp,
                         label="outside")
    pos = cache["pos"]
    x = _embed(top[0], cfg, tokens, pos.reshape(-1, 1).to(torch.int32),
               r.model)

    def attend(block, x, kv):
        return transformer.block_decode_paged(block, cfg, x, pos, kv,
                                              group=r.model, pages=r.pages,
                                              batch=r.batch)
    x = _stream(params, cfg, rc, x, cache, r, top[2:], attend,
                mamba2.mamba_step)
    x = rmsnorm(top[1], x, cfg.norm_eps)
    logits = unembed_apply(top[0], cfg, x, r.model)
    cache["pos"] += 1
    return logits, cache


@torch.no_grad()
def prefill_step_cached(params: nn.Module, cfg: ModelConfig,
                        rc: RunConfig, tokens: torch.Tensor, cache: Dict, *,
                        last_only: bool = False, group=None,
                        ranks: Optional[Ranks] = None
                        ) -> Tuple[torch.Tensor, Dict]:
    """Chunked multi-token prefill that writes the paged KV cache in place.

    tokens: [B, C] int (audio: [B, K, C]). Every row ingests its C tokens
    starting at its own ``cache["pos"]``; returns (logits [B, C, V] — or
    only the last position's, [B, 1, V], with ``last_only``; audio [B, K,
    C or 1, V] — and the cache with pos advanced by C). With a rank
    ``group`` or ``ranks``, as in ``decode_step``.
    """
    check_family(cfg)
    r = _ranks(group, ranks)
    top = sr.materialize(_outside(params, cfg), rc.sr_granularity, r.fsdp,
                         label="outside")
    pos = cache["pos"]
    c = tokens.shape[-1]
    positions = (pos.reshape(-1, 1).to(torch.int32)
                 + torch.arange(c, dtype=torch.int32,
                                device=tokens.device)[None])
    x = _embed(top[0], cfg, tokens, positions, r.model)
    stepwise = cfg.family in ("hybrid", "vlm")

    def attend(block, x, kv):
        return transformer.block_prefill_cached(block, cfg, x, positions,
                                                pos, kv, stepwise=stepwise,
                                                group=r.model, pages=r.pages)
    x = _stream(params, cfg, rc, x, cache, r, top[2:], attend,
                mamba2.mamba_prefill_chunk)
    if last_only:
        x = x[:, -1:]
    x = rmsnorm(top[1], x, cfg.norm_eps)
    logits = unembed_apply(top[0], cfg, x, r.model)
    cache["pos"] += c
    return logits, cache


@torch.no_grad()
def prefill_step(params: nn.Module, cfg: ModelConfig, rc: RunConfig,
                 batch: Dict[str, torch.Tensor], *, group=None,
                 ranks: Optional[Ranks] = None) -> torch.Tensor:
    """The reference's non-cached prefill forward: the whole prompt
    through the training forward with no cache and no remat, the last
    position's logits [B, 1, V] (audio [B, K, 1, V]). batch: ``tokens``
    [B, S] (audio [B, K, S]) and, for the VLM, ``vision_embeds``. The
    layers stream through the speculative read (``mode="infer"``), their
    FSDP axes gathered over ``ranks.fsdp``. Over a model axis (a rank
    ``group`` or ``ranks.model``; every family) the layers run this rank's
    shard as the training forward does (the MoE expert-parallel over the
    sequence) and the logits are gathered whole."""
    r = _ranks(group, ranks)
    model = r.model if r.model is not None and r.model.size > 1 else None
    top = sr.materialize(_outside(params, cfg), rc.sr_granularity, r.fsdp,
                         label="outside")
    tokens = batch["tokens"]
    bsz, seq = tokens.shape[0], tokens.shape[-1]
    positions = torch.arange(seq, dtype=torch.int32,
                             device=tokens.device)[None].expand(bsz, seq)
    x = _embed(top[0], cfg, tokens, positions, model)
    shared = ({"params": top[2], "emb": x}
              if cfg.family == "hybrid" else None)
    body = _body_train(cfg, rc, positions, shared=shared,
                       vision=batch.get("vision_embeds"), batch=r.batch,
                       model=model, data=r.data)
    aux0 = torch.zeros((), dtype=torch.float32, device=x.device)
    x, _ = sr.stream_layers(body, (x, aux0), _units(params, cfg),
                            prefetch_depth=rc.sr_prefetch_depth,
                            granularity=rc.sr_granularity, mode="infer",
                            remat=False, group=r.fsdp)
    x = rmsnorm(top[1], x[:, -1:], cfg.norm_eps)
    return unembed_apply(top[0], cfg, x, model)


# ---------------------------------------------------------------------------
# on-device sampling
# ---------------------------------------------------------------------------


def last_token_logits(logits: torch.Tensor) -> torch.Tensor:
    """Final-position logits row per batch element: [B, S, V] -> [B, V];
    audio [B, K, S, V] -> codebook 0's (the engine feeds the one sampled
    token to every codebook)."""
    if logits.ndim == 4:
        return logits[:, 0, -1]
    return logits[:, -1]


def sample_tokens(logits_row: torch.Tensor, u: Optional[torch.Tensor],
                  temperature: float) -> torch.Tensor:
    """Greedy / temperature sampling on device. logits_row: [B, V] -> [B].

    Temperature sampling inverts the softmax CDF at one uniform per row,
    ``u`` ([B], in [0, 1)); the caller draws it (the engine from its seeded
    ``torch.Generator``), so a test can feed the reference's draw.
    """
    row = logits_row.float()
    if temperature and temperature > 0:
        p = torch.softmax(row / temperature, dim=-1)
        cdf = torch.cumsum(p, dim=-1)
        return (cdf < u[:, None] * cdf[:, -1:]).sum(dim=-1).to(torch.int32)
    return torch.argmax(row, dim=-1).to(torch.int32)
