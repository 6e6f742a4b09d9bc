"""Model assembly for the dense, MoE, audio, hybrid, VLM and xLSTM
families: init, paged cache, decode and chunked prefill steps, on-device
sampling, and the training loss (every family but xLSTM).

The reference streams a stacked layer axis through its speculative-read
scan; the training loss streams the layers through the port's
``core.speculative_read.stream_layers`` (a loop on one rank, with remat),
and the serving steps are a plain loop over ``DenseModel.blocks``,
``HybridModel.groups``, ``VLMModel.self_blocks`` / ``cross`` or
``XLSTMModel.mlstm`` / ``slstm`` (the reference's serving engine drops the
prefetch for a single device too). The MoE family (granite) is a
``DenseModel`` of ``MoEBlock``s; the audio family (musicgen) a
``DenseModel`` of dense blocks over K codebook tables: its tokens are [B,
K, S], their K rows summed, sinusoidal positions added at each row's own
positions, and its logits [B, K, S, V]. All three share the dense cache
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

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import speculative_read as sr
from repro_torch.device import resolve_device
from repro_torch.models import kv_quant, mamba2, moe, transformer, xlstm
from repro_torch.models.layers import (Embed, RMSNorm, embed_apply,
                                       embed_init, frozen_param, pdtype,
                                       rmsnorm, sinusoidal_positions,
                                       softmax_xent, unembed_apply)

PORTED_FAMILIES = ("dense", "moe", "audio", "hybrid", "vlm", "ssm")
# families with a training forward (``loss_fn``); xLSTM's training forms
# (the reference's chunkwise ``mlstm_apply`` and ``slstm_apply``) are the
# next slice's
TRAINED_FAMILIES = ("dense", "moe", "audio", "hybrid", "vlm")


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


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_model(cfg: ModelConfig, *, seed: int = 0,
               device="cuda") -> nn.Module:
    """Random weights (N(0, 0.02^2)) drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``. The draws cannot reproduce
    the reference's ``jax.random`` bits; to compare with it, carry its
    weights across with ``repro_torch.bridge.params_from_jax``."""
    check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
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


# batch axis of each cache leaf ("kv" leaves: 1)
_BATCH_AXIS = {"pos": 0, "h": 2, "conv": 2, "cross_k": 1, "cross_v": 1,
               "mC": 2, "mn": 2, "mm": 2, "mconv": 2, "sh": 1, "sc": 1,
               "sn": 1, "sm": 1, "sconv": 1}


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


def _mamba_layers(params: HybridModel, cfg: ModelConfig, x: torch.Tensor,
                  cache: Dict, gi: int, step) -> torch.Tensor:
    """Group ``gi``'s Mamba2 layers through ``step`` (``mamba_step`` or
    ``mamba_prefill_chunk``), residual added, states written in place."""
    for i, layer in enumerate(params.groups[gi]):
        state = {name: cache[name][gi, i] for name in ("h", "conv")}
        y, new = step(layer, cfg, x, state)
        x = x + y
        for name in ("h", "conv"):
            state[name].copy_(new[name])
    return x


def _vlm_layers(params: VLMModel, cfg: ModelConfig, x: torch.Tensor,
                cache: Dict, self_block) -> torch.Tensor:
    """Every group's self-attention blocks through ``self_block(block, x,
    kv)`` (the paged decode or the chunked prefill, on the group-major
    K/V layer), then its cross layer over the group's vision K/V."""
    per = cfg.cross_attn_period - 1
    for gi, group in enumerate(params.self_blocks):
        for i, block in enumerate(group):
            x = self_block(block, x, _layer_kv(cache, gi * per + i))
        x = transformer.cross_block_apply(params.cross[gi], cfg, x,
                                          cache["cross_k"][gi],
                                          cache["cross_v"][gi])
    return x


# the xLSTM steps' state names -> the cache's leaves
_MLSTM_STATE = {"C": "mC", "n": "mn", "m": "mm", "conv": "mconv"}
_SLSTM_STATE = {"h": "sh", "c": "sc", "n": "sn", "m": "sm", "conv": "sconv"}


def _state_step(fn, layer, cfg: ModelConfig, x: torch.Tensor, cache: Dict,
                names: Dict[str, str], idx) -> torch.Tensor:
    """``x, new = fn(layer, cfg, x, state)`` on the state held in the
    cache leaves ``names`` at ``idx``, which take ``new`` in place."""
    state = {k: cache[n][idx] for k, n in names.items()}
    x, new = fn(layer, cfg, x, state)
    for k, t in state.items():
        t.copy_(new[k])
    return x


def _xlstm_layers(params: XLSTMModel, cfg: ModelConfig, x: torch.Tensor,
                  cache: Dict) -> torch.Tensor:
    """S tokens ([B, S, d]) through every group's mLSTM layers and its
    sLSTM layer, the states written in place."""
    for gi, group in enumerate(params.mlstm):
        for i, layer in enumerate(group):
            x = _state_step(xlstm.mlstm_step, layer, cfg, x, cache,
                            _MLSTM_STATE, (gi, i))
        x = _state_step(xlstm.slstm_step, params.slstm[gi], cfg, x, cache,
                        _SLSTM_STATE, gi)
    return x


def _shared_in(sp: SharedBlock, x: torch.Tensor,
               emb: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, emb], dim=-1) @ sp.in_map


def _embed(params: nn.Module, cfg: ModelConfig, tokens: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    """The token embedding, plus the sinusoidal positions (positions
    [B, S]) for a model without rope (musicgen, xLSTM)."""
    x = embed_apply(params.embed, cfg, tokens)
    if cfg.family == "audio" or not cfg.use_rope:
        x = x + sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
    return x


# ---------------------------------------------------------------------------
# train forward + loss
# ---------------------------------------------------------------------------


def _shared_block_apply(sp: SharedBlock, cfg: ModelConfig, x: torch.Tensor,
                        emb: torch.Tensor,
                        positions: torch.Tensor) -> torch.Tensor:
    """zamba2's shared block over a sequence: concat(x, emb) -> in_map ->
    the dense block -> out_map, added to x."""
    z = transformer.block_apply(sp.block, cfg, _shared_in(sp, x, emb),
                                positions)
    return x + z @ sp.out_map


def _body_train(cfg: ModelConfig, rc: RunConfig, positions: torch.Tensor,
                shared=None, vision=None):
    """The layer stream's body for one stacked step of ``cfg``'s family:
    ``body((x, aux), layer) -> (x, aux)``; ``aux`` sums the MoE layers'
    load-balance losses."""
    fam = cfg.family

    def body(carry, layer):
        x, aux = carry
        if fam in ("dense", "audio"):
            return transformer.block_apply(layer, cfg, x, positions,
                                           use_pallas=rc.use_pallas), aux
        if fam == "moe":
            x, a = moe.moe_block_apply(layer, cfg, x, positions)
            return x, aux + a
        if fam == "vlm":
            self_blocks, cross = layer
            for blk in self_blocks:
                x = transformer.block_apply(blk, cfg, x, positions)
            k, v = transformer.vision_kv(cross, cfg, vision)
            return transformer.cross_block_apply(cross, cfg, x, k, v,
                                                 chunked=True), aux
        if fam == "hybrid":
            for m in layer:
                x = x + mamba2.mamba_apply(m, cfg, x)
            return _shared_block_apply(shared["params"], cfg, x,
                                       shared["emb"], positions), aux
        raise ValueError(fam)

    return body


def _stacked_layers(params: nn.Module, cfg: ModelConfig):
    """The layer stream's steps: a block (dense, MoE, audio), a group of
    Mamba2 layers (hybrid), or a group's self-attention blocks with its
    cross layer (VLM)."""
    if cfg.family == "vlm":
        return list(zip(params.self_blocks, params.cross))
    if cfg.family == "hybrid":
        return params.groups
    return params.blocks


def check_trainable(cfg: ModelConfig) -> None:
    """Raise for a family whose training forms are not ported yet."""
    if cfg.family not in TRAINED_FAMILIES:
        raise NotImplementedError(
            f"training the {cfg.family!r} family is not ported yet: its "
            f"training forms (the reference's mlstm_apply / slstm_apply) "
            f"are the next slice's (trained: {TRAINED_FAMILIES})")


def loss_fn(params: nn.Module, cfg: ModelConfig, rc: RunConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The training loss: mean next-token cross-entropy (plus the MoE
    layers' load-balance loss). batch: ``tokens`` and ``labels`` [B, S]
    (audio [B, K, S]) and, for the VLM, ``vision_embeds`` [B, Nv, d].

    The layers run through the speculative-read stream
    (``rc.sr_prefetch_depth``, ``rc.sr_granularity``) with ``rc.remat`` and
    ``rc.remat_policy``; with ``rc.use_pallas`` the dense and audio blocks'
    attention runs the flash-prefill kernel, which has no backward (a
    forward under ``torch.no_grad`` only)."""
    check_trainable(cfg)
    tokens = batch["tokens"]
    bsz, seq = tokens.shape[0], tokens.shape[-1]
    positions = torch.arange(seq, dtype=torch.int32,
                             device=tokens.device)[None].expand(bsz, seq)
    x = _embed(params, cfg, tokens, positions)
    shared = ({"params": params.shared, "emb": x}
              if cfg.family == "hybrid" else None)
    body = _body_train(cfg, rc, positions, shared=shared,
                       vision=batch.get("vision_embeds"))
    aux0 = torch.zeros((), dtype=torch.float32, device=x.device)
    x, aux = sr.stream_layers(
        body, (x, aux0), _stacked_layers(params, cfg),
        prefetch_depth=rc.sr_prefetch_depth, granularity=rc.sr_granularity,
        mode="train", remat=rc.remat, remat_policy=rc.remat_policy)
    x = rmsnorm(params.ln_f, x, cfg.norm_eps)
    return _chunked_xent(params, cfg, x, batch["labels"]) + aux


def _chunked_xent(params: nn.Module, cfg: ModelConfig, x: torch.Tensor,
                  labels: torch.Tensor, n_chunks: int = 8) -> torch.Tensor:
    """Cross-entropy over ``n_chunks`` slices of the sequence (one when S
    does not divide), so the [T, V] logits are never whole; audio labels
    keep their [B, K, S] layout. Under grad each chunk is recomputed in
    the backward pass, so no chunk's logits are held across the loss."""
    b, s, _ = x.shape
    if s % n_chunks or s // n_chunks == 0:
        n_chunks = 1
    cs = s // n_chunks

    def chunk(xc, lc):
        return softmax_xent(unembed_apply(params.embed, cfg, xc), lc)

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


def check_ranks(cfg: ModelConfig, n_ranks: int) -> None:
    """Only the dense family runs over a page-sharded cache yet."""
    if n_ranks > 1 and cfg.family != "dense":
        raise NotImplementedError(f"the {cfg.family} family over more than "
                                  f"one rank is not ported yet")


@torch.no_grad()
def decode_step(params: nn.Module, cfg: ModelConfig, rc: RunConfig,
                tokens: torch.Tensor, cache: Dict, *, group=None
                ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode for every row. tokens: [B, 1] -> logits [B, 1, V]
    (audio: [B, K, 1] -> [B, K, 1, V]).

    Writes each row's new K/V at its ``cache["pos"]`` and advances every
    row's position by one, in place. With a rank ``group`` (the dense
    family only) the cache's pages are this rank's shard
    (``parallel.sharding``) and the attention is the page-sharded decode."""
    check_family(cfg)
    check_ranks(cfg, 1 if group is None else group.size)
    pos = cache["pos"]
    x = _embed(params, cfg, tokens, pos.reshape(-1, 1).to(torch.int32))
    if cfg.family == "hybrid":
        emb, sp = x, params.shared
        for gi in range(len(params.groups)):
            x = _mamba_layers(params, cfg, x, cache, gi, mamba2.mamba_step)
            z = transformer.block_decode_paged(sp.block, cfg,
                                               _shared_in(sp, x, emb), pos,
                                               _layer_kv(cache, gi))
            x = x + z @ sp.out_map
    elif cfg.family == "vlm":
        x = _vlm_layers(params, cfg, x, cache,
                        lambda blk, x, kv: transformer.block_decode_paged(
                            blk, cfg, x, pos, kv))
    elif cfg.family == "ssm":
        x = _xlstm_layers(params, cfg, x, cache)
    else:
        for i, block in enumerate(params.blocks):
            x = transformer.block_decode_paged(block, cfg, x, pos,
                                               _layer_kv(cache, i),
                                               group=group)
    x = rmsnorm(params.ln_f, x, cfg.norm_eps)
    logits = unembed_apply(params.embed, cfg, x)
    cache["pos"] += 1
    return logits, cache


@torch.no_grad()
def prefill_step_cached(params: nn.Module, cfg: ModelConfig,
                        rc: RunConfig, tokens: torch.Tensor, cache: Dict, *,
                        last_only: bool = False, group=None
                        ) -> Tuple[torch.Tensor, Dict]:
    """Chunked multi-token prefill that writes the paged KV cache in place.

    tokens: [B, C] int (audio: [B, K, C]). Every row ingests its C tokens
    starting at its own ``cache["pos"]``; returns (logits [B, C, V] — or
    only the last position's, [B, 1, V], with ``last_only``; audio [B, K,
    C or 1, V] — and the cache with pos advanced by C). With a rank
    ``group``, as in ``decode_step``.
    """
    check_family(cfg)
    check_ranks(cfg, 1 if group is None else group.size)
    pos = cache["pos"]
    c = tokens.shape[-1]
    positions = (pos.reshape(-1, 1).to(torch.int32)
                 + torch.arange(c, dtype=torch.int32,
                                device=tokens.device)[None])
    x = _embed(params, cfg, tokens, positions)
    if cfg.family == "hybrid":
        emb, sp = x, params.shared
        for gi in range(len(params.groups)):
            x = _mamba_layers(params, cfg, x, cache, gi,
                              mamba2.mamba_prefill_chunk)
            z = transformer.block_prefill_cached(
                sp.block, cfg, _shared_in(sp, x, emb), positions, pos,
                _layer_kv(cache, gi), stepwise=True)
            x = x + z @ sp.out_map
    elif cfg.family == "vlm":
        x = _vlm_layers(params, cfg, x, cache,
                        lambda blk, x, kv: transformer.block_prefill_cached(
                            blk, cfg, x, positions, pos, kv, stepwise=True))
    elif cfg.family == "ssm":
        x = _xlstm_layers(params, cfg, x, cache)
    else:
        for i, block in enumerate(params.blocks):
            x = transformer.block_prefill_cached(block, cfg, x, positions,
                                                 pos, _layer_kv(cache, i),
                                                 group=group)
    if last_only:
        x = x[:, -1:]
    x = rmsnorm(params.ln_f, x, cfg.norm_eps)
    logits = unembed_apply(params.embed, cfg, x)
    cache["pos"] += c
    return logits, cache


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
