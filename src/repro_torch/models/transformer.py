"""Transformer blocks: paged decode and chunked prefill steps, the
full-sequence training forward, and the VLM's gated cross-attention layer.

A block is an ``nn.Module`` of one layer's weights; the model holds one per
layer (the reference stacks them on a leading axis for its layer scan).
The dense ``Block`` and the ``MoEBlock`` share the attention half; each
brings its own feed-forward half (``ffn``): the MLP, or the routed experts.
The ``CrossBlock`` (llama-3.2-vision) attends over vision K/V that no step
writes: the serving engine leaves them at the cache's zeros, as the
reference's does. Every block takes a rank ``group`` (serving at tp > 1,
and training over a model axis: ``block_apply``, ``cross_block_train``)
and then runs on this rank's shard of the weights (``parallel.sharding``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import kv_quant, moe
from repro_torch.models.layers import (MLP, RMSNorm, frozen_param,
                                       mlp_apply, mlp_init, pdtype, rmsnorm)
from repro_torch.parallel import sharding


class Block(nn.Module):
    """One layer: ``ln_attn``, ``attn``, ``ln_mlp``, ``mlp``."""

    def __init__(self, ln_attn: RMSNorm, attention: attn.Attention,
                 ln_mlp: RMSNorm, mlp: MLP):
        super().__init__()
        self.ln_attn = ln_attn
        self.attn = attention
        self.ln_mlp = ln_mlp
        self.mlp = mlp

    def ffn(self, cfg: ModelConfig, h: torch.Tensor, *, decode: bool,
            group=None, batch=None) -> torch.Tensor:
        """The feed-forward half on the normed ``h``: the MLP (over a rank
        ``group`` where its weights are split), row by row (``batch`` is
        not needed)."""
        return mlp_apply(self.mlp, cfg, h, group)


class MoEBlock(nn.Module):
    """One MoE layer: ``ln_attn``, ``attn``, ``ln_mlp``, ``moe``."""

    def __init__(self, ln_attn: RMSNorm, attention: attn.Attention,
                 ln_mlp: RMSNorm, experts: moe.MoE):
        super().__init__()
        self.ln_attn = ln_attn
        self.attn = attention
        self.ln_mlp = ln_mlp
        self.moe = experts

    def ffn(self, cfg: ModelConfig, h: torch.Tensor, *, decode: bool,
            group=None, batch=None) -> torch.Tensor:
        """The feed-forward half on the normed ``h``: the routed experts,
        ``moe_apply_ep_decode`` on a decode tick, else ``moe_apply_ep``
        (both ``moe_apply`` on one rank, drops included; expert-parallel
        over a rank ``group``; over the whole decode batch where its rows
        are split over ``batch``; no aux loss, which serving does not
        use)."""
        if decode:
            return moe.moe_apply_ep_decode(self.moe, cfg, h, group=group,
                                           batch=batch)
        return moe.moe_apply_ep(self.moe, cfg, h, group=group, aux=False)[0]


class CrossBlock(nn.Module):
    """One gated cross-attention layer: ``ln_attn``, ``attn``, the 0-d
    ``attn_gate``, ``ln_mlp``, ``mlp`` and the 0-d ``mlp_gate`` (each
    branch scaled by tanh of its gate; both gates start at 0)."""

    def __init__(self, ln_attn: RMSNorm, attention: attn.Attention,
                 attn_gate: torch.Tensor, ln_mlp: RMSNorm, mlp: MLP,
                 mlp_gate: torch.Tensor):
        super().__init__()
        self.ln_attn = ln_attn
        self.attn = attention
        self.attn_gate = frozen_param(attn_gate)
        self.ln_mlp = ln_mlp
        self.mlp = mlp
        self.mlp_gate = frozen_param(mlp_gate)


def block_init(gen: torch.Generator, cfg: ModelConfig, device) -> Block:
    """Draw one layer's weights from ``gen``."""
    dt = pdtype(cfg)
    return Block(RMSNorm.ones(cfg.d_model, dt, device),
                 attn.attn_init(gen, cfg, device),
                 RMSNorm.ones(cfg.d_model, dt, device),
                 mlp_init(gen, cfg, device))


def moe_block_init(gen: torch.Generator, cfg: ModelConfig,
                   device) -> MoEBlock:
    """Draw one MoE layer's weights from ``gen``."""
    dt = pdtype(cfg)
    return MoEBlock(RMSNorm.ones(cfg.d_model, dt, device),
                    attn.attn_init(gen, cfg, device),
                    RMSNorm.ones(cfg.d_model, dt, device),
                    moe.moe_init(gen, cfg, device))


def cross_block_init(gen: torch.Generator, cfg: ModelConfig,
                     device) -> CrossBlock:
    """Draw one cross-attention layer from ``gen`` (attention, then MLP);
    both gates are 0, as in the reference."""
    dt = pdtype(cfg)
    attention = attn.attn_init(gen, cfg, device)
    mlp = mlp_init(gen, cfg, device)
    zero = torch.zeros((), dtype=dt, device=device)
    return CrossBlock(RMSNorm.ones(cfg.d_model, dt, device), attention,
                      zero, RMSNorm.ones(cfg.d_model, dt, device), mlp,
                      zero.clone())


def _gate(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return torch.tanh(g.float()).to(like.dtype)


def cross_block_apply(block: CrossBlock, cfg: ModelConfig, x: torch.Tensor,
                      k: torch.Tensor, v: torch.Tensor, *,
                      group=None) -> torch.Tensor:
    """The gated cross-attention layer over vision K/V in serving. x: [B,
    S, d]; k/v: [B, Nv, Hkv, D]. Every query attends to all Nv keys (no
    RoPE, no mask) in one f32 softmax: the reference's
    ``cross_block_apply`` for a sequence and its ``_decode_vlm`` cross
    layer for one token, as one function (training:
    ``cross_block_train``).

    Over a rank ``group`` the projections are this rank's shard, as the
    self-attention's are (``wq`` gathered whole, ``wo`` and the MLP's
    down product row-parallel), and the vision K/V and both gates are
    whole on every rank."""
    b, s = x.shape[0], x.shape[1]
    h = rmsnorm(block.ln_attn, x, cfg.norm_eps)
    q = attn.q_project(block.attn, cfg, h, group=group)
    o = attn.decode_attention(q, k, v)
    o = sharding.row_product(group, o.reshape(b, s, cfg.q_dim),
                             block.attn.wo, cfg.q_dim)
    x = x + _gate(block.attn_gate, x) * o
    h = rmsnorm(block.ln_mlp, x, cfg.norm_eps)
    return x + _gate(block.mlp_gate, x) * mlp_apply(block.mlp, cfg, h,
                                                    group)


def cross_block_train(block: CrossBlock, cfg: ModelConfig, x: torch.Tensor,
                      vision_embeds: torch.Tensor, group) -> torch.Tensor:
    """The gated cross-attention layer in training (the reference's
    ``cross_block_apply``): x [B, S, d]; ``vision_embeds`` [B, Nv, d],
    projected to K/V here; the attention the reference's
    ``chunked_attention`` over key blocks of up to 512 (the last one
    padded). Over a model ``group`` (x whole on every rank) it takes
    Megatron's form, as ``attention.attention_train``: this rank's q heads
    and the kv heads they read of the vision K/V
    (``attention.qkv_project_train``), ``wo``'s rows summed over the ranks
    (``attention.out_train``), the MLP over the rank's d_ff columns
    (``mlp_apply(train=True)``). The 0-d gates are whole and scale whole
    activations, so their gradients are whole on every rank."""
    b, s = x.shape[0], x.shape[1]
    h = rmsnorm(block.ln_attn, x, cfg.norm_eps)
    q, k, v, split = attn.qkv_project_train(block.attn, cfg, h, None, group,
                                            kv_x=vision_embeds)
    o = attn.chunked_attention(q, k, v, causal=False,
                               kv_block=min(512, k.shape[1]))
    o = attn.out_train(block.attn, o.reshape(b, s, -1), group, split)
    x = x + _gate(block.attn_gate, x) * o
    h = rmsnorm(block.ln_mlp, x, cfg.norm_eps)
    return x + _gate(block.mlp_gate, x) * mlp_apply(block.mlp, cfg, h,
                                                    group, train=True)


def vision_kv(block: CrossBlock, cfg: ModelConfig,
              vision_embeds: torch.Tensor, group=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V of (stubbed) vision embeddings [B, Nv, d] ->
    ([B, Nv, Hkv, D], [B, Nv, Hkv, D]). The serving path never calls it
    (it has no vision input), and the training forward projects them in
    ``cross_block_train``; the tests use it to give the cross layer K/V
    that are not zero. With ``wk``/``wv`` split over a rank ``group`` on
    their columns, the products are gathered whole."""
    b, nv = vision_embeds.shape[:2]
    shape = (b, nv, cfg.n_kv_heads, cfg.head_dim)
    # f32 embeddings (the data pipeline's) against bf16 weights promote to
    # f32, as the reference's jnp product does
    dt = torch.promote_types(vision_embeds.dtype, block.attn.wk.dtype)
    e = vision_embeds.to(dt)
    return tuple(sharding.whole_columns(group, e @ w.to(dt),
                                        cfg.kv_dim).reshape(shape)
                 for w in (block.attn.wk, block.attn.wv))


def _finish(block: Block | MoEBlock, cfg: ModelConfig, x: torch.Tensor,
            o: torch.Tensor, *, decode: bool = False,
            group=None, batch=None) -> torch.Tensor:
    """Attention output projection + residual, then the block's
    feed-forward half (``block.ffn``) + residual. With ``wo`` split over a
    rank ``group`` on its rows, each rank projects its slice of the heads'
    output (``parallel.sharding.row_parallel``)."""
    b, s = x.shape[0], x.shape[1]
    x = x + sharding.row_product(group, o.reshape(b, s, cfg.q_dim),
                                 block.attn.wo, cfg.q_dim)
    h = rmsnorm(block.ln_mlp, x, cfg.norm_eps)
    return x + block.ffn(cfg, h, decode=decode, group=group, batch=batch)


def block_apply(block: Block, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, causal: bool = True,
                kv_block: int = 512, use_pallas: bool = False,
                group=None) -> torch.Tensor:
    """The full-sequence forward of a dense block (training). x: [B, S, d];
    positions [B, S]. The attention is the plain ``chunked_attention``, or
    with ``use_pallas`` the flash-prefill kernel: the whole sequence one
    chunk at position 0 with its own K/V as the cache (Smax = S). The
    kernel has no backward, so its wrapper refuses inputs that require
    grad, as the reference cannot differentiate through its Pallas
    kernel. Over a model ``group`` of more than one rank, this rank's
    shard of the block under grad (``attention.attention_train``, the MLP's
    ``mlp_apply(train=True)``); x whole on every rank."""
    if group is not None and group.size > 1:
        x = attn.attention_train(block, cfg, x, positions, group,
                                 causal=causal, kv_block=kv_block)
        h = rmsnorm(block.ln_mlp, x, cfg.norm_eps)
        return x + mlp_apply(block.mlp, cfg, h, group, train=True)
    h = rmsnorm(block.ln_attn, x, cfg.norm_eps)
    q, k, v = attn.qkv_project(block.attn, cfg, h, positions)
    cap = cfg.attn_logit_softcap
    if not use_pallas:
        o = attn.chunked_attention(q, k, v, causal=causal,
                                   kv_block=kv_block, logit_softcap=cap)
    elif causal:
        pos = torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
        o = attn.chunk_prefill_attention(q.contiguous(), k.contiguous(),
                                         v.contiguous(), pos,
                                         logit_softcap=cap)
    else:
        raise NotImplementedError("the flash-prefill kernel is causal only")
    return _finish(block, cfg, x, o)


def block_decode_paged(block: Block | MoEBlock, cfg: ModelConfig,
                       x: torch.Tensor, pos: torch.Tensor,
                       kv: Dict[str, torch.Tensor], *,
                       group=None, pages=None,
                       batch=None) -> torch.Tensor:
    """Single-token decode against one layer's pages.

    x: [B, 1, d]; pos: int32 [B]; kv: {"k","v"} each [B, n_pages, page,
    Hkv, D] (int8 pages add f32 "k_scale"/"v_scale" [B, n_pages, Hkv]),
    written in place; with a rank ``group``, the weights' collectives run
    over it and ``kv`` holds this rank's pages of the ``pages`` group
    (default: ``group``). ``batch``: the group the decode batch's rows
    are split over (the MoE routes them whole). Returns the block output
    [B, 1, d].
    """
    pages = group if pages is None else pages
    h = rmsnorm(block.ln_attn, x, cfg.norm_eps)
    positions = pos.reshape(-1, 1).to(torch.int32)
    q, k, v = attn.qkv_project(block.attn, cfg, h, positions, group=group)
    o = attn.paged_decode_attention(q, kv["k"], kv["v"], k, v, pos,
                                    group=pages,
                                    logit_softcap=cfg.attn_logit_softcap,
                                    k_scale=kv.get("k_scale"),
                                    v_scale=kv.get("v_scale"))
    return _finish(block, cfg, x, o, decode=True, group=group, batch=batch)


def _prefill_attention_int8(cfg: ModelConfig, q: torch.Tensor,
                            k: torch.Tensor, v: torch.Tensor,
                            pos: torch.Tensor,
                            kv: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The chunk's attention over int8 pages, as the reference's dense
    prefill computes it: dequantize the rows' pages to f32, write the
    chunk's K/V at [pos, pos+C), run the flash prefill with q widened to
    f32 (the reference's bf16 x f32 einsum promotes q), cast the output
    back, and requantize the pages the chunk touched."""
    bsz, n_pages, page = kv["k"].shape[:3]
    c, smax = q.shape[1], n_pages * page
    flat = (bsz, smax, cfg.n_kv_heads, cfg.head_dim)
    start = pos.long().clamp(0, smax - c)
    span = min(n_pages, (c - 1) // page + 2)       # pages [start, start+C)
    pages = (start[:, None] // page + torch.arange(
        span, device=q.device)[None]).clamp(max=n_pages - 1)
    idx = (torch.arange(bsz, device=q.device)[:, None], pages)
    deq = {}
    for name, new in (("k", k), ("v", v)):
        x = kv_quant.dequantize_pages(kv[name], kv[name + "_scale"])
        attn.write_rows(x.view(flat), new, pos)
        deq[name] = x
    o = attn.chunk_prefill_attention(q.float(), deq["k"].view(flat),
                                     deq["v"].view(flat), pos,
                                     logit_softcap=cfg.attn_logit_softcap)
    for name in ("k", "v"):
        codes, scale = kv[name], kv[name + "_scale"]
        codes[idx], scale[idx] = kv_quant.requantize_pages(deq[name][idx],
                                                           scale[idx])
    return o.to(q.dtype)


def block_prefill_cached(block: Block | MoEBlock, cfg: ModelConfig,
                         x: torch.Tensor, positions: torch.Tensor,
                         pos: torch.Tensor,
                         kv: Dict[str, torch.Tensor], *,
                         stepwise: bool = False,
                         group=None, pages=None) -> torch.Tensor:
    """One block over a C-token chunk, writing its K/V into the pages.

    x: [B, C, d]; positions: [B, C]; pos: int32 [B] per-row start
    positions; kv: {"k","v"} each [B, n_pages, page, Hkv, D]. The chunk
    K/V are written in place at [pos, pos+C) before the attention, so the
    chunk attends to prior context + its own causal prefix.

    Int8 pages (``"k_scale"`` in kv) follow the reference: the dense
    prefill attends over the dequantized pages with the chunk at full
    precision and requantizes once; with ``stepwise`` (the hybrid, whose
    reference prefill is a scan of ``decode_step``) each token is a
    decode step that attends to the chunk's earlier tokens through their
    codes and requantizes its page.

    With a ``pages`` group (default: the rank ``group``) of more than one
    rank, ``kv`` holds this rank's pages: the slot's pages of every rank
    are gathered (the reference leaves the chunk's attention to XLA over
    the sharded cache, one softmax over every visible key), the chunk runs
    on the whole cache as on one rank (the weights' collectives over
    ``group``), and this rank keeps its own pages of the result.
    """
    pages = group if pages is None else pages
    if pages is not None and pages.size > 1:
        whole = sharding.gather_pages(pages, kv)
        out = _prefill_block(block, cfg, x, positions, pos, whole,
                             stepwise, group)
        n_pages = next(iter(whole.values())).shape[sharding.LAYER_PAGE_AXIS]
        lo, hi = sharding.page_range(n_pages, pages.rank, pages.size)
        for name, t in kv.items():
            t.copy_(whole[name][:, lo:hi])
        return out
    return _prefill_block(block, cfg, x, positions, pos, kv, stepwise, None)


def _prefill_block(block: Block | MoEBlock, cfg: ModelConfig,
                   x: torch.Tensor, positions: torch.Tensor,
                   pos: torch.Tensor, kv: Dict[str, torch.Tensor],
                   stepwise: bool, group) -> torch.Tensor:
    """``block_prefill_cached`` over whole pages ``kv``; ``group`` only
    for the weights' collectives."""
    h = rmsnorm(block.ln_attn, x, cfg.norm_eps)
    q, k, v = attn.qkv_project(block.attn, cfg, h, positions, group=group)
    if "k_scale" in kv and stepwise:
        o = torch.cat([attn.paged_decode_attention(
            q[:, i:i + 1].contiguous(), kv["k"], kv["v"],
            k[:, i:i + 1].contiguous(), v[:, i:i + 1].contiguous(),
            (pos + i).to(torch.int32), logit_softcap=cfg.attn_logit_softcap,
            k_scale=kv["k_scale"], v_scale=kv["v_scale"])
            for i in range(q.shape[1])], dim=1)
        return _finish(block, cfg, x, o, group=group)
    if "k_scale" in kv:
        return _finish(block, cfg, x,
                       _prefill_attention_int8(cfg, q, k, v, pos, kv),
                       group=group)
    bsz, n_pages, page = kv["k"].shape[:3]
    flat = (bsz, n_pages * page, cfg.n_kv_heads, cfg.head_dim)
    kf, vf = kv["k"].view(flat), kv["v"].view(flat)
    attn.write_rows(kf, k, pos)
    attn.write_rows(vf, v, pos)
    o = attn.chunk_prefill_attention(q, kf, vf, pos,
                                     logit_softcap=cfg.attn_logit_softcap)
    return _finish(block, cfg, x, o, group=group)
