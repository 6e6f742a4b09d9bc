"""Transformer blocks: paged decode and chunked prefill steps.

A block is an ``nn.Module`` of one layer's weights; the model holds one per
layer (the reference stacks them on a leading axis for its layer scan).
The dense ``Block`` and the ``MoEBlock`` share the attention half; each
brings its own feed-forward half (``ffn``): the MLP, or the routed experts.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import kv_quant, moe
from repro_torch.models.layers import (MLP, RMSNorm, mlp_apply, mlp_init,
                                       pdtype, rmsnorm)


class Block(nn.Module):
    """One layer: ``ln_attn``, ``attn``, ``ln_mlp``, ``mlp``."""

    def __init__(self, ln_attn: RMSNorm, attention: attn.Attention,
                 ln_mlp: RMSNorm, mlp: MLP):
        super().__init__()
        self.ln_attn = ln_attn
        self.attn = attention
        self.ln_mlp = ln_mlp
        self.mlp = mlp

    def ffn(self, cfg: ModelConfig, h: torch.Tensor, *,
            decode: bool) -> torch.Tensor:
        """The feed-forward half on the normed ``h``: the MLP."""
        return mlp_apply(self.mlp, cfg, h)


class MoEBlock(nn.Module):
    """One MoE layer: ``ln_attn``, ``attn``, ``ln_mlp``, ``moe``."""

    def __init__(self, ln_attn: RMSNorm, attention: attn.Attention,
                 ln_mlp: RMSNorm, experts: moe.MoE):
        super().__init__()
        self.ln_attn = ln_attn
        self.attn = attention
        self.ln_mlp = ln_mlp
        self.moe = experts

    def ffn(self, cfg: ModelConfig, h: torch.Tensor, *,
            decode: bool) -> torch.Tensor:
        """The feed-forward half on the normed ``h``: the routed experts,
        ``moe_apply_ep_decode`` on a decode tick, else ``moe_apply_ep``
        (both ``moe_apply`` on one rank, drops included)."""
        if decode:
            return moe.moe_apply_ep_decode(self.moe, cfg, h)
        return moe.moe_apply_ep(self.moe, cfg, h)[0]


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


def _finish(block: Block | MoEBlock, cfg: ModelConfig, x: torch.Tensor,
            o: torch.Tensor, *, decode: bool = False) -> torch.Tensor:
    """Attention output projection + residual, then the block's
    feed-forward half (``block.ffn``) + residual."""
    b, s = x.shape[0], x.shape[1]
    x = x + o.reshape(b, s, cfg.q_dim) @ block.attn.wo
    h = rmsnorm(block.ln_mlp, x, cfg.norm_eps)
    return x + block.ffn(cfg, h, decode=decode)


def block_decode_paged(block: Block | MoEBlock, cfg: ModelConfig,
                       x: torch.Tensor, pos: torch.Tensor,
                       kv: Dict[str, torch.Tensor], *,
                       n_ranks: int = 1) -> torch.Tensor:
    """Single-token decode against one layer's pages.

    x: [B, 1, d]; pos: int32 [B]; kv: {"k","v"} each [B, n_pages, page,
    Hkv, D] (int8 pages add f32 "k_scale"/"v_scale" [B, n_pages, Hkv]),
    written in place. Returns the block output [B, 1, d].
    """
    h = rmsnorm(block.ln_attn, x, cfg.norm_eps)
    positions = pos.reshape(-1, 1).to(torch.int32)
    q, k, v = attn.qkv_project(block.attn, cfg, h, positions)
    o = attn.paged_decode_attention(q, kv["k"], kv["v"], k, v, pos,
                                    n_ranks=n_ranks,
                                    logit_softcap=cfg.attn_logit_softcap,
                                    k_scale=kv.get("k_scale"),
                                    v_scale=kv.get("v_scale"))
    return _finish(block, cfg, x, o, decode=True)


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
                         stepwise: bool = False) -> torch.Tensor:
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
    """
    h = rmsnorm(block.ln_attn, x, cfg.norm_eps)
    q, k, v = attn.qkv_project(block.attn, cfg, h, positions)
    if "k_scale" in kv and stepwise:
        o = torch.cat([attn.paged_decode_attention(
            q[:, i:i + 1].contiguous(), kv["k"], kv["v"],
            k[:, i:i + 1].contiguous(), v[:, i:i + 1].contiguous(),
            (pos + i).to(torch.int32), logit_softcap=cfg.attn_logit_softcap,
            k_scale=kv["k_scale"], v_scale=kv["v_scale"])
            for i in range(q.shape[1])], dim=1)
        return _finish(block, cfg, x, o)
    if "k_scale" in kv:
        return _finish(block, cfg, x,
                       _prefill_attention_int8(cfg, q, k, v, pos, kv))
    bsz, n_pages, page = kv["k"].shape[:3]
    flat = (bsz, n_pages * page, cfg.n_kv_heads, cfg.head_dim)
    kf, vf = kv["k"].view(flat), kv["v"].view(flat)
    attn.write_rows(kf, k, pos)
    attn.write_rows(vf, v, pos)
    o = attn.chunk_prefill_attention(q, kf, vf, pos,
                                     logit_softcap=cfg.attn_logit_softcap)
    return _finish(block, cfg, x, o)
