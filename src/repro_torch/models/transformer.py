"""Dense transformer blocks: paged decode and chunked prefill steps.

A block is an ``nn.Module`` of one layer's weights; the model holds one per
layer (the reference stacks them on a leading axis for its layer scan).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
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


def block_init(gen: torch.Generator, cfg: ModelConfig, device) -> Block:
    """Draw one layer's weights from ``gen``."""
    dt = pdtype(cfg)
    return Block(RMSNorm.ones(cfg.d_model, dt, device),
                 attn.attn_init(gen, cfg, device),
                 RMSNorm.ones(cfg.d_model, dt, device),
                 mlp_init(gen, cfg, device))


def _finish(block: Block, cfg: ModelConfig, x: torch.Tensor,
            o: torch.Tensor) -> torch.Tensor:
    """Attention output projection + residual, then the MLP half."""
    b, s = x.shape[0], x.shape[1]
    x = x + o.reshape(b, s, cfg.q_dim) @ block.attn.wo
    h = rmsnorm(block.ln_mlp, x, cfg.norm_eps)
    return x + mlp_apply(block.mlp, cfg, h)


def block_decode_paged(block: Block, cfg: ModelConfig, x: torch.Tensor,
                       pos: torch.Tensor, kv: Dict[str, torch.Tensor], *,
                       n_ranks: int = 1) -> torch.Tensor:
    """Single-token decode against one layer's pages.

    x: [B, 1, d]; pos: int32 [B]; kv: {"k","v"} each [B, n_pages, page,
    Hkv, D], written in place. Returns the block output [B, 1, d].
    """
    h = rmsnorm(block.ln_attn, x, cfg.norm_eps)
    positions = pos.reshape(-1, 1).to(torch.int32)
    q, k, v = attn.qkv_project(block.attn, cfg, h, positions)
    o = attn.paged_decode_attention(q, kv["k"], kv["v"], k, v, pos,
                                    n_ranks=n_ranks,
                                    logit_softcap=cfg.attn_logit_softcap)
    return _finish(block, cfg, x, o)


def block_prefill_cached(block: Block, cfg: ModelConfig, x: torch.Tensor,
                         positions: torch.Tensor, pos: torch.Tensor,
                         kv: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One block over a C-token chunk, writing its K/V into the pages.

    x: [B, C, d]; positions: [B, C]; pos: int32 [B] per-row start
    positions; kv: {"k","v"} each [B, n_pages, page, Hkv, D]. The chunk
    K/V are written in place at [pos, pos+C) before the attention, so the
    chunk attends to prior context + its own causal prefix.
    """
    h = rmsnorm(block.ln_attn, x, cfg.norm_eps)
    q, k, v = attn.qkv_project(block.attn, cfg, h, positions)
    bsz, n_pages, page = kv["k"].shape[:3]
    flat = (bsz, n_pages * page, cfg.n_kv_heads, cfg.head_dim)
    kf, vf = kv["k"].view(flat), kv["v"].view(flat)
    attn.write_rows(kf, k, pos)
    attn.write_rows(vf, v, pos)
    o = attn.chunk_prefill_attention(q, kf, vf, pos,
                                     logit_softcap=cfg.attn_logit_softcap)
    return _finish(block, cfg, x, o)
