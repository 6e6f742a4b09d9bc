"""Architecture registry: --arch <id> -> ModelConfig, plus reduced smoke
configs (same family/topology, tiny dims) for CPU tests."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig

from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as _qwen3_moe
from repro_torch.configs.granite_moe_1b_a400m import CONFIG as _granite
from repro_torch.configs.zamba2_2_7b import CONFIG as _zamba2
from repro_torch.configs.qwen3_1_7b import CONFIG as _qwen3
from repro_torch.configs.gemma_2b import CONFIG as _gemma
from repro_torch.configs.starcoder2_15b import CONFIG as _starcoder2
from repro_torch.configs.glm4_9b import CONFIG as _glm4
from repro_torch.configs.xlstm_125m import CONFIG as _xlstm
from repro_torch.configs.llama_3_2_vision_11b import CONFIG as _llama_vis
from repro_torch.configs.musicgen_large import CONFIG as _musicgen

ARCHS: Dict[str, ModelConfig] = {c.arch_id: c for c in [
    _qwen3_moe, _granite, _zamba2, _qwen3, _gemma, _starcoder2, _glm4,
    _xlstm, _llama_vis, _musicgen]}


def get(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return ARCHS[arch_id]


def smoke(arch_id: str) -> ModelConfig:
    """Reduced config of the same family: few layers, small width, few
    experts, tiny vocab — runs a real forward/train step on CPU."""
    cfg = get(arch_id)
    updates = dict(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=max(
            1, min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4),
        head_dim=16, d_ff=128 if cfg.d_ff else 0, vocab_size=256,
    )
    if cfg.family == "moe":
        updates.update(n_experts=8, top_k=2, d_ff=64)
    if cfg.family == "hybrid":
        updates.update(shared_block_period=2, ssm_state=16, ssm_head_dim=16,
                       n_layers=4, n_heads=4, n_kv_heads=4, head_dim=16)
    if cfg.family == "ssm":
        updates.update(slstm_every=2, n_layers=4, n_heads=4, n_kv_heads=4,
                       head_dim=16, d_ff=0)
    if cfg.family == "vlm":
        updates.update(cross_attn_period=2, n_vision_tokens=8, n_layers=4)
    if cfg.family == "audio":
        updates.update(n_codebooks=2, vocab_size=64)
    # MQA archs keep their kv=1 topology
    if cfg.n_kv_heads == 1:
        updates["n_kv_heads"] = 1
    return dataclasses.replace(cfg, **updates)
