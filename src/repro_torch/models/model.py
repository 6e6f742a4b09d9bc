"""Model assembly for the dense, MoE, audio and hybrid families: init,
paged cache, decode and chunked prefill steps, on-device sampling.

The reference streams a stacked layer axis through its speculative-read
scan; here the layers are a plain loop over ``DenseModel.blocks`` or
``HybridModel.groups`` (the reference's serving engine drops the prefetch
for a single device too). The MoE family (granite) is a ``DenseModel`` of
``MoEBlock``s; the audio family (musicgen) a ``DenseModel`` of dense
blocks over K codebook tables: its tokens are [B, K, S], their K rows
summed, sinusoidal positions added at each row's own positions, and its
logits [B, K, S, V]. All three share the dense cache layout and the
chunked prefill, one parallel chunk forward per layer. Caches keep the
reference's layout -- dense
``{"kv": {"k","v"}: [L, B, P, page, Hkv, D], "pos": [B]}``, with int8
``k``/``v`` codes and f32 ``k_scale``/``v_scale`` [L, B, P, Hkv] under
``kv_quant="int8"``; hybrid adds the f32 Mamba2 states ``"h"`` [g, period,
B, nh, P, N] and ``"conv"`` [g, period, B, W-1, C], with one shared-block
K/V cache per group -- and are updated **in place**: the steps return the
same cache dict they were given, where the reference returns new arrays
(its engine donates them).

The hybrid prefill chunk differs from the reference in form, not in
function: the reference scans ``decode_step`` over the chunk's tokens;
here the Mamba2 layers run the chunked SSD kernel from the carried state
and the shared block the chunked flash prefill, which computes the same
logits and caches (``tests/test_torch_hybrid.py``). With int8 pages the
two forms differ (each decode step attends to the chunk's earlier tokens
through their codes), so the shared block then runs the chunk token by
token through the int8 decode, as the reference does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.device import resolve_device
from repro_torch.models import kv_quant, mamba2, transformer
from repro_torch.models.layers import (Embed, RMSNorm, embed_apply,
                                       embed_init, frozen_param, pdtype,
                                       rmsnorm, sinusoidal_positions,
                                       unembed_apply)

PORTED_FAMILIES = ("dense", "moe", "audio", "hybrid")


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


def n_groups(cfg: ModelConfig) -> int:
    """Hybrid: the number of Mamba2 groups (= shared-block calls)."""
    return cfg.n_layers // cfg.shared_block_period


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
    states. With ``rc.kv_quant == "int8"`` the ``k``/``v`` leaves are int8
    codes and gain f32 ``k_scale``/``v_scale`` leaves [L,B,P,Hkv] filled
    with ``kv_quant.INIT_SCALE``."""
    check_family(cfg)
    quant = kv_quant.validate_mode(rc.kv_quant) == "int8"
    dev = resolve_device(device)
    page = min(rc.kv_page_size, max_seq)
    n_pages = max(max_seq // page, 1)
    hybrid = cfg.family == "hybrid"
    n_kv = n_groups(cfg) if hybrid else cfg.n_layers
    shape = (n_kv, batch, n_pages, page, cfg.n_kv_heads, cfg.head_dim)
    kv_dt = torch.int8 if quant else pdtype(cfg)
    kv = {"k": torch.zeros(shape, dtype=kv_dt, device=dev),
          "v": torch.zeros(shape, dtype=kv_dt, device=dev)}
    if quant:
        for name in ("k_scale", "v_scale"):
            kv[name] = torch.full(shape[:3] + shape[4:5],
                                  kv_quant.INIT_SCALE, dtype=torch.float32,
                                  device=dev)
    cache = {"kv": kv,
             "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if hybrid:
        lead = (n_groups(cfg), cfg.shared_block_period)
        for name, a in mamba2.mamba_state_init(cfg, batch,
                                               device=dev).items():
            cache[name] = a.expand(lead + a.shape).contiguous()
    return cache


# batch axis of each cache leaf ("kv" leaves: 1)
_BATCH_AXIS = {"pos": 0, "h": 2, "conv": 2}


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


def _shared_in(sp: SharedBlock, x: torch.Tensor,
               emb: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, emb], dim=-1) @ sp.in_map


def _embed(params: nn.Module, cfg: ModelConfig, tokens: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    """The token embedding, plus the sinusoidal positions (positions
    [B, S]) for a model without rope (musicgen)."""
    x = embed_apply(params.embed, cfg, tokens)
    if cfg.family == "audio" or not cfg.use_rope:
        x = x + sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
    return x


# ---------------------------------------------------------------------------
# decode / prefill
# ---------------------------------------------------------------------------


@torch.no_grad()
def decode_step(params: nn.Module, cfg: ModelConfig, rc: RunConfig,
                tokens: torch.Tensor, cache: Dict
                ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode for every row. tokens: [B, 1] -> logits [B, 1, V]
    (audio: [B, K, 1] -> [B, K, 1, V]).

    Writes each row's new K/V at its ``cache["pos"]`` and advances every
    row's position by one, in place."""
    check_family(cfg)
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
    else:
        for i, block in enumerate(params.blocks):
            x = transformer.block_decode_paged(block, cfg, x, pos,
                                               _layer_kv(cache, i))
    x = rmsnorm(params.ln_f, x, cfg.norm_eps)
    logits = unembed_apply(params.embed, cfg, x)
    cache["pos"] += 1
    return logits, cache


@torch.no_grad()
def prefill_step_cached(params: nn.Module, cfg: ModelConfig,
                        rc: RunConfig, tokens: torch.Tensor, cache: Dict, *,
                        last_only: bool = False
                        ) -> Tuple[torch.Tensor, Dict]:
    """Chunked multi-token prefill that writes the paged KV cache in place.

    tokens: [B, C] int (audio: [B, K, C]). Every row ingests its C tokens
    starting at its own ``cache["pos"]``; returns (logits [B, C, V] — or
    only the last position's, [B, 1, V], with ``last_only``; audio [B, K,
    C or 1, V] — and the cache with pos advanced by C).
    """
    check_family(cfg)
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
    else:
        for i, block in enumerate(params.blocks):
            x = transformer.block_prefill_cached(block, cfg, x, positions,
                                                 pos, _layer_kv(cache, i))
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
