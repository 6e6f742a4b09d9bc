"""Config system: model architecture, input shapes, mesh, and run configs.

Every assigned architecture is a `ModelConfig` in src/repro_torch/configs/<id>.py.
Input shapes are the four assigned (shape-set × arch) cells; `decode_*` /
`long_*` lower `serve_step` (single-token step against a KV cache), the
others lower `train_step`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model architecture
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (superset over all assigned families)."""

    arch_id: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # attention details
    qk_norm: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True  # musicgen uses additive sinusoidal instead
    attn_logit_softcap: float = 0.0

    # MLP details
    activation: str = "swiglu"  # swiglu | geglu | gelu (plain 2-matrix MLP)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # hybrid / SSM (zamba2-style mamba2 + shared attention block)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    shared_block_period: int = 0  # >0: shared attn block every N mamba layers

    # xLSTM
    slstm_every: int = 0  # >0: sLSTM block every N layers (rest mLSTM)
    mlstm_expand: int = 2

    # VLM (cross-attention image layers; modality frontend is a stub)
    cross_attn_period: int = 0  # >0: every Nth layer is a cross-attn layer
    n_vision_tokens: int = 0

    # audio (decoder over EnCodec tokens)
    n_codebooks: int = 0

    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # ---------------------------------------------------------- properties
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing => long_500k is runnable."""
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS)."""
        d, L = self.d_model, self.n_layers
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "audio":
            embed = self.n_codebooks * self.vocab_size * d * 2
        per_layer = 0
        # attention (dense / moe / vlm / audio); hybrid & ssm handled below
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        n_glu = 3 if self.activation in ("swiglu", "geglu") else 2
        if self.family == "moe":
            mlp = self.n_experts * n_glu * d * self.d_ff
            per_layer = attn + mlp + d * self.n_experts  # + router
        elif self.family in ("dense", "vlm", "audio"):
            mlp = n_glu * d * self.d_ff
            per_layer = attn + mlp
        elif self.family == "hybrid":
            d_in = self.ssm_expand * d
            nh = d_in // self.ssm_head_dim
            mamba = (d * (2 * d_in + 2 * self.ssm_state * 0 + nh)  # zx + dt
                     + d * 2 * (self.ssm_state + 0)                 # B,C proj
                     + d_in * d)                                    # out proj
            per_layer = mamba
        elif self.family == "ssm":
            # mLSTM block: up 2*(d->2d), qkv within, down 2d->d (approx)
            per_layer = 2 * d * (self.mlstm_expand * d) * 2
        total = embed + L * per_layer
        if self.family == "hybrid" and self.shared_block_period:
            total += (2 * d * d + attn + n_glu * d * self.d_ff + d * d)
        if self.family == "vlm" and self.cross_attn_period:
            n_cross = L // self.cross_attn_period
            total += n_cross * (attn + n_glu * d * self.d_ff)
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.n_params()
        d, L = self.d_model, self.n_layers
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        mlp = self.top_k * 3 * d * self.d_ff
        return embed + L * (attn + mlp + d * self.n_experts)


# ---------------------------------------------------------------------------
# Input shapes (assigned shape set)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch x shape) cell is runnable; else reason for the skip."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: O(L^2) attention at 524288 "
                       "is degenerate; skipped per assignment (sub-quadratic "
                       "mixing required). See DESIGN.md §7.")
    return True, ""


# ---------------------------------------------------------------------------
# Mesh / run configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False

    @property
    def shape(self):
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def axes(self):
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Everything the launcher needs besides the architecture itself."""

    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = MeshConfig()

    # --- the paper's technique ------------------------------------------
    # parameter/optimizer tier policy: "device" (replicate over data axis),
    # "pool" (FSDP over data axis = CXL DRAM-EP analogue), "host"
    # (pinned_host = SSD-EP analogue; TPU only)
    param_tier: str = "pool"
    optimizer_tier: str = "pool"
    enable_host_tier: bool = False  # CPU backend cannot compile pinned_host
    # speculative read: 0 = off (plain CXL config), 1 = double buffer,
    # 2 = triple buffer
    sr_prefetch_depth: int = 1
    sr_granularity: int = 1  # sub-gathers per layer (1 = whole layer)
    # deterministic store: grads leave backward as reduce-scatter shards
    ds_enabled: bool = True
    staging_ring_slots: int = 8

    # --- training -------------------------------------------------------
    microbatches: int = 1  # gradient accumulation steps
    remat: bool = True
    remat_policy: str = "none"  # none (nothing saveable) | dots
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    grad_compression: str = "none"  # none | int8_ef (cross-pod reductions)
    seed: int = 0

    # --- serving --------------------------------------------------------
    kv_page_size: int = 256
    decode_microbatch: int = 0  # 0 = whole batch
    kv_quant: str = "none"      # none | int8 (per-page scales; fp8 reserved)
                                # — see models/kv_quant.py

    # --- hillclimb knobs --------------------------------------------------
    seq_shard_attn: bool = False   # shard long-context KV over data axis
    fuse_qkv: bool = True          # single fused QKV projection matmul
    scan_unroll: int = 0           # 0 = auto; >0 forces layer-scan unroll
                                   # (cost extraction sets it = n_stacked)
    use_pallas: bool = False       # route attention through the Pallas
                                   # kernels (TPU fast path; interpret on
                                   # CPU — see kernels/)
