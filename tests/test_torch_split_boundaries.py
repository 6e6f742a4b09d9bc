"""The leaves whose split over two ranks falls inside a segment, each
layer at tp 2 held to its unsplit form, on the CPU in f32 (3e-5).

Two spawned gloo ranks (``launch.mesh.spawn``) each cut their shard from
the same whole weights (``parallel.sharding.shard_params``) and run the
layer on the same inputs and states (nonzero, from a seed) as the whole
layer does on one rank:

 * zamba2's Mamba2 layer, decode step and prefill chunk: ``in_proj``
   ([z | x], split at z's end: rank 0 holds z, rank 1 x) and ``conv_w``
   ([x | B | C], split inside x), the heads' scan and the gated
   ``ln_out`` over a rank's heads, ``out_proj`` row-parallel; at smoke
   size (8 heads: ``A_log`` / ``D`` / ``dt_bias`` whole) and at 16 heads
   (those split too, as zamba2's 80 at full width);
 * the gated RMSNorm over split channels (``sharding.split_rmsnorm``)
   against the whole RMSNorm;
 * xLSTM's mLSTM step (``w_qkv`` split inside k, ``w_up1`` / ``w_up2`` /
   ``conv_w`` split, ``w_gates`` whole, ``w_down2`` row-parallel) and
   sLSTM step (``w_gates`` split, ``r_gates`` whole, ``w_out`` and the
   FFN's down product row-parallel), over one token and five;
 * xLSTM's tied table, split on its rows: the embedding summed across
   the ranks, the logits gathered on the vocabulary;
 * the VLM's cross layer (gates away from 0, random vision K/V) and
   ``vision_kv``.

Every rank's result, and every state it returns, must be the whole
layer's; the states must also be equal on both ranks.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.launch import mesh
from repro_torch.models import mamba2, transformer, xlstm
from repro_torch.models import model as TM
from repro_torch.models.layers import embed_apply, rmsnorm, unembed_apply
from repro_torch.parallel import sharding

TP = 2
TOL = dict(atol=3e-5, rtol=3e-5)
B = 2
SPAWN_TIMEOUT_S = 240.0


def _cfg(arch, **over):
    return dataclasses.replace(treg.smoke(arch), dtype="float32", **over)


# name -> the config its whole model is drawn at
CONFIGS = {"zamba2": _cfg("zamba2-2.7b"),
           "zamba2_16_heads": _cfg("zamba2-2.7b", ssm_head_dim=8),
           "xlstm": _cfg("xlstm-125m"),
           "vlm": _cfg("llama-3.2-vision-11b")}


def _randn(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _models():
    out = {}
    for i, (name, cfg) in enumerate(CONFIGS.items()):
        model = TM.init_model(cfg, seed=3 + i, device="cpu")
        if name == "vlm":
            for cross in model.cross:
                cross.attn_gate.fill_(0.7)
                cross.mlp_gate.fill_(-0.4)
        out[name] = model
    return out


def _mamba_inputs(cfg, s):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    return (_randn(1, B, s, cfg.d_model),
            {"h": _randn(2, B, nh, cfg.ssm_head_dim, cfg.ssm_state) * 0.1,
             "conv": _randn(3, B, cfg.ssm_conv - 1,
                            d_in + 2 * cfg.ssm_state)})


def _xlstm_inputs(cfg, s):
    d, nh = cfg.d_model, cfg.n_heads
    d_in = cfg.mlstm_expand * d
    dh_m, dh_s = d_in // nh, d // nh
    m = {"C": _randn(4, B, nh, dh_m, dh_m) * 0.1,
         "n": _randn(5, B, nh, dh_m) * 0.1, "m": _randn(6, B, nh),
         "conv": _randn(7, B, xlstm.CONV - 1, d_in)}
    sl = {"h": _randn(8, B, nh, dh_s) * 0.1, "c": _randn(9, B, nh, dh_s),
          "n": _randn(10, B, nh, dh_s).abs() + 1.0,
          "m": _randn(11, B, nh, dh_s),
          "conv": _randn(12, B, xlstm.CONV - 1, d)}
    return _randn(13, B, s, d), m, sl


def _cases(models, group):
    """Every case's outputs (numpy), on this rank's shard (``group``) or,
    with ``group`` None, on the whole weights."""
    def clone(state):
        return {k: v.clone() for k, v in state.items()}

    def np_out(y, state=None):
        out = {"y": bridge.to_numpy(y)}
        for k, v in (state or {}).items():
            out[k] = bridge.to_numpy(v)
        return out

    def params(name):
        if group is None:
            return models[name]
        return sharding.shard_params(models[name], group.rank, group.size)

    out = {}
    for name in ("zamba2", "zamba2_16_heads"):
        cfg, model = CONFIGS[name], params(name)
        layer = model.groups[0][1]
        for step, s in (("step", 1), ("chunk", 8)):
            u, state = _mamba_inputs(cfg, s)
            fn = (mamba2.mamba_step if step == "step"
                  else mamba2.mamba_prefill_chunk)
            y, new = fn(layer, cfg, u, clone(state), group)
            out[f"{name}_{step}"] = np_out(y, new)
        if name == "zamba2_16_heads":
            out["zamba2_shard"] = {"in_proj": bridge.to_numpy(layer.in_proj),
                                   "A_log": bridge.to_numpy(layer.A_log)}
        # the gated norm over a rank's channels of ln_out's width
        width = layer.ln_out.scale.shape[0]
        x = _randn(14, B, 3, width)
        lo, n = (0, width) if group is None else (
            group.rank * width // group.size, width // group.size)
        out[f"{name}_gated_norm"] = {"y": bridge.to_numpy(
            sharding.split_rmsnorm(group, layer.ln_out.scale,
                                   x[..., lo:lo + n], width, cfg.norm_eps))}
    cfg, model = CONFIGS["xlstm"], params("xlstm")
    for s in (1, 5):
        x, m_state, s_state = _xlstm_inputs(cfg, s)
        y, new = xlstm.mlstm_step(model.mlstm[0][0], cfg, x, clone(m_state),
                                  group)
        out[f"mlstm_{s}"] = np_out(y, new)
        y, new = xlstm.slstm_step(model.slstm[0], cfg, x, clone(s_state),
                                  group)
        out[f"slstm_{s}"] = np_out(y, new)
    toks = torch.from_numpy(np.random.default_rng(15).integers(
        0, cfg.vocab_size, (B, 7)))
    out["tied_embed"] = np_out(embed_apply(model.embed, cfg, toks, group))
    out["tied_unembed"] = np_out(unembed_apply(model.embed, cfg,
                                               _randn(16, B, 7, cfg.d_model),
                                               group))
    cfg, model = CONFIGS["vlm"], params("vlm")
    emb = _randn(17, B, cfg.n_vision_tokens, cfg.d_model)
    k, v = transformer.vision_kv(model.cross[0], cfg, emb, group)
    out["vision_kv"] = {"k": bridge.to_numpy(k), "v": bridge.to_numpy(v)}
    for s in (1, 5):
        out[f"cross_{s}"] = np_out(transformer.cross_block_apply(
            model.cross[0], cfg, _randn(18, B, s, cfg.d_model), k, v,
            group=group))
    return out


def _rank(group, models):
    return _cases(models, group)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    models = _models()
    whole = _cases(models, None)
    ranks = mesh.spawn(_rank, TP, (models,),
                       rendezvous_dir=str(tmp_path_factory.mktemp("rdv")),
                       device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    return whole, ranks, models


CASES = ["zamba2_step", "zamba2_chunk", "zamba2_16_heads_step",
         "zamba2_16_heads_chunk", "zamba2_gated_norm",
         "zamba2_16_heads_gated_norm", "mlstm_1", "mlstm_5", "slstm_1",
         "slstm_5", "tied_embed", "tied_unembed", "vision_kv", "cross_1",
         "cross_5"]


@pytest.mark.parametrize("case", CASES)
def test_split_layer_matches_whole(results, case):
    """Each rank's output and states against the whole layer's (f32,
    3e-5); a gated norm compares each rank's channels with its slice of
    the whole norm's."""
    whole, ranks, _ = results
    for r, run in enumerate(ranks):
        for key, want in whole[case].items():
            got = run[case][key]
            if case.endswith("gated_norm"):
                n = want.shape[-1] // TP
                want = want[..., r * n:(r + 1) * n]
            np.testing.assert_allclose(got, want, **TOL,
                                       err_msg=f"{case} {key} rank {r}")


@pytest.mark.parametrize("case", [c for c in CASES
                                  if not c.endswith("gated_norm")])
def test_split_layer_ranks_agree(results, case):
    """Both ranks return the same output and the same whole states."""
    _, ranks, _ = results
    for key, want in ranks[0][case].items():
        np.testing.assert_array_equal(ranks[1][case][key], want)


def test_split_boundaries_fall_inside_segments(results):
    """The splits these gates exist for: in_proj at z's end (rank 0 all
    of z, rank 1 all of x), conv_w inside x, w_qkv inside k; at 16 heads
    the per-head leaves split with out_proj's rows, 8 heads a rank."""
    _, ranks, models = results
    cfg = CONFIGS["zamba2_16_heads"]
    layer = models["zamba2_16_heads"].groups[0][1]
    d_in = cfg.ssm_expand * cfg.d_model
    for r, run in enumerate(ranks):
        shard = run["zamba2_shard"]
        z_or_x = layer.in_proj[:, r * d_in:(r + 1) * d_in]
        np.testing.assert_array_equal(shard["in_proj"], z_or_x.numpy())
        np.testing.assert_array_equal(shard["A_log"],
                                      layer.A_log[r * 8:(r + 1) * 8].numpy())
    conv_cols = layer.conv_w.shape[1]
    assert 0 < conv_cols // TP < d_in
    xcfg = CONFIGS["xlstm"]
    x_in = xcfg.mlstm_expand * xcfg.d_model
    assert x_in < models["xlstm"].mlstm[0][0].w_qkv.shape[1] // TP < 2 * x_in
