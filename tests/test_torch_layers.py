"""Port layers (``repro_torch.models.layers`` / ``attention.qkv_project``)
against the reference layers on the CPU, weights carried across through
``repro_torch.bridge``. Tolerances: f32 3e-5, bf16 2e-2
(``tests/test_kernel_parity.py``)."""
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import layers as jl
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return (dict(atol=2e-2, rtol=2e-2) if name == "bfloat16"
            else dict(atol=3e-5, rtol=3e-5))


def _pair(rng, shape, name, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    jdt, tdt = DTYPES[name]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs(arch, name):
    return (dataclasses.replace(jreg.smoke(arch), dtype=name),
            dataclasses.replace(treg.smoke(arch), dtype=name))


NAMES = ["float32", "bfloat16"]


@pytest.mark.parametrize("name", NAMES)
def test_rmsnorm_and_head_rmsnorm(name):
    rng = np.random.default_rng(0)
    x_j, x_t = _pair(rng, (2, 5, 64), name)
    s_j, s_t = _pair(rng, (64,), name)
    got = tl.rmsnorm(tl.RMSNorm(s_t), x_t, 1e-6)
    np.testing.assert_allclose(_np(got), _np(jl.rmsnorm({"scale": s_j}, x_j)),
                               **_tol(name))
    h_j, h_t = _pair(rng, (2, 5, 4, 16), name)
    hs_j, hs_t = _pair(rng, (16,), name)
    np.testing.assert_allclose(_np(tl.head_rmsnorm(hs_t, h_t)),
                               _np(jl.head_rmsnorm(hs_j, h_j)), **_tol(name))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_rotate_half(name, theta):
    rng = np.random.default_rng(1)
    x_j, x_t = _pair(rng, (2, 6, 3, 16), name)
    pos = rng.integers(0, 3000, (2, 6)).astype(np.int32)
    want = jl.apply_rope(x_j, jnp.asarray(pos), theta)
    got = tl.apply_rope(x_t, torch.from_numpy(pos), theta)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma-2b", "starcoder2-15b"])
def test_mlp_variants(name, arch):
    """swiglu (qwen3), geglu (gemma) and plain tanh-gelu (starcoder2)."""
    jcfg, tcfg = _cfgs(arch, name)
    params = jl.mlp_init(jax.random.PRNGKey(2), jcfg)
    np_p = {k: np.asarray(v) for k, v in params.items()}
    mlp = tl.MLP(bridge.to_tensor(np_p["w_up"], "cpu"),
                 bridge.to_tensor(np_p["w_down"], "cpu"),
                 bridge.to_tensor(np_p["w_gate"], "cpu")
                 if "w_gate" in np_p else None)
    rng = np.random.default_rng(3)
    x_j, x_t = _pair(rng, (2, 5, jcfg.d_model), name, scale=3.0)
    np.testing.assert_allclose(_np(tl.mlp_apply(mlp, tcfg, x_t)),
                               _np(jl.mlp_apply(params, jcfg, x_j)),
                               **_tol(name))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "glm4-9b"])
def test_embed_unembed_tied_and_untied(name, arch):
    jcfg, tcfg = _cfgs(arch, name)
    params = jl.embed_init(jax.random.PRNGKey(4), jcfg)
    emb = tl.Embed(bridge.to_tensor(np.asarray(params["embedding"]), "cpu"),
                   bridge.to_tensor(np.asarray(params["unembed"]), "cpu")
                   if "unembed" in params else None)
    assert (emb.unembed is None) == jcfg.tie_embeddings
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 7))
    x_j = jl.embed_apply(params, jcfg, jnp.asarray(toks, jnp.int32))
    x_t = tl.embed_apply(emb, tcfg, torch.from_numpy(toks))
    np.testing.assert_array_equal(_np(x_t), _np(x_j))
    np.testing.assert_allclose(_np(tl.unembed_apply(emb, tcfg, x_t)),
                               _np(jl.unembed_apply(params, jcfg, x_j)),
                               **_tol(name))


@pytest.mark.parametrize("name", NAMES)
def test_qkv_project_with_qk_norm_and_rope(name):
    jcfg, tcfg = _cfgs("qwen3-1.7b", name)
    assert jcfg.qk_norm
    params = jattn.attn_init(jax.random.PRNGKey(6), jcfg)
    params["q_norm"] = jnp.asarray(
        np.linspace(0.5, 1.5, jcfg.head_dim), params["q_norm"].dtype)
    np_p = {k: np.asarray(v) for k, v in params.items()}
    attn = tattn.Attention(*(bridge.to_tensor(np_p[k], "cpu") for k in
                             ("wq", "wk", "wv", "wo", "q_norm", "k_norm")))
    rng = np.random.default_rng(7)
    x_j, x_t = _pair(rng, (2, 5, jcfg.d_model), name)
    pos = rng.integers(0, 60, (2, 5)).astype(np.int32)
    want = jattn.qkv_project(params, jcfg, x_j, jnp.asarray(pos))
    got = tattn.qkv_project(attn, tcfg, x_t, torch.from_numpy(pos))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), **_tol(name))


def test_bf16_crosses_bit_exact_as_uint16():
    a = jnp.asarray(np.random.default_rng(8).standard_normal(64),
                    jnp.bfloat16)
    bits = np.asarray(a).view(np.uint16)
    t = bridge.to_tensor(np.asarray(a), "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                  bits)
    # np.save turns ml_dtypes bf16 into a two-byte void dtype
    buf = io.BytesIO()
    np.save(buf, np.asarray(a))
    buf.seek(0)
    void = np.load(buf)
    assert void.dtype.kind == "V" and void.dtype.itemsize == 2
    assert torch.equal(bridge.to_tensor(void, "cpu"), t)
    np.testing.assert_array_equal(bridge.to_numpy(t),
                                  np.asarray(a, np.float32))


def test_init_draws_from_a_seeded_generator():
    cfg = treg.smoke("qwen3-1.7b")
    gen = torch.Generator().manual_seed(0)
    mlp = tl.mlp_init(gen, cfg, "cpu")
    gen2 = torch.Generator().manual_seed(0)
    assert torch.equal(tl.mlp_init(gen2, cfg, "cpu").w_up, mlp.w_up)
    assert mlp.w_up.dtype == torch.bfloat16
    assert 0.015 < float(mlp.w_up.float().std()) < 0.025
