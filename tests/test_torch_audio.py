"""Port audio family (musicgen-large) vs the reference on the CPU, at
smoke size.

musicgen is a decoder over K EnCodec codebooks: its tokens are [B, K, S],
codebook k's ids offset by ``k · vocab`` into one stacked table and the K
rows summed; sinusoidal positions are added at each row's own positions
(no rope); its untied unembed gives logits [B, K, S, V]. The serving
engine samples codebook 0's last row and feeds that one token to every
codebook.

- ``embed_apply``, ``unembed_apply`` and ``sinusoidal_positions`` against
  the reference's;
- smoke-musicgen prefill and decode logits [B, K, S, V] and caches against
  the reference's steps, f32 (3e-5) and bf16 (2e-2);
- the serving engine against the JAX engine on the traffic of
  ``tests/test_torch_serving.py`` (bf16 pages, resubmits served by prefix
  restore): equal greedy tokens, stats, tier snapshot, op trace and op_ns
  and stored entries, pages within the bf16 tolerance.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import MeshConfig, RunConfig, SHAPES
from repro.models import layers as JL
from repro.models import model as JM
from repro.parallel import sharding as shlib
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MeshConfig as TMeshConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

ARCH = "musicgen-large"
NAMES = ["float32", "bfloat16"]
F32_TOL = dict(atol=3e-5, rtol=3e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _tol(name):
    return BF16_TOL if name == "bfloat16" else F32_TOL


def _np(x):
    if isinstance(x, torch.Tensor):
        return bridge.to_numpy(x)
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs(name):
    return (dataclasses.replace(jreg.smoke(ARCH), dtype=name),
            dataclasses.replace(treg.smoke(ARCH), dtype=name))


def test_smoke_musicgen_keeps_its_shape():
    """The smoke config keeps what makes musicgen its own path: several
    codebooks, no rope, a plain gelu MLP and an untied unembed."""
    cfg = treg.smoke(ARCH)
    assert cfg.family == "audio" and cfg.n_codebooks > 1
    assert (cfg.use_rope, cfg.activation, cfg.tie_embeddings) == (
        False, "gelu", False)
    full = treg.get(ARCH)
    assert (full.head_dim, full.n_kv_heads, full.n_layers,
            full.n_codebooks) == (64, 32, 48, 4)


# ----------------------------------------------------------------- layers

@pytest.mark.parametrize("name", NAMES)
def test_embed_unembed_match_reference(name):
    jcfg, tcfg = _cfgs(name)
    tree = jax.tree_util.tree_map(
        np.asarray, JL.embed_init(jax.random.PRNGKey(3), jcfg))
    assert tree["embedding"].shape == (jcfg.n_codebooks * jcfg.vocab_size,
                                       jcfg.d_model)
    embed = TL.Embed(bridge.to_tensor(tree["embedding"], "cpu"),
                     bridge.to_tensor(tree["unembed"], "cpu"))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size,
                        (2, jcfg.n_codebooks, 5)).astype(np.int32)
    want = JL.embed_apply(tree, jcfg, jnp.asarray(toks))
    got = TL.embed_apply(embed, tcfg, torch.from_numpy(toks))
    assert tuple(got.shape) == (2, 5, jcfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jcfg.dtype)
    want = JL.unembed_apply(tree, jcfg, jx)
    got = TL.unembed_apply(embed, tcfg, bridge.to_tensor(np.asarray(jx),
                                                         "cpu"))
    assert tuple(got.shape) == (2, jcfg.n_codebooks, 5, jcfg.vocab_size)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))


@pytest.mark.parametrize("d_model", [64, 2048])
def test_sinusoidal_positions_match_reference(d_model):
    """Positions up to a 2048-token slot, at smoke and full width. XLA's
    and torch's f32 ``exp`` give frequencies that differ by up to an ulp
    (2^-23 relative), which a position p turns into an angle error of
    p · 2^-23; so each row is held to 2 · p · 2^-23 + 1e-6 absolute."""
    pos = np.array([[0, 1, 7, 300], [511, 1023, 1500, 2047]], np.int32)
    want = np.asarray(JL.sinusoidal_positions(jnp.asarray(pos), d_model))
    got = TL.sinusoidal_positions(torch.from_numpy(pos), d_model)
    assert got.dtype == torch.float32 and got.shape == want.shape
    bound = 2.0 * pos[..., None] * 2.0 ** -23 + 1e-6
    assert (np.abs(got.numpy() - want) <= bound).all()


# ------------------------------------------------------------------ model

PAGE, MAX_SEQ, B, PROMPT = 8, 32, 2, 7


@pytest.fixture(scope="module")
def models(host_mesh):
    out = {}
    with jax.set_mesh(host_mesh):
        for name in NAMES:
            jcfg, tcfg = _cfgs(name)
            rc = RunConfig(model=jcfg, shape=SHAPES["decode_32k"],
                           mesh=MeshConfig(), kv_page_size=PAGE)
            trc = TRunConfig(model=tcfg, shape=TSHAPES["decode_32k"],
                             mesh=TMeshConfig(), kv_page_size=PAGE)
            params = JM.init_model(jax.random.PRNGKey(0), jcfg)
            pspecs = shlib.param_specs(jax.eval_shape(lambda: params),
                                       tier=rc.param_tier,
                                       multi_pod_fsdp=False)
            tparams = bridge.params_from_jax(
                jax.tree_util.tree_map(np.asarray, params), tcfg,
                device="cpu")
            steps = {
                "prefill": jax.jit(functools.partial(
                    JM.prefill_step_cached, cfg=jcfg, rc=rc,
                    param_specs=pspecs)),
                "decode": jax.jit(functools.partial(
                    JM.decode_step, cfg=jcfg, rc=rc, param_specs=pspecs))}
            out[name] = (jcfg, rc, params, steps, tcfg, trc, tparams)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_model_logits_match(models, host_mesh, name):
    """Chunked prefill of [B, K, 7] tokens (chunks of 3, the last ragged),
    then decode steps of [B, K, 1] with row 1 five positions on; logits
    [B, K, S, V], and codebook 0's last row is what the engine samples."""
    jcfg, rc, params, steps, tcfg, trc, tparams = models[name]
    k = jcfg.n_codebooks
    rng = np.random.default_rng(9)
    toks = rng.integers(1, jcfg.vocab_size, (B, k, PROMPT)).astype(np.int32)
    jc = JM.cache_init(jcfg, rc, B, max_seq=MAX_SEQ)
    tc = TM.cache_init(tcfg, trc, B, MAX_SEQ, device="cpu")
    with jax.set_mesh(host_mesh):
        for s in range(0, PROMPT, 3):
            part = toks[..., s:s + 3]
            jl, jc = steps["prefill"](params, tokens=jnp.asarray(part),
                                      cache=jc)
            tl, tc = TM.prefill_step_cached(tparams, tcfg, trc,
                                            torch.from_numpy(part), tc)
            assert tuple(tl.shape) == (B, k, part.shape[-1],
                                       jcfg.vocab_size)
            np.testing.assert_allclose(_np(tl), _np(jl), **_tol(name))
        np.testing.assert_allclose(_np(TM.last_token_logits(tl)),
                                   _np(JM.last_token_logits(jl)),
                                   **_tol(name))
        jc["pos"] = jc["pos"].at[1].add(5)
        tc["pos"][1] += 5
        for _ in range(3):
            nt = rng.integers(1, jcfg.vocab_size, (B, k, 1)).astype(np.int32)
            jl, jc = steps["decode"](params, tokens=jnp.asarray(nt),
                                     cache=jc)
            tl, tc = TM.decode_step(tparams, tcfg, trc,
                                    torch.from_numpy(nt), tc)
            assert tuple(tl.shape) == (B, k, 1, jcfg.vocab_size)
            np.testing.assert_allclose(_np(tl), _np(jl), **_tol(name))
    got = bridge.cache_to_numpy(tc)
    np.testing.assert_array_equal(got["pos"], np.asarray(jc["pos"]))
    layers = slice(None) if name == "float32" else slice(0, 1)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(got["kv"][leaf][layers],
                                   _np(jc["kv"][leaf])[layers], **_tol(name))
    # last_only computes the same final row
    tc2 = TM.cache_init(tcfg, trc, B, MAX_SEQ, device="cpu")
    last, _ = TM.prefill_step_cached(tparams, tcfg, trc,
                                     torch.from_numpy(toks), tc2,
                                     last_only=True)
    assert tuple(last.shape) == (B, k, 1, jcfg.vocab_size)


# ---------------------------------------------------------- serving engine

KNOBS = dict(n_slots=4, max_seq=64, prefill_chunk=8,
             tier_topology=("dram", "ssd-fast"))
N_FIRST, N_RESUBMIT = 6, 3
STATS = ["prefix_hits", "restore_stall_ns", "tier_write_ns", "store_bytes",
         "flushes", "prefill_tokens", "decode_tokens", "steps", "clock_ns",
         "prefill_dispatches", "decode_dispatches", "tier_sr_hit_rate"]


def _traffic():
    rng = np.random.default_rng(11)
    first = [(rid, rng.integers(1, 64, int(n)).tolist(), 6)
             for rid, n in enumerate(rng.integers(5, 21, N_FIRST))]
    again = [(100 + rid, prompt, 5) for rid, prompt, _ in first[:N_RESUBMIT]]
    return first, again


def _drive(engine, request_cls):
    first, again = _traffic()
    for wave in (first, again):
        for rid, prompt, n in wave:
            engine.submit(request_cls(rid=rid, prompt=list(prompt),
                                      max_new_tokens=n))
        engine.run(max_ticks=500)
    return {r.rid: list(r.generated) for r in engine.finished}


@pytest.fixture(scope="module")
def engines(host_mesh):
    jcfg, tcfg = _cfgs("bfloat16")
    rc = RunConfig(model=jcfg, shape=SHAPES["decode_32k"], mesh=MeshConfig(),
                   kv_page_size=16)
    with jax.set_mesh(host_mesh):
        params = JM.init_model(jax.random.PRNGKey(0), jcfg)
        jeng = JEngine(params, jcfg, rc, **KNOBS)
        jtoks = _drive(jeng, JRequest)
    trc = TRunConfig(model=tcfg, shape=TSHAPES["decode_32k"],
                     mesh=TMeshConfig(), kv_page_size=16)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    teng = TEngine(tparams, tcfg, trc, device="cpu", **KNOBS)
    ttoks = _drive(teng, TRequest)
    return jeng, jtoks, teng, ttoks


def test_engine_greedy_tokens_match_reference(engines):
    jeng, jtoks, teng, ttoks = engines
    assert len(ttoks) == N_FIRST + N_RESUBMIT
    assert ttoks == jtoks
    restored = [r.rid for r in teng.finished if r.restored]
    assert sorted(restored) == [100 + i for i in range(N_RESUBMIT)]
    # restored requests give their first run's tokens
    for i in range(N_RESUBMIT):
        assert ttoks[100 + i] == ttoks[i][:5]


@pytest.mark.parametrize("key", STATS)
def test_engine_stats_match_reference(engines, key):
    jeng, _, teng, _ = engines
    assert teng.stats[key] == jeng.stats[key]
    if key in ("prefix_hits", "restore_stall_ns"):
        assert teng.stats[key] > 0


def test_engine_tier_trace_matches_reference(engines):
    jeng, _, teng, _ = engines
    assert teng.tier.snapshot() == jeng.tier.snapshot()
    assert teng.tier.ops == jeng.tier.ops
    assert teng.tier.op_ns == jeng.tier.op_ns
    assert teng.tier.counters["write_bytes"] > 0


def test_engine_cache_matches_reference(engines):
    """Layer 0 of the batch cache (deeper layers carry each framework's
    own bf16 roundings)."""
    jeng, _, teng, _ = engines
    np.testing.assert_array_equal(teng.cache["pos"].numpy(),
                                  np.asarray(jeng.cache["pos"]))
    for n in ("k", "v"):
        want = _np(jeng.cache["kv"][n])
        assert np.abs(want).max() > 0.1
        np.testing.assert_allclose(_np(teng.cache["kv"][n])[:1], want[:1],
                                   **BF16_TOL)


def test_engine_store_entries_match_reference(engines):
    jeng, _, teng, _ = engines
    assert list(teng.store.pages) == list(jeng.store.pages)
    assert teng.store.bytes == jeng.store.bytes
    for rid, jentry in jeng.store.pages.items():
        tentry = teng.store.pages[rid]
        assert tentry["pos"] == jentry["pos"]
        assert tentry.get("first_token") == jentry.get("first_token")
        for n in ("k", "v"):
            np.testing.assert_allclose(_np(tentry["kv"][n])[:1],
                                       _np(jentry["kv"][n])[:1], **BF16_TOL)
