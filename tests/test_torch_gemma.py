"""Port serving engine vs the reference engine on smoke gemma-2b.

gemma-2b is the dense family's MQA member (one kv head), with geglu, tied
embeddings and head_dim 256 at full width -- the path that runs the D 256
flash-prefill instance on the card. Its smoke config (4 layers, d_model
64, 4 query heads over 1 kv head, head_dim 16) goes through the traffic of
``tests/test_torch_serving.py`` in f32: chunked prefill over several
pages, then resubmitted prompts served by cold-tier prefix restore. The
reference weights cross through ``repro_torch.bridge``; both engines must
give the same greedy tokens, stats, tier snapshot and op trace, and paged
caches and stored entries within the f32 tolerance of
``tests/test_kernel_parity.py`` (3e-5). The same again with int8 KV pages
(``kv_quant="int8"``: the path whose prefill runs the f32 D 256 instance
at full width), its caches and entries held as
``tests/test_torch_kv_quant.py`` holds them: scales within 1e-6 relative,
codes equal but for steps of one (counted).
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.configs.base import MeshConfig, RunConfig, SHAPES
from repro.models import model as JM
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MeshConfig as TMeshConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
F32_TOL = dict(atol=3e-5, rtol=3e-5)
ARCH = "gemma-2b"
# the engine and traffic of tests/test_torch_serving.py
KNOBS = dict(n_slots=4, max_seq=64, prefill_chunk=8,
             tier_topology=("dram", "ssd-fast"))
PAGE = 16                      # 4 pages per slot
N_FIRST, N_RESUBMIT = 6, 3


def _traffic():
    rng = np.random.default_rng(11)
    first = [(rid, rng.integers(1, 256, int(n)).tolist(), 6)
             for rid, n in enumerate(rng.integers(5, 21, N_FIRST))]
    # the same prompts again under new rids: prompt-alias prefix restores
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


def test_smoke_gemma_keeps_its_shape():
    """The smoke config keeps what makes gemma-2b its own path: one kv
    head (MQA), geglu and tied embeddings."""
    cfg = treg.smoke(ARCH)
    assert (cfg.n_kv_heads, cfg.activation, cfg.tie_embeddings) == (
        1, "geglu", True)
    assert cfg.n_heads > cfg.n_kv_heads
    full = treg.get(ARCH)
    assert (full.head_dim, full.n_kv_heads, full.n_layers) == (256, 1, 18)


@pytest.fixture(scope="module")
def engines(host_mesh):
    cfg = dataclasses.replace(jreg.smoke(ARCH), dtype="float32")
    rc = RunConfig(model=cfg, shape=SHAPES["decode_32k"], mesh=MeshConfig(),
                   kv_page_size=PAGE)
    with jax.set_mesh(host_mesh):
        params = JM.init_model(jax.random.PRNGKey(0), cfg)
        jeng = JEngine(params, cfg, rc, **KNOBS)
        jtoks = _drive(jeng, JRequest)
    tcfg = dataclasses.replace(treg.smoke(ARCH), dtype="float32")
    trc = TRunConfig(model=tcfg, shape=TSHAPES["decode_32k"],
                     mesh=TMeshConfig(), kv_page_size=PAGE)
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


@pytest.mark.parametrize("key", ["prefix_hits", "restore_stall_ns",
                                 "tier_write_ns", "store_bytes", "flushes",
                                 "prefill_tokens", "decode_tokens", "steps",
                                 "clock_ns"])
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


@pytest.mark.parametrize("name", ["k", "v", "pos"])
def test_engine_paged_cache_matches_reference(engines, name):
    jeng, _, teng, _ = engines
    if name == "pos":
        np.testing.assert_array_equal(teng.cache["pos"].numpy(),
                                      np.asarray(jeng.cache["pos"]))
        return
    want = np.asarray(jeng.cache["kv"][name])
    got = bridge.to_numpy(teng.cache["kv"][name])
    assert got.shape == want.shape and got.shape[-2] == 1   # one kv head
    assert np.abs(want).max() > 0.1           # the cache was really written
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_engine_store_entries_match_reference(engines):
    jeng, _, teng, _ = engines
    assert list(teng.store.pages) == list(jeng.store.pages)
    for rid, jentry in jeng.store.pages.items():
        tentry = teng.store.pages[rid]
        assert tentry["pos"] == jentry["pos"]
        assert tentry["first_token"] == jentry["first_token"]
        for name in ("k", "v"):
            np.testing.assert_allclose(tentry["kv"][name].numpy(),
                                       jentry["kv"][name], **F32_TOL)


# ------------------------------------------- int8 KV pages (MQA, geglu)

INT8_KNOBS = dict(KNOBS, kv_quant="int8")
SCALE_RTOL = 1e-6


@pytest.fixture(scope="module")
def int8_engines(host_mesh):
    """Both engines on smoke gemma-2b with int8 KV pages, the traffic of
    ``_drive``: the path whose prefill, at full width, runs the f32 D 256
    flash-prefill instance over the dequantized pages."""
    cfg = dataclasses.replace(jreg.smoke(ARCH), dtype="float32")
    rc = RunConfig(model=cfg, shape=SHAPES["decode_32k"], mesh=MeshConfig(),
                   kv_page_size=PAGE)
    with jax.set_mesh(host_mesh):
        params = JM.init_model(jax.random.PRNGKey(0), cfg)
        jeng = JEngine(params, cfg, rc, **INT8_KNOBS)
        jtoks = _drive(jeng, JRequest)
    tcfg = dataclasses.replace(treg.smoke(ARCH), dtype="float32")
    trc = TRunConfig(model=tcfg, shape=TSHAPES["decode_32k"],
                     mesh=TMeshConfig(), kv_page_size=PAGE)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    teng = TEngine(tparams, tcfg, trc, device="cpu", **INT8_KNOBS)
    ttoks = _drive(teng, TRequest)
    return jeng, jtoks, teng, ttoks


def test_int8_engine_greedy_tokens_match_reference(int8_engines):
    jeng, jtoks, teng, ttoks = int8_engines
    assert str(teng.cache["kv"]["k"].dtype) == "torch.int8"
    assert len(ttoks) == N_FIRST + N_RESUBMIT
    assert ttoks == jtoks
    restored = [r.rid for r in teng.finished if r.restored]
    assert sorted(restored) == [100 + i for i in range(N_RESUBMIT)]


@pytest.mark.parametrize("key", ["prefix_hits", "restore_stall_ns",
                                 "tier_write_ns", "store_bytes", "flushes",
                                 "prefill_tokens", "decode_tokens", "steps",
                                 "clock_ns"])
def test_int8_engine_stats_match_reference(int8_engines, key):
    jeng, _, teng, _ = int8_engines
    assert teng.stats[key] == jeng.stats[key]
    if key in ("prefix_hits", "restore_stall_ns"):
        assert teng.stats[key] > 0


def test_int8_engine_tier_trace_matches_reference(int8_engines):
    jeng, _, teng, _ = int8_engines
    assert teng.tier.snapshot() == jeng.tier.snapshot()
    assert teng.tier.ops == jeng.tier.ops
    assert teng.tier.op_ns == jeng.tier.op_ns
    assert teng.tier.counters["write_bytes"] > 0


def _assert_pages_close(got, want):
    """Scales within 1e-6 relative; dequantized pages within 3e-5 plus one
    code step of their page (``tests/test_torch_kv_quant.py``'s gate).
    Returns the count of codes that differ."""
    n_diff = 0
    for name in ("k", "v"):
        gs, ws = got[name + "_scale"], np.asarray(want[name + "_scale"])
        np.testing.assert_allclose(gs, ws, rtol=SCALE_RTOL, atol=0)
        gq, wq = got[name], np.asarray(want[name])
        assert gq.dtype == wq.dtype == np.int8
        assert gq.shape == wq.shape and gq.shape[-2] == 1    # one kv head
        n_diff += int((gq != wq).sum())
        step = ws[..., :, None, :, None]
        dg = gq.astype(np.float32) * gs[..., :, None, :, None]
        dw = wq.astype(np.float32) * step
        bound = 3e-5 + 3e-5 * np.abs(dw) + step * (1 + 1e-6)
        assert (np.abs(dg - dw) <= bound).all(), (
            f"{name}: {n_diff} codes differ, beyond one step somewhere")
    return n_diff


def test_int8_engine_cache_matches_reference(int8_engines):
    jeng, _, teng, _ = int8_engines
    got = bridge.cache_to_numpy(teng.cache)
    np.testing.assert_array_equal(got["pos"], np.asarray(jeng.cache["pos"]))
    assert np.abs(np.asarray(jeng.cache["kv"]["k"])).max() > 10
    n_diff = _assert_pages_close(got["kv"], jeng.cache["kv"])
    print(f"{ARCH}: {n_diff} of {2 * got['kv']['k'].size} codes differ")


def test_int8_engine_store_entries_match_reference(int8_engines):
    jeng, _, teng, _ = int8_engines
    assert list(teng.store.pages) == list(jeng.store.pages)
    assert teng.store.bytes == jeng.store.bytes
    for rid, jentry in jeng.store.pages.items():
        tentry = teng.store.pages[rid]
        assert tentry["pos"] == jentry["pos"]
        assert tentry.get("first_token") == jentry.get("first_token")
        assert set(tentry["kv"]) == set(jentry["kv"])
        _assert_pages_close({n: t.numpy() for n, t in tentry["kv"].items()},
                            jentry["kv"])
