"""Port serving engine vs the reference engine on identical traffic.

Smoke qwen3-1.7b in f32 (so no argmax tie can flip), a 2-port CXL tier,
chunked prefill over several pages, and resubmitted prompts served by
cold-tier prefix restore. The reference weights cross through
``repro_torch.bridge``; both engines must give the same greedy tokens, the
same tier charges and snapshot, and paged caches that agree within the f32
tolerance of ``tests/test_kernel_parity.py``. Random smoke weights often
decode one token over and over, so the cache comparison is the part with
teeth. Also: the copied CxlTier against the reference on one op sequence.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import MeshConfig, RunConfig, SHAPES
from repro.core.tier import CxlTier as JCxlTier, TierConfig as JTierConfig
from repro.models import model as JM
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MeshConfig as TMeshConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.core.tier import CxlTier as TCxlTier
from repro_torch.core.tier import TierConfig as TTierConfig
from repro_torch.serving.config import ServeConfig as TServeConfig
from repro_torch.serving.engine import HostPageStore
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

F32_TOL = dict(atol=3e-5, rtol=3e-5)
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


@pytest.fixture(scope="module")
def engines(host_mesh):
    cfg = dataclasses.replace(jreg.smoke("qwen3-1.7b"), dtype="float32")
    rc = RunConfig(model=cfg, shape=SHAPES["decode_32k"], mesh=MeshConfig(),
                   kv_page_size=PAGE)
    with jax.set_mesh(host_mesh):
        params = JM.init_model(jax.random.PRNGKey(0), cfg)
        jeng = JEngine(params, cfg, rc, **KNOBS)
        jtoks = _drive(jeng, JRequest)
    tcfg = dataclasses.replace(treg.smoke("qwen3-1.7b"), dtype="float32")
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
    assert got.shape == want.shape
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
            assert tentry["kv"][name].device.type == "cpu"
            np.testing.assert_allclose(tentry["kv"][name].numpy(),
                                       jentry["kv"][name], **F32_TOL)


# ----------------------------------------------- the copied timing model

def _tier_ops(tier_cls, cfg_cls, topology):
    tier = tier_cls(cfg_cls(topology=topology, placement="hotness"))
    out = []
    for rid in range(5):
        out.append(tier.write_entry(rid, 40_000 + 8192 * rid))
        tier.advance(50_000.0)
    for rid in (1, 3, 1, 1, 4):
        tier.speculative_read(rid, 40_000 + 8192 * rid)
        tier.advance(20_000.0)
        out.append(tier.read_entry(rid, 40_000 + 8192 * rid))
    h = tier.read_entry_async(2, 40_000 + 8192 * 2)
    out += [h.issue_wait_ns, h.in_flight_ns]
    w = tier.write_entry_async(("swap", 9), 65_536)
    out.append(w.issue_wait_ns)
    tier.advance(1e6)
    out += [tier.poll(h), tier.poll(w), tier.admit_store()]
    tier.free_entry(0)
    return out, tier.snapshot(), tier.ops, tier.op_ns


@pytest.mark.parametrize("topology", [("dram",), ("dram", "ssd-fast"),
                                      ("dram", "ssd-fast", "ssd-slow")])
def test_tier_copy_matches_reference(topology):
    want = _tier_ops(JCxlTier, JTierConfig, topology)
    got = _tier_ops(TCxlTier, TTierConfig, topology)
    assert got == want


def test_entry_bytes_matches_reference():
    kv = {"k": np.zeros((2, 3, 4), np.float32),
          "v": np.zeros((2, 3, 4), np.float32)}
    entry = {"kv": kv, "pos": 7, "first_token": 3, "prompt": (1, 2, 3)}
    tentry = dict(entry, kv={n: torch.from_numpy(a) for n, a in kv.items()})
    want = JCxlTier.entry_bytes(entry)
    assert want == 2 * 2 * 3 * 4 * 4
    assert TCxlTier.entry_bytes(entry) == want
    assert TCxlTier.entry_bytes(tentry) == want
    half = {"kv": {n: torch.zeros((2, 3, 4), dtype=torch.bfloat16)
                   for n in kv}}
    assert TCxlTier.entry_bytes(half) == want // 2


def test_host_page_store_copies_and_evicts():
    store = HostPageStore(budget_bytes=200)
    src = {"k": torch.ones(10), "v": torch.ones(10)}          # 80 bytes
    assert store.put(1, {"kv": src, "prompt": (1,)})
    src["k"].zero_()                 # the stored pages are a copy
    assert float(store.pages[1]["kv"]["k"].sum()) == 10.0
    assert store.put(2, {"kv": {"k": torch.ones(10), "v": torch.ones(10)}})
    assert store.put(3, {"kv": {"k": torch.ones(10), "v": torch.ones(10)}})
    assert list(store.pages) == [2, 3] and store.evictions == 1
    assert store.bytes == 160


@pytest.mark.parametrize("knobs,exc", [
    (dict(kv_quant="int8", legacy_host_path=True), ValueError),
    (dict(legacy_host_path=True), NotImplementedError),
    (dict(kv_quant="fp8"), ValueError),
])
def test_serve_config_unported_options_raise(knobs, exc):
    with pytest.raises(exc):
        TServeConfig(**knobs)


def test_sharded_options_raise():
    """Multi-rank serving is ported for every family over the model axis
    (``tests/test_torch_sharded.py``, ``tests/test_torch_sharded_*.py``)
    and the data and pod axes (``tests/test_torch_data_axis*.py``); what
    is not raises: the MoE family over the data and model axes at once
    (as the reference's does), an engine without a rank group or mesh of
    its size (the hybrid's too), and a page axis the ranks do not divide
    (the reference's ValueError)."""
    from repro_torch.core.sharded_tier import ShardedTier
    tier = TServeConfig(tp=2, tier_media="dram").make_tier()
    assert isinstance(tier, ShardedTier) and tier.n_ranks == 2
    from repro_torch.models import model as TM
    for arch, knobs, exc in (
            ("zamba2-2.7b", dict(tp=2), ValueError),
            ("granite-moe-1b-a400m", dict(mesh_shape=(2, 2)),
             NotImplementedError),
            ("qwen3-1.7b", dict(mesh_shape=(2, 2)), ValueError),
            ("qwen3-1.7b", dict(tp=2), ValueError)):
        cfg = treg.smoke(arch)
        rc = TRunConfig(model=cfg, shape=TSHAPES["decode_32k"],
                        mesh=TMeshConfig())
        params = TM.init_model(cfg, device="cpu")
        with pytest.raises(exc):
            TEngine(params, cfg, rc, device="cpu", **knobs)
    from repro_torch.parallel import sharding
    with pytest.raises(ValueError, match="divisible by the model axis"):
        sharding.check_pages(1, 2, 64, 256)
