"""The port's hybrid family (zamba2) against the reference on the CPU.

* ``decode_step`` and ``prefill_step_cached`` logits and caches (``kv``,
  ``h``, ``conv``, ``pos``) on smoke zamba2, reference weights carried
  across through ``repro_torch.bridge``. The reference's hybrid prefill is
  a scan of ``decode_step`` over the chunk; the port's runs the chunked SSD
  and the chunked flash prefill, the same function. Tolerances: f32 1e-4;
  bf16 6e-2 on logits (the bound ``tests/test_models.py`` puts on stepwise
  against chunked zamba2) with the f32 states held to it too, and the
  first group's K/V to 2e-2.
* The serving engine against the reference engine on identical traffic
  (f32, a 2-port CXL tier): slots are reused, and one request is admitted
  into a slot that idled for several ticks. The reference never resets a
  slot's Mamba2 state at admission, so the new tenant's scan starts from
  what the old tenant and the idle ticks left; the port must do the same.
  Greedy tokens, tier stats, snapshot and op trace identical; caches within
  1e-4 (the states: of their scale).
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
from repro.models import model as JM
from repro.parallel import sharding as shlib
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MeshConfig as TMeshConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.models import model as TM
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

ARCH = "zamba2-2.7b"
NAMES = ["float32", "bfloat16"]
PAGE, MAX_SEQ, B, PROMPT = 8, 32, 2, 7
F32_TOL = dict(atol=1e-4, rtol=1e-4)
LEAVES = ("k", "v", "h", "conv")


def _tol(name):
    return (dict(atol=6e-2, rtol=6e-2) if name == "bfloat16"
            else F32_TOL)


def _cfgs(name):
    jcfg = dataclasses.replace(jreg.smoke(ARCH), dtype=name)
    tcfg = dataclasses.replace(treg.smoke(ARCH), dtype=name)
    rc = RunConfig(model=jcfg, shape=SHAPES["decode_32k"], mesh=MeshConfig(),
                   kv_page_size=PAGE)
    trc = TRunConfig(model=tcfg, shape=TSHAPES["decode_32k"],
                     mesh=TMeshConfig(), kv_page_size=PAGE)
    return jcfg, rc, tcfg, trc


@pytest.fixture(scope="module")
def models(host_mesh):
    out = {}
    with jax.set_mesh(host_mesh):
        for name in NAMES:
            jcfg, rc, tcfg, trc = _cfgs(name)
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


def _np(x):
    if isinstance(x, torch.Tensor):
        return bridge.to_numpy(x)
    return np.asarray(jnp.asarray(x, jnp.float32))


def _leaf(cache, leaf):
    return cache["kv"][leaf] if leaf in ("k", "v") else cache[leaf]


def _assert_state_close(got, want, tol):
    """The Mamba2 states of random smoke weights are tiny (|h| ~ 1e-6: the
    residual stream starts at the 0.02-scale embedding), so an absolute
    bound alone would pass anything: the bound is ``tol`` relative to the
    leaf's largest entry."""
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=tol)


def _assert_cache_close(got, jc, name):
    """f32: K/V at 1e-4, the states at 1e-4 of their scale. bf16: the f32
    states at the logits' bound; K/V of the first group only, at bf16's
    2e-2 -- deeper groups see inputs that already carry each framework's
    own bf16 roundings."""
    np.testing.assert_array_equal(got["pos"], np.asarray(jc["pos"]))
    for leaf in LEAVES:
        g, w = _leaf(got, leaf), _np(_leaf(jc, leaf))
        assert g.shape == w.shape, leaf
        if leaf in ("h", "conv"):
            _assert_state_close(g, w, _tol(name)["rtol"])
        elif name == "float32":
            np.testing.assert_allclose(g, w, **F32_TOL)
        else:
            np.testing.assert_allclose(g[:1], w[:1], atol=2e-2, rtol=2e-2)


def _prompt():
    return np.random.default_rng(9).integers(1, 256, (B, PROMPT)).astype(
        np.int32)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("chunk", [1, 3, PROMPT])
def test_prefill_step_cached_matches_reference(models, host_mesh, name,
                                               chunk):
    jcfg, rc, params, steps, tcfg, trc, tparams = models[name]
    toks = _prompt()
    jc = JM.cache_init(jcfg, rc, B, max_seq=MAX_SEQ)
    tc = TM.cache_init(tcfg, trc, B, MAX_SEQ, device="cpu")
    with jax.set_mesh(host_mesh):
        for s in range(0, PROMPT, chunk):
            part = toks[:, s:s + chunk]
            jl, jc = steps["prefill"](params, tokens=jnp.asarray(part),
                                      cache=jc)
            tl, tc = TM.prefill_step_cached(tparams, tcfg, trc,
                                            torch.from_numpy(part), tc)
            assert tl.shape == (B, part.shape[1], tcfg.vocab_size)
            np.testing.assert_allclose(_np(tl), _np(jl), **_tol(name))
    _assert_cache_close(bridge.cache_to_numpy(tc), jc, name)


@pytest.mark.parametrize("name", NAMES)
def test_decode_step_matches_reference(models, host_mesh, name):
    """From a prefilled cache with ragged per-slot positions (row 1 five
    tokens on) and a nonzero state, four ticks."""
    jcfg, rc, params, steps, tcfg, trc, tparams = models[name]
    toks = _prompt()
    jc = JM.cache_init(jcfg, rc, B, max_seq=MAX_SEQ)
    rng = np.random.default_rng(10)
    with jax.set_mesh(host_mesh):
        _, jc = steps["prefill"](params, tokens=jnp.asarray(toks), cache=jc)
        jc["pos"] = jc["pos"].at[1].add(5)
        tc = bridge.cache_from_jax(jax.tree_util.tree_map(np.asarray, jc),
                                   device="cpu")
        for _ in range(4):
            nt = rng.integers(1, 256, (B, 1)).astype(np.int32)
            jl, jc = steps["decode"](params, tokens=jnp.asarray(nt),
                                     cache=jc)
            tl, tc = TM.decode_step(tparams, tcfg, trc,
                                    torch.from_numpy(nt), tc)
            assert tl.shape == (B, 1, tcfg.vocab_size)
            np.testing.assert_allclose(_np(tl), _np(jl), **_tol(name))
    _assert_cache_close(bridge.cache_to_numpy(tc), jc, name)


def test_prefill_last_only_is_the_last_row(models):
    jcfg, rc, params, steps, tcfg, trc, tparams = models["float32"]
    toks = torch.from_numpy(_prompt())
    full, _ = TM.prefill_step_cached(
        tparams, tcfg, trc, toks, TM.cache_init(tcfg, trc, B, MAX_SEQ,
                                                device="cpu"))
    last, _ = TM.prefill_step_cached(
        tparams, tcfg, trc, toks, TM.cache_init(tcfg, trc, B, MAX_SEQ,
                                                device="cpu"),
        last_only=True)
    assert last.shape == (B, 1, tcfg.vocab_size)
    torch.testing.assert_close(last[:, 0], full[:, -1])


def test_cache_layout_matches_reference():
    jcfg, rc, tcfg, trc = _cfgs("bfloat16")
    jc = JM.cache_init(jcfg, rc, 3, max_seq=MAX_SEQ, as_shape=True)
    tc = TM.cache_init(tcfg, trc, 3, MAX_SEQ, device="cpu")
    assert sorted(tc) == sorted(jc)
    for leaf in LEAVES:
        want = _leaf(jc, leaf)
        got = _leaf(tc, leaf)
        assert tuple(got.shape) == want.shape, leaf
    assert tc["kv"]["k"].dtype == torch.bfloat16
    assert tc["h"].dtype == tc["conv"].dtype == torch.float32
    view = TM.slot_view(tc, 1)
    view["h"][0, 0].fill_(2.0)
    view["kv"]["k"][0].fill_(3.0)
    assert float(tc["h"][0, 0, 1].min()) == 2.0
    assert float(tc["h"][0, 0, 0].abs().max()) == 0.0
    assert float(tc["kv"]["k"][0, 1].min()) == 3.0


def test_init_model_is_seeded():
    cfg = treg.smoke(ARCH)
    a = TM.init_model(cfg, seed=3, device="cpu")
    b = TM.init_model(cfg, seed=3, device="cpu")
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    assert len(a.groups) == cfg.n_layers // cfg.shared_block_period
    assert all(len(g) == cfg.shared_block_period for g in a.groups)
    assert a.shared.in_map.shape == (2 * cfg.d_model, cfg.d_model)


# ------------------------------------------------ engine vs the reference

KNOBS = dict(n_slots=2, max_seq=32, prefill_chunk=4,
             tier_topology=("dram", "ssd-fast"))
# (rid, prompt length, new tokens): rid 1 retires early and rid 2 reuses
# its slot; rid 3 is submitted only after IDLE_TICKS, so it lands in a slot
# that idled (and kept stepping its Mamba2 state) meanwhile.
FIRST = [(0, 9, 14), (1, 5, 2), (2, 6, 2)]
LATE = (3, 7, 4)
IDLE_TICKS = 9


def _drive(engine, request_cls):
    rng = np.random.default_rng(12)
    prompts = {rid: rng.integers(1, 256, n).tolist()
               for rid, n, _ in FIRST + [LATE]}
    for rid, _, new in FIRST:
        engine.submit(request_cls(rid=rid, prompt=prompts[rid],
                                  max_new_tokens=new))
    for _ in range(IDLE_TICKS):
        engine.step()
    rid, _, new = LATE
    engine.submit(request_cls(rid=rid, prompt=prompts[rid],
                              max_new_tokens=new))
    engine.run(max_ticks=200)
    return {r.rid: list(r.generated) for r in engine.finished}


@pytest.fixture(scope="module")
def engines(host_mesh):
    jcfg, rc, tcfg, trc = _cfgs("float32")
    with jax.set_mesh(host_mesh):
        params = JM.init_model(jax.random.PRNGKey(0), jcfg)
        jeng = JEngine(params, jcfg, rc, **KNOBS)
        jtoks = _drive(jeng, JRequest)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    teng = TEngine(tparams, tcfg, trc, device="cpu", **KNOBS)
    ttoks = _drive(teng, TRequest)
    return jeng, jtoks, teng, ttoks


def test_engine_greedy_tokens_match_reference(engines):
    jeng, jtoks, teng, ttoks = engines
    assert sorted(ttoks) == [0, 1, 2, 3]
    assert ttoks == jtoks
    assert [r.rid for r in teng.finished] == [r.rid for r in jeng.finished]
    assert not any(r.restored for r in teng.finished)


@pytest.mark.parametrize("key", ["prefix_hits", "restore_stall_ns",
                                 "tier_write_ns", "store_bytes", "flushes",
                                 "prefill_tokens", "decode_tokens", "steps",
                                 "clock_ns"])
def test_engine_stats_match_reference(engines, key):
    jeng, _, teng, _ = engines
    assert teng.stats[key] == jeng.stats[key]
    if key in ("tier_write_ns", "flushes"):
        assert teng.stats[key] > 0


def test_engine_tier_trace_matches_reference(engines):
    jeng, _, teng, _ = engines
    assert teng.tier.snapshot() == jeng.tier.snapshot()
    assert teng.tier.ops == jeng.tier.ops
    assert teng.tier.op_ns == jeng.tier.op_ns


@pytest.mark.parametrize("leaf", [*LEAVES, "pos"])
def test_engine_cache_matches_reference(engines, leaf):
    jeng, _, teng, _ = engines
    if leaf == "pos":
        np.testing.assert_array_equal(teng.cache["pos"].numpy(),
                                      np.asarray(jeng.cache["pos"]))
        return
    want = np.asarray(_leaf(jeng.cache, leaf))
    got = bridge.to_numpy(_leaf(teng.cache, leaf))
    assert got.shape == want.shape
    if leaf in ("h", "conv"):
        _assert_state_close(got, want, F32_TOL["rtol"])
        return
    assert np.abs(want).max() > 0.05          # the cache was really written
    np.testing.assert_allclose(got, want, **F32_TOL)
