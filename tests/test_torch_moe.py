"""Port MoE layer, block, model and serving engine vs the reference on the
CPU, at smoke size.

granite-moe-1b-a400m routes each token to 8 of 32 experts at a capacity
of ``round(1.25 · t · 8 / 32)`` pairs an expert. On one device the
reference's prefill and decode MoE both fall back to ``moe_apply``, which
drops the pairs past capacity -- at an 8-slot decode tick each expert
keeps 2 of the tick's 64 pairs -- so the port must drop the same pairs.

- ``moe_apply`` against ``repro.models.moe.moe_apply`` at granite's
  routing (E 32, top-8) and small widths, t in {1, 2, 8, 37, 256}, f32
  (3e-5) and bf16 (2e-2), inputs from one numpy seed; the cases with drops
  must drop; the capacity table, Python's half-to-even ``round`` included.
- The MoE block's prefill and paged decode against ``moe_block_apply`` and
  ``moe_block_decode_paged``; smoke-granite model logits against the
  reference's prefill and decode steps.
- The serving engine against the JAX engine on the traffic of
  ``tests/test_torch_serving.py``, with bf16 pages and with int8 pages:
  equal greedy tokens, stats, tier snapshot, op trace and op_ns and
  stored entries' keys, positions and first tokens, pages within
  tolerance; the traffic drops pairs at decode.
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
from repro.models import moe as jmoe
from repro.parallel import sharding as shlib
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MeshConfig as TMeshConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

ARCH = "granite-moe-1b-a400m"
NAMES = ["float32", "bfloat16"]
F32_TOL = dict(atol=3e-5, rtol=3e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _tol(name):
    return BF16_TOL if name == "bfloat16" else F32_TOL


def _np(x):
    if isinstance(x, torch.Tensor):
        return bridge.to_numpy(x)
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs(name, **over):
    jcfg = dataclasses.replace(jreg.smoke(ARCH), dtype=name, **over)
    tcfg = dataclasses.replace(treg.smoke(ARCH), dtype=name, **over)
    return jcfg, tcfg


def _to_torch(tree, tcfg):
    """One reference MoE pytree (numpy leaves) as the port's ``MoE``."""
    t = functools.partial(bridge.to_tensor, device="cpu")
    return tmoe.MoE(*(t(tree[n]) for n in ("router", "e_gate", "e_up",
                                           "e_down")))


# ------------------------------------------------------------ moe_apply

# granite's routing (32 experts, top-8) at the smoke widths
GRANITE_ROUTING = dict(n_experts=32, top_k=8)
# the reference as its model runs it: jitted (cfg static)
_moe_apply = jax.jit(jmoe.moe_apply, static_argnums=1)
_moe_block_apply = jax.jit(jmoe.moe_block_apply, static_argnums=1)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("t", [1, 2, 8, 37, 256])
def test_moe_apply_matches_reference(name, t):
    jcfg, tcfg = _cfgs(name, **GRANITE_ROUTING)
    tree = jax.tree_util.tree_map(
        np.asarray, jmoe.moe_init(jax.random.PRNGKey(t), jcfg))
    x = np.random.default_rng(t).standard_normal(
        (1, t, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jcfg.dtype)
    want, want_aux = _moe_apply(tree, jcfg, jx)
    moe = _to_torch(tree, tcfg)
    tx = bridge.to_tensor(np.asarray(jx), "cpu")
    got, aux = tmoe.moe_apply(moe, tcfg, tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    dropped, pairs = tmoe.dropped_pairs(moe, tcfg, tx)
    assert pairs == 8 * t
    if t in (8, 37, 256):        # capacity 2, 12, 80: random routes drop
        assert int(dropped) > 0
    if t == 1:
        assert int(dropped) == 0
    # the one-rank entry points and the plain version on one rank are
    # moe_apply (more ranks: tests/test_torch_ep.py)
    torch.testing.assert_close(tmoe.moe_apply_ep_decode(moe, tcfg, tx), got,
                               rtol=0, atol=0)
    torch.testing.assert_close(tmoe.moe_apply_ep(moe, tcfg, tx)[0], got,
                               rtol=0, atol=0)
    ref, drops = tmoe.moe_apply_ep_ref(moe, tcfg, tx, 1)
    torch.testing.assert_close(ref, got, rtol=0, atol=0)
    assert drops == {"dispatch": 0, "expert": int(dropped)}


@pytest.mark.parametrize("tokens,k,experts,want", [
    (8, 8, 32, 2),         # granite's 8-slot decode tick: round(2.5) = 2
    (256, 8, 32, 80),      # granite's 256-token prefill chunk
    (1, 8, 32, 1),         # round(0.3125) = 0, at least 1
    (24, 8, 32, 8),        # round(7.5) = 8: half to even, up
    (40, 8, 32, 12),       # round(12.5) = 12: half to even, down
    (4, 2, 8, 1),          # the smoke config's 4-slot tick: round(1.25)
    (37, 2, 8, 12),        # a ragged last chunk
])
def test_capacity_table(tokens, k, experts, want):
    assert tmoe._capacity(1.25, tokens, k, experts) == want
    assert jmoe._capacity(1.25, tokens, k, experts) == want


# ------------------------------------------------------- block and model

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


def test_bridge_builds_moe_blocks(models):
    jcfg, _, params, _, tcfg, _, tparams = models["float32"]
    assert len(tparams.blocks) == jcfg.n_layers
    blk = tparams.blocks[1]
    assert isinstance(blk, TT.MoEBlock)
    assert blk.moe.router.dtype == torch.float32
    assert tuple(blk.moe.e_gate.shape) == (jcfg.n_experts, jcfg.d_model,
                                           jcfg.d_ff)
    np.testing.assert_array_equal(
        blk.moe.e_down.numpy(),
        np.asarray(params["blocks"]["moe"]["e_down"][1]))
    # a model drawn by the port has the same structure
    own = TM.init_model(tcfg, seed=1, device="cpu")
    assert [n for n, _ in own.named_parameters()] == [
        n for n, _ in tparams.named_parameters()]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_moe_block_matches_reference(models, host_mesh, name, kind):
    """Layer 0 over an empty cache (prefill, against the reference's
    whole-sequence ``moe_block_apply``) or at ragged positions over
    written pages (decode, against ``moe_block_decode_paged``)."""
    jcfg, rc, params, _, tcfg, trc, tparams = models[name]
    layer = jax.tree_util.tree_map(lambda a: a[0], params["blocks"])
    rng = np.random.default_rng(12)
    c = PROMPT if kind == "prefill" else 1
    x = rng.standard_normal((B, c, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jcfg.dtype)
    tx = bridge.to_tensor(np.asarray(jx), "cpu")
    jc = JM.cache_init(jcfg, rc, B, max_seq=MAX_SEQ)
    jkv = jax.tree_util.tree_map(lambda a: a[0], jc["kv"])
    if kind == "decode":
        jkv = {n: (jnp.asarray(rng.standard_normal(a.shape), a.dtype))
               for n, a in jkv.items()}
    tkv = {n: bridge.to_tensor(np.asarray(a), "cpu") for n, a in jkv.items()}
    with jax.set_mesh(host_mesh):
        if kind == "prefill":
            positions = np.broadcast_to(np.arange(c, dtype=np.int32),
                                        (B, c)).copy()
            want, _ = _moe_block_apply(layer, jcfg, jx,
                                       jnp.asarray(positions))
            got = TT.block_prefill_cached(
                tparams.blocks[0], tcfg, tx, torch.from_numpy(positions),
                torch.zeros(B, dtype=torch.int32), tkv)
        else:
            pos = np.array([5, 19], np.int32)
            want, wkv = jax.jit(functools.partial(
                JM._paged_block_decode, jmoe.moe_block_decode_paged,
                cfg=jcfg, rc=rc))(layer, x=jx, pos=jnp.asarray(pos),
                                  kv=jkv)
            got = TT.block_decode_paged(tparams.blocks[0], tcfg, tx,
                                        torch.from_numpy(pos), tkv)
            for n in ("k", "v"):
                np.testing.assert_allclose(_np(tkv[n]), _np(wkv[n]),
                                           **_tol(name))
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))


def _prompt():
    return np.random.default_rng(9).integers(1, 256, (B, PROMPT)).astype(
        np.int32)


@pytest.mark.parametrize("name", NAMES)
def test_model_logits_match(models, host_mesh, name):
    """Chunked prefill (chunks of 3, the last ragged), then decode steps
    with row 1 five positions on; f32 holds every layer's cache too, bf16
    the first layer's (deeper ones see each framework's own roundings)."""
    jcfg, rc, params, steps, tcfg, trc, tparams = models[name]
    toks = _prompt()
    jc = JM.cache_init(jcfg, rc, B, max_seq=MAX_SEQ)
    tc = TM.cache_init(tcfg, trc, B, MAX_SEQ, device="cpu")
    rng = np.random.default_rng(10)
    with jax.set_mesh(host_mesh):
        for s in range(0, PROMPT, 3):
            part = toks[:, s:s + 3]
            jl, jc = steps["prefill"](params, tokens=jnp.asarray(part),
                                      cache=jc)
            tl, tc = TM.prefill_step_cached(tparams, tcfg, trc,
                                            torch.from_numpy(part), tc)
            np.testing.assert_allclose(_np(tl), _np(jl), **_tol(name))
        jc["pos"] = jc["pos"].at[1].add(5)
        tc["pos"][1] += 5
        for _ in range(3):
            nt = rng.integers(1, 256, (B, 1)).astype(np.int32)
            jl, jc = steps["decode"](params, tokens=jnp.asarray(nt),
                                     cache=jc)
            tl, tc = TM.decode_step(tparams, tcfg, trc,
                                    torch.from_numpy(nt), tc)
            assert tl.shape == (B, 1, tcfg.vocab_size)
            np.testing.assert_allclose(_np(tl), _np(jl), **_tol(name))
    got = bridge.cache_to_numpy(tc)
    np.testing.assert_array_equal(got["pos"], np.asarray(jc["pos"]))
    layers = slice(None) if name == "float32" else slice(0, 1)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(got["kv"][leaf][layers],
                                   _np(jc["kv"][leaf])[layers], **_tol(name))


# ------------------------------------------------------ serving engine

KNOBS = dict(n_slots=4, max_seq=64, prefill_chunk=8,
             tier_topology=("dram", "ssd-fast"))
N_FIRST, N_RESUBMIT = 6, 3
MODES = ["bf16", "int8"]
STATS = ["prefix_hits", "restore_stall_ns", "tier_write_ns", "store_bytes",
         "flushes", "prefill_tokens", "decode_tokens", "steps", "clock_ns",
         "prefill_dispatches", "decode_dispatches", "tier_sr_hit_rate"]


def _traffic():
    rng = np.random.default_rng(11)
    first = [(rid, rng.integers(1, 256, int(n)).tolist(), 6)
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


class _DropCounter:
    """Counts the pairs the port's decode MoE drops (wraps
    ``moe_apply_ep_decode``)."""

    def __init__(self, monkeypatch):
        self.dropped = self.pairs = 0
        inner = tmoe.moe_apply_ep_decode

        def counted(moe, cfg, x, **kw):
            n, pairs = tmoe.dropped_pairs(moe, cfg, x)
            self.dropped += int(n)
            self.pairs += pairs
            return inner(moe, cfg, x, **kw)
        monkeypatch.setattr(tmoe, "moe_apply_ep_decode", counted)


@pytest.fixture(scope="module", params=MODES)
def engines(request, host_mesh):
    """Both engines on smoke granite in bf16, with bf16 pages or int8
    pages, on the traffic of ``_drive``."""
    knobs = dict(KNOBS, kv_quant="int8" if request.param == "int8"
                 else "none")
    jcfg, tcfg = _cfgs("bfloat16")
    rc = RunConfig(model=jcfg, shape=SHAPES["decode_32k"], mesh=MeshConfig(),
                   kv_page_size=16)
    with jax.set_mesh(host_mesh):
        params = JM.init_model(jax.random.PRNGKey(0), jcfg)
        jeng = JEngine(params, jcfg, rc, **knobs)
        jtoks = _drive(jeng, JRequest)
    trc = TRunConfig(model=tcfg, shape=TSHAPES["decode_32k"],
                     mesh=TMeshConfig(), kv_page_size=16)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    teng = TEngine(tparams, tcfg, trc, device="cpu", **knobs)
    with pytest.MonkeyPatch.context() as mp:
        drops = _DropCounter(mp)
        ttoks = _drive(teng, TRequest)
    return request.param, jeng, jtoks, teng, ttoks, drops


def test_engine_greedy_tokens_match_reference(engines):
    mode, jeng, jtoks, teng, ttoks, drops = engines
    assert len(ttoks) == N_FIRST + N_RESUBMIT
    assert ttoks == jtoks
    restored = [r.rid for r in teng.finished if r.restored]
    assert sorted(restored) == [100 + i for i in range(N_RESUBMIT)]
    # the 4-slot tick keeps 1 pair an expert: the traffic drops
    assert drops.pairs > 0 and 0 < drops.dropped < drops.pairs
    if mode == "int8":
        assert teng.cache["kv"]["k"].dtype == torch.int8


@pytest.mark.parametrize("key", STATS)
def test_engine_stats_match_reference(engines, key):
    _, jeng, _, teng, _, _ = engines
    assert teng.stats[key] == jeng.stats[key]
    if key in ("prefix_hits", "restore_stall_ns"):
        assert teng.stats[key] > 0


def test_engine_tier_trace_matches_reference(engines):
    _, jeng, _, teng, _, _ = engines
    assert teng.tier.snapshot() == jeng.tier.snapshot()
    assert teng.tier.ops == jeng.tier.ops
    assert teng.tier.op_ns == jeng.tier.op_ns
    assert teng.tier.counters["write_bytes"] > 0


def _assert_pages_close(mode, got, want, layers=slice(None)):
    """bf16 pages within the bf16 tolerance; int8 pages: scales within
    1e-6 relative and codes equal but for steps of one, on ``layers``."""
    if mode == "bf16":
        for n in ("k", "v"):
            np.testing.assert_allclose(_np(got[n])[layers],
                                       _np(want[n])[layers], **BF16_TOL)
        return
    for n in ("k", "v"):
        np.testing.assert_allclose(_np(got[n + "_scale"])[layers],
                                   np.asarray(want[n + "_scale"])[layers],
                                   rtol=1e-6, atol=0)
        step = np.abs(got[n].numpy().astype(np.int32)
                      - np.asarray(want[n]).astype(np.int32))[layers]
        assert step.max() <= 1


def test_engine_cache_matches_reference(engines):
    """Layer 0 of the batch cache (deeper layers carry each framework's
    own bf16 roundings)."""
    mode, jeng, _, teng, _, _ = engines
    np.testing.assert_array_equal(teng.cache["pos"].numpy(),
                                  np.asarray(jeng.cache["pos"]))
    assert np.abs(_np(jeng.cache["kv"]["k"])).max() > 0.1
    _assert_pages_close(mode, teng.cache["kv"], jeng.cache["kv"],
                        slice(0, 1))


def test_engine_store_entries_match_reference(engines):
    mode, jeng, _, teng, _, _ = engines
    assert list(teng.store.pages) == list(jeng.store.pages)
    assert teng.store.bytes == jeng.store.bytes
    for rid, jentry in jeng.store.pages.items():
        tentry = teng.store.pages[rid]
        assert tentry["pos"] == jentry["pos"]
        assert tentry.get("first_token") == jentry.get("first_token")
        assert set(tentry["kv"]) == set(jentry["kv"])
        _assert_pages_close(mode, tentry["kv"], jentry["kv"], slice(0, 1))
