"""The port's VLM family (llama-3.2-vision-11b) against the reference on the
CPU, at smoke size.

Every ``cross_attn_period``-th layer of the VLM is a gated cross-attention
layer over vision K/V; the others are dense blocks on the paged cache. The
reference's prefill scans ``decode_step`` over the chunk; the port's runs
the self-attention blocks chunk-parallel through the flash prefill and the
cross layer as one attention of the whole chunk over the vision K/V, the
same function. The serving path has no vision input, so its vision K/V
stay at the cache's zeros, in both engines.

- ``vision_kv`` and ``cross_block_apply`` against the reference's (gates
  set away from their initial 0, vision K/V from random embeddings, G 1
  and G 4), f32 (3e-5) and bf16 (2e-2);
- smoke-VLM ``decode_step`` and ``prefill_step_cached`` (chunks 1, 3 and
  the whole prompt, against the reference's scan of ``decode_step``)
  logits and caches, with nonzero gates and the cache's vision K/V
  written from random embeddings, so that the cross layers take part;
- the cache layout and the batch axes, found by differencing two shapes;
- the serving engine against the JAX engine on the traffic of
  ``tests/test_torch_moe.py``, in f32 and in bf16: equal greedy tokens,
  stats, tier snapshot, op trace and op_ns, flushed entries, caches within
  tolerance; the vision K/V are still zero after serving.
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
from repro.models import transformer as JT
from repro.parallel import sharding as shlib
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MeshConfig as TMeshConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

ARCH = "llama-3.2-vision-11b"
NAMES = ["float32", "bfloat16"]
F32_TOL = dict(atol=3e-5, rtol=3e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
PAGE, MAX_SEQ, B, PROMPT = 8, 32, 2, 7
# the gates set away from their initial 0 (tanh 0.54 and -0.38), so that
# both branches of every cross layer reach the logits
GATES = {"attn_gate": 0.6, "mlp_gate": -0.4}


def _tol(name):
    return BF16_TOL if name == "bfloat16" else F32_TOL


def _np(x):
    if isinstance(x, torch.Tensor):
        return bridge.to_numpy(x)
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs(name, **over):
    jcfg = dataclasses.replace(jreg.smoke(ARCH), dtype=name, **over)
    tcfg = dataclasses.replace(treg.smoke(ARCH), dtype=name, **over)
    rc = RunConfig(model=jcfg, shape=SHAPES["decode_32k"], mesh=MeshConfig(),
                   kv_page_size=PAGE)
    trc = TRunConfig(model=tcfg, shape=TSHAPES["decode_32k"],
                     mesh=TMeshConfig(), kv_page_size=PAGE)
    return jcfg, rc, tcfg, trc


def _gated(cross, dtype):
    """A cross pytree with both gates set to ``GATES`` (any leading axes
    kept)."""
    out = dict(cross)
    for name, g in GATES.items():
        out[name] = jnp.full(jnp.shape(cross[name]), g, dtype)
    return out


def _embeds(cfg, seed, lead=(B,)):
    x = np.random.default_rng(seed).standard_normal(
        lead + (cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x).astype(cfg.dtype)


def test_smoke_vlm_keeps_its_shape():
    """The smoke config keeps what makes the VLM its own path: groups of
    self-attention layers closed by a cross layer over vision tokens, rope
    in the self-attention only; the full model's 1601 vision tokens fill
    no whole number of pages of any size (a prime)."""
    cfg = treg.smoke(ARCH)
    assert cfg.family == "vlm" and cfg.cross_attn_period == 2
    assert cfg.n_vision_tokens > 0 and cfg.use_rope
    full = treg.get(ARCH)
    assert (full.n_layers, full.cross_attn_period, full.n_heads,
            full.n_kv_heads, full.head_dim, full.n_vision_tokens) == (
                40, 5, 32, 8, 128, 1601)
    assert all(full.n_vision_tokens % p for p in range(2, 1601))


# ------------------------------------------------------------ cross layer

@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kv_heads", [4, 1])
def test_cross_block_matches_reference(name, kv_heads):
    """``vision_kv`` of random embeddings, then ``cross_block_apply`` of a
    5-token sequence over them, at G 1 and at G 4 (the full model's
    group); the gated branches must move the output."""
    jcfg, _, tcfg, _ = _cfgs(name, n_kv_heads=kv_heads)
    tree = _gated(JT.cross_block_init(jax.random.PRNGKey(2), jcfg),
                  jcfg.dtype)
    block = bridge._block(jax.tree_util.tree_map(np.asarray, tree),
                          functools.partial(bridge.to_tensor, device="cpu"),
                          ())
    assert isinstance(block, TT.CrossBlock)
    emb = _embeds(jcfg, 3)
    jk, jv = jax.jit(JT.vision_kv, static_argnums=1)(tree, jcfg, emb)
    tk, tv = TT.vision_kv(block, tcfg, bridge.to_tensor(np.asarray(emb),
                                                        "cpu"))
    np.testing.assert_allclose(_np(tk), _np(jk), **_tol(name))
    np.testing.assert_allclose(_np(tv), _np(jv), **_tol(name))
    x = np.random.default_rng(4).standard_normal(
        (B, 5, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jcfg.dtype)
    want = jax.jit(JT.cross_block_apply, static_argnums=1)(tree, jcfg, jx,
                                                           (jk, jv))
    tx = bridge.to_tensor(np.asarray(jx), "cpu")
    got = TT.cross_block_apply(block, tcfg, tx, tk, tv)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))
    assert float(np.abs(_np(want) - x).max()) > 1e-2


# ------------------------------------------------------------ whole model

@pytest.fixture(scope="module")
def models(host_mesh):
    """Both frameworks' smoke VLM with the cross gates set to ``GATES``."""
    out = {}
    with jax.set_mesh(host_mesh):
        for name in NAMES:
            jcfg, rc, tcfg, trc = _cfgs(name)
            params = JM.init_model(jax.random.PRNGKey(0), jcfg)
            params["groups"]["cross"] = _gated(params["groups"]["cross"],
                                               jcfg.dtype)
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


def _caches(models, name):
    """Both frameworks' empty caches with every group's vision K/V written
    from random embeddings by that group's cross layer (``vision_kv``)."""
    jcfg, rc, params, _, tcfg, trc, _ = models[name]
    jc = JM.cache_init(jcfg, rc, B, max_seq=MAX_SEQ)
    emb = _embeds(jcfg, 5)
    g = jcfg.n_layers // jcfg.cross_attn_period
    kvs = [JT.vision_kv(jax.tree_util.tree_map(lambda a: a[gi],
                                               params["groups"]["cross"]),
                        jcfg, emb) for gi in range(g)]
    jc["cross_k"] = jnp.stack([k for k, _ in kvs])
    jc["cross_v"] = jnp.stack([v for _, v in kvs])
    tc = bridge.cache_from_jax(jax.tree_util.tree_map(np.asarray, jc),
                               device="cpu")
    return jc, tc


def _assert_cache_close(got, jc, name):
    """f32: every leaf; bf16: the first group's pages (deeper ones see
    inputs that carry each framework's own bf16 roundings). The vision K/V
    are read, never written: equal."""
    np.testing.assert_array_equal(got["pos"], np.asarray(jc["pos"]))
    assert sorted(got) == sorted(jc)
    layers = slice(None) if name == "float32" else slice(0, 1)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(got["kv"][leaf][layers],
                                   _np(jc["kv"][leaf])[layers], **_tol(name))
    for leaf in ("cross_k", "cross_v"):
        np.testing.assert_array_equal(got[leaf], _np(jc[leaf]))


def _prompt():
    return np.random.default_rng(9).integers(1, 256, (B, PROMPT)).astype(
        np.int32)


def test_bridge_builds_vlm_blocks(models):
    jcfg, _, params, _, tcfg, _, tparams = models["float32"]
    g = jcfg.n_layers // jcfg.cross_attn_period
    assert isinstance(tparams, TM.VLMModel)
    assert len(tparams.self_blocks) == len(tparams.cross) == g
    assert all(len(grp) == jcfg.cross_attn_period - 1
               for grp in tparams.self_blocks)
    assert all(isinstance(c, TT.CrossBlock) for c in tparams.cross)
    np.testing.assert_array_equal(
        tparams.self_blocks[1][0].attn.wq.numpy(),
        np.asarray(params["groups"]["self_blocks"]["attn"]["wq"][1, 0]))
    np.testing.assert_array_equal(
        tparams.cross[1].mlp.w_down.numpy(),
        np.asarray(params["groups"]["cross"]["mlp"]["w_down"][1]))
    assert tparams.cross[0].attn_gate.shape == ()
    assert float(tparams.cross[0].attn_gate) == np.float32(
        GATES["attn_gate"])
    # a model drawn by the port has the same structure, gates at 0
    own = TM.init_model(tcfg, seed=1, device="cpu")
    assert [(n, p.shape, p.dtype) for n, p in own.named_parameters()] == [
        (n, p.shape, p.dtype) for n, p in tparams.named_parameters()]
    assert float(own.cross[0].attn_gate) == float(own.cross[0].mlp_gate) == 0


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("chunk", [1, 3, PROMPT])
def test_prefill_step_cached_matches_reference(models, host_mesh, name,
                                               chunk):
    """The chunk-parallel prefill against the reference's scan of
    ``decode_step`` over the chunk: the same function, in f32 within 3e-5
    (bf16 within 2e-2: a 1-row and a C-row bf16 product round apart)."""
    jcfg, rc, params, steps, tcfg, trc, tparams = models[name]
    toks = _prompt()
    jc, tc = _caches(models, name)
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
    tokens on), four ticks; each tick's cross layers attend to the vision
    K/V (nonzero here) through the plain decode attention."""
    jcfg, rc, params, steps, tcfg, trc, tparams = models[name]
    jc, _ = _caches(models, name)
    rng = np.random.default_rng(10)
    with jax.set_mesh(host_mesh):
        _, jc = steps["prefill"](params, tokens=jnp.asarray(_prompt()),
                                 cache=jc)
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


def test_chunked_prefill_equals_stepwise(models):
    """The port's two forms of the prefill, in f32: one chunk through
    ``prefill_step_cached`` against the chunk's tokens through
    ``decode_step`` one by one, logits and caches within 3e-5."""
    _, _, _, _, tcfg, trc, tparams = models["float32"]
    toks = torch.from_numpy(_prompt())
    _, chunked_c = _caches(models, "float32")
    _, step_c = _caches(models, "float32")
    chunked, _ = TM.prefill_step_cached(tparams, tcfg, trc, toks, chunked_c)
    stepwise = torch.cat([TM.decode_step(tparams, tcfg, trc,
                                         toks[:, t:t + 1], step_c)[0]
                          for t in range(PROMPT)], dim=1)
    torch.testing.assert_close(chunked, stepwise, **F32_TOL)
    for leaf in ("k", "v"):
        torch.testing.assert_close(chunked_c["kv"][leaf],
                                   step_c["kv"][leaf], **F32_TOL)


def test_prefill_last_only_is_the_last_row(models):
    _, _, _, _, tcfg, trc, tparams = models["float32"]
    toks = torch.from_numpy(_prompt())
    full, _ = TM.prefill_step_cached(tparams, tcfg, trc, toks,
                                     _caches(models, "float32")[1])
    last, _ = TM.prefill_step_cached(tparams, tcfg, trc, toks,
                                     _caches(models, "float32")[1],
                                     last_only=True)
    assert last.shape == (B, 1, tcfg.vocab_size)
    torch.testing.assert_close(last[:, 0], full[:, -1])


# ----------------------------------------------------------- cache layout

def test_cache_layout_matches_reference():
    """One K/V layer per self-attention layer (group-major) and zeroed
    vision K/V [g, B, Nv, Hkv, D] in the model dtype."""
    jcfg, rc, tcfg, trc = _cfgs("bfloat16")
    jc = JM.cache_init(jcfg, rc, 3, max_seq=MAX_SEQ, as_shape=True)
    tc = TM.cache_init(tcfg, trc, 3, MAX_SEQ, device="cpu")
    assert sorted(tc) == sorted(jc)
    for leaf in ("k", "v"):
        assert tuple(tc["kv"][leaf].shape) == jc["kv"][leaf].shape
        assert tc["kv"][leaf].dtype == torch.bfloat16
    for leaf in ("cross_k", "cross_v"):
        assert tuple(tc[leaf].shape) == jc[leaf].shape
        assert tc[leaf].dtype == torch.bfloat16
        assert float(tc[leaf].abs().max()) == 0.0


def _batch_axes(cache_init):
    """Each leaf's batch axis, found as the reference engine finds it
    (``_batch_axes``): the one axis whose size differs between caches of
    2 and 3 slots; the ``kv`` leaves as one."""
    a, b = cache_init(2), cache_init(3)

    def axis(x, y):
        return next(i for i, (p, q) in enumerate(zip(x.shape, y.shape))
                    if p != q)
    out = {name: axis(a[name], b[name]) for name in a if name != "kv"}
    out["kv"] = {axis(a["kv"][n], b["kv"][n]) for n in a["kv"]}
    return out


def test_batch_axes_match_reference():
    jcfg, rc, tcfg, trc = _cfgs("float32")
    want = _batch_axes(lambda n: JM.cache_init(jcfg, rc, n, max_seq=MAX_SEQ,
                                               as_shape=True))
    assert want == _batch_axes(lambda n: TM.cache_init(
        tcfg, trc, n, MAX_SEQ, device="cpu"))
    assert want.pop("kv") == {1}
    assert want == {name: TM._BATCH_AXIS[name] for name in want}
    tc = TM.cache_init(tcfg, trc, 3, MAX_SEQ, device="cpu")
    view = TM.slot_view(tc, 1)
    view["cross_k"].fill_(2.0)
    assert float(tc["cross_k"][:, 1].min()) == 2.0
    assert float(tc["cross_k"][:, 0].abs().max()) == 0.0


def test_init_model_is_seeded():
    cfg = treg.smoke(ARCH)
    a = TM.init_model(cfg, seed=3, device="cpu")
    b = TM.init_model(cfg, seed=3, device="cpu")
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    assert a.cross[0].attn.wq.shape == (cfg.d_model, cfg.q_dim)


# ------------------------------------------------ engine vs the reference

KNOBS = dict(n_slots=4, max_seq=64, prefill_chunk=8,
             tier_topology=("dram", "ssd-fast"))
N_FIRST, N_RESUBMIT = 6, 3
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


@pytest.fixture(scope="module", params=NAMES)
def engines(request, host_mesh):
    """Both engines on the smoke VLM as initialised (gates 0) with 16-token
    pages, on the traffic of ``_drive``."""
    jcfg, _, tcfg, _ = _cfgs(request.param)
    rc = RunConfig(model=jcfg, shape=SHAPES["decode_32k"], mesh=MeshConfig(),
                   kv_page_size=16)
    trc = TRunConfig(model=tcfg, shape=TSHAPES["decode_32k"],
                     mesh=TMeshConfig(), kv_page_size=16)
    with jax.set_mesh(host_mesh):
        params = JM.init_model(jax.random.PRNGKey(0), jcfg)
        jeng = JEngine(params, jcfg, rc, **KNOBS)
        jtoks = _drive(jeng, JRequest)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    teng = TEngine(tparams, tcfg, trc, device="cpu", **KNOBS)
    ttoks = _drive(teng, TRequest)
    return request.param, jeng, jtoks, teng, ttoks


def test_engine_greedy_tokens_match_reference(engines):
    _, jeng, jtoks, teng, ttoks = engines
    assert len(ttoks) == N_FIRST + N_RESUBMIT
    assert ttoks == jtoks
    assert [r.rid for r in teng.finished] == [r.rid for r in jeng.finished]
    assert not any(r.restored for r in teng.finished)


@pytest.mark.parametrize("key", STATS)
def test_engine_stats_match_reference(engines, key):
    _, jeng, _, teng, _ = engines
    assert teng.stats[key] == jeng.stats[key]
    if key in ("tier_write_ns", "flushes", "store_bytes"):
        assert teng.stats[key] > 0
    if key == "prefix_hits":
        assert teng.stats[key] == 0        # never restored


def test_engine_tier_trace_matches_reference(engines):
    _, jeng, _, teng, _ = engines
    assert teng.tier.snapshot() == jeng.tier.snapshot()
    assert teng.tier.ops == jeng.tier.ops
    assert teng.tier.op_ns == jeng.tier.op_ns
    assert teng.tier.counters["write_bytes"] > 0


def test_engine_cache_matches_reference(engines):
    """f32: every layer's pages; bf16: the first layer's."""
    name, jeng, _, teng, _ = engines
    np.testing.assert_array_equal(teng.cache["pos"].numpy(),
                                  np.asarray(jeng.cache["pos"]))
    assert np.abs(_np(jeng.cache["kv"]["k"])).max() > 0.1
    layers = slice(None) if name == "float32" else slice(0, 1)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(_np(teng.cache["kv"][leaf])[layers],
                                   _np(jeng.cache["kv"][leaf])[layers],
                                   **_tol(name))


def test_engine_store_entries_match_reference(engines):
    name, jeng, _, teng, _ = engines
    assert list(teng.store.pages) == list(jeng.store.pages)
    assert teng.store.bytes == jeng.store.bytes
    layers = slice(None) if name == "float32" else slice(0, 1)
    for rid, jentry in jeng.store.pages.items():
        tentry = teng.store.pages[rid]
        assert tentry["pos"] == jentry["pos"]
        assert tentry["first_token"] == jentry["first_token"]
        assert set(tentry["kv"]) == set(jentry["kv"]) == {"k", "v"}
        for leaf in ("k", "v"):
            np.testing.assert_allclose(_np(tentry["kv"][leaf])[layers],
                                       _np(jentry["kv"][leaf])[layers],
                                       **_tol(name))


def test_engine_never_writes_vision_kv(engines):
    """The reference's engine copies: no step writes the vision K/V, so
    every served token's cross layers attended to the cache's zeros."""
    _, jeng, _, teng, _ = engines
    for leaf in ("cross_k", "cross_v"):
        assert not np.asarray(jeng.cache[leaf]).any()
        assert not teng.cache[leaf].any()
