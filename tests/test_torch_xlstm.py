"""The port's xLSTM family (xlstm-125m) against the reference on the CPU,
at smoke size.

xLSTM runs no Pallas kernel: its serving path is the recurrent mLSTM and
sLSTM steps, plain jnp in the reference and plain PyTorch in the port; the
reference's prefill scans ``decode_step`` over the chunk, the port's takes
each layer's steps over the whole chunk (memory updates and cells token by
token, projections once). Its cache has no pages (no ``"kv"``): the engine
stages, flushes and restores nothing.

- ``mlstm_step`` and ``slstm_step`` against the reference's from its state
  initialisers, inputs from one numpy seed: six calls of one token each,
  and six calls of five tokens each against five reference steps; f32
  (3e-5) and bf16 (2e-2) on the outputs, the states relative to their
  scale;
- smoke-xlstm ``prefill_step_cached`` (chunks 1, 3 and the whole prompt)
  and ``decode_step`` logits and caches against the reference's steps;
- the cache layout: shapes, dtypes, zeros (the engine cache's, not the
  state initialisers' -1e9 and 1e-6) and the batch axes, found by
  differencing two shapes as the reference engine finds them;
- the serving engine against the JAX engine on the traffic of
  ``tests/test_torch_moe.py``, in f32 and in bf16: equal greedy tokens,
  stats, tier snapshot, op trace and op_ns, no flush, caches within
  tolerance; a request admitted into a used slot starts from the state its
  previous tenant left (the reference never resets it).
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
from repro.models import xlstm as jxl
from repro.parallel import sharding as shlib
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MeshConfig as TMeshConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.models import model as TM
from repro_torch.models import xlstm as txl
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

ARCH = "xlstm-125m"
NAMES = ["float32", "bfloat16"]
F32_TOL = dict(atol=3e-5, rtol=3e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
MAX_SEQ, B, PROMPT = 32, 2, 7
STATE_LEAVES = ("mC", "mn", "mm", "mconv", "sh", "sc", "sn", "sm", "sconv")


def _tol(name):
    return BF16_TOL if name == "bfloat16" else F32_TOL


def _np(x):
    if isinstance(x, torch.Tensor):
        return bridge.to_numpy(x)
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs(name):
    jcfg = dataclasses.replace(jreg.smoke(ARCH), dtype=name)
    tcfg = dataclasses.replace(treg.smoke(ARCH), dtype=name)
    rc = RunConfig(model=jcfg, shape=SHAPES["decode_32k"], mesh=MeshConfig())
    trc = TRunConfig(model=tcfg, shape=TSHAPES["decode_32k"],
                     mesh=TMeshConfig())
    return jcfg, rc, tcfg, trc


def _assert_state_close(got, want, rtol):
    """A state leaf within ``rtol`` relative to its largest entry: the
    states of random smoke weights span several scales (the mLSTM's C is
    ~1e-2, the sLSTM's n ~6), so one absolute bound would pass the small
    ones whatever their values."""
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, atol=rtol * scale, rtol=rtol)


def test_smoke_xlstm_keeps_its_shape():
    """The smoke config keeps what makes xlstm-125m its own path: mLSTM
    groups closed by an sLSTM layer, no rope (sinusoidal positions), tied
    embeddings, no FFN of its own beside the sLSTM's."""
    cfg = treg.smoke(ARCH)
    assert cfg.family == "ssm" and cfg.slstm_every == 2
    assert (cfg.use_rope, cfg.tie_embeddings, cfg.d_ff) == (False, True, 0)
    full = treg.get(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.slstm_every,
            full.mlstm_expand) == (12, 768, 4, 6, 2)


# ------------------------------------------------------------------ steps

_STEPS = {"mlstm": (jxl.mlstm_init, jxl.mlstm_state_init,
                    jax.jit(jxl.mlstm_step, static_argnums=1),
                    bridge._mlstm, txl.mlstm_step),
          "slstm": (jxl.slstm_init, jxl.slstm_state_init,
                    jax.jit(jxl.slstm_step, static_argnums=1),
                    bridge._slstm, txl.slstm_step)}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("tokens", [1, 5])
def test_step_matches_reference(kind, name, tokens):
    """Six calls of one layer's step over ``tokens`` tokens from the
    reference's state initialisers (m = -1e9, the sLSTM's n = 1e-6),
    against as many single-token reference steps: each output within the
    tolerance, each state leaf within it relative to its scale (bf16: the
    f32 states at 6e-2, the bound tests/test_torch_hybrid.py puts on bf16
    recurrences)."""
    init, state_init, jstep, to_port, tstep = _STEPS[kind]
    jcfg, _, tcfg, _ = _cfgs(name)
    tree = jax.tree_util.tree_map(np.asarray,
                                  init(jax.random.PRNGKey(3), jcfg))
    layer = to_port(tree, functools.partial(bridge.to_tensor, device="cpu"),
                    ())
    jstate = state_init(jcfg, 3)
    tstate = {k: bridge.to_tensor(np.asarray(v), "cpu")
              for k, v in jstate.items()}
    rng = np.random.default_rng(5)
    for _ in range(6):
        x = rng.standard_normal((3, tokens, jcfg.d_model)).astype(np.float32)
        jx = jnp.asarray(x).astype(jcfg.dtype)
        outs = []
        for t in range(tokens):
            out, jstate = jstep(tree, jcfg, jx[:, t:t + 1], jstate)
            outs.append(out)
        want = jnp.concatenate(outs, axis=1)
        tx = bridge.to_tensor(np.asarray(jx), "cpu")
        got, tstate = tstep(layer, tcfg, tx, tstate)
        assert got.dtype == tx.dtype and got.shape == tx.shape
        np.testing.assert_allclose(_np(got), _np(want), **_tol(name))
        assert sorted(tstate) == sorted(jstate)
        for leaf, w in jstate.items():
            assert tstate[leaf].dtype == torch.float32
            _assert_state_close(_np(tstate[leaf]), _np(w),
                                3e-5 if name == "float32" else 6e-2)


# ------------------------------------------------------------ whole model

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


def _assert_cache_close(got, jc, name):
    np.testing.assert_array_equal(got["pos"], np.asarray(jc["pos"]))
    assert sorted(got) == sorted(jc)
    for leaf in STATE_LEAVES:
        assert got[leaf].shape == jc[leaf].shape, leaf
        _assert_state_close(got[leaf], _np(jc[leaf]),
                            3e-5 if name == "float32" else 6e-2)


def _prompt():
    return np.random.default_rng(9).integers(1, 256, (B, PROMPT)).astype(
        np.int32)


def test_bridge_builds_xlstm_layers(models):
    jcfg, _, params, _, tcfg, _, tparams = models["float32"]
    g = jcfg.n_layers // jcfg.slstm_every
    assert isinstance(tparams, TM.XLSTMModel)
    assert len(tparams.mlstm) == len(tparams.slstm) == g
    assert all(len(grp) == jcfg.slstm_every - 1 for grp in tparams.mlstm)
    np.testing.assert_array_equal(
        tparams.mlstm[1][0].w_qkv.numpy(),
        np.asarray(params["groups"]["mlstm"]["w_qkv"][1, 0]))
    np.testing.assert_array_equal(
        tparams.slstm[1].r_gates.numpy(),
        np.asarray(params["groups"]["slstm"]["r_gates"][1]))
    assert tparams.slstm[0].r_gates.dtype == torch.float32
    assert tparams.mlstm[0][0].w_gates.dtype == torch.float32
    # a model drawn by the port has the same structure and dtypes
    own = TM.init_model(tcfg, seed=1, device="cpu")
    assert [(n, p.shape, p.dtype) for n, p in own.named_parameters()] == [
        (n, p.shape, p.dtype) for n, p in tparams.named_parameters()]
    torch.testing.assert_close(own.mlstm[0][0].gate_bias,
                               tparams.mlstm[0][0].gate_bias)


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
    tokens on: the sinusoidal positions differ) and nonzero states, four
    ticks."""
    jcfg, rc, params, steps, tcfg, trc, tparams = models[name]
    jc = JM.cache_init(jcfg, rc, B, max_seq=MAX_SEQ)
    rng = np.random.default_rng(10)
    with jax.set_mesh(host_mesh):
        _, jc = steps["prefill"](params, tokens=jnp.asarray(_prompt()),
                                 cache=jc)
        jc["pos"] = jc["pos"].at[1].add(5)
        tc = bridge.cache_from_jax(jax.tree_util.tree_map(np.asarray, jc),
                                   device="cpu")
        assert "kv" not in tc
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
    _, _, _, _, tcfg, trc, tparams = models["float32"]
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


# ----------------------------------------------------------- cache layout

def test_cache_layout_matches_reference():
    """Shapes and dtypes equal the reference's; every state starts at the
    engine cache's zeros (not ``mlstm_state_init``'s m = -1e9 or
    ``slstm_state_init``'s n = 1e-6)."""
    jcfg, rc, tcfg, trc = _cfgs("bfloat16")
    jc = JM.cache_init(jcfg, rc, 3, max_seq=MAX_SEQ, as_shape=True)
    tc = TM.cache_init(tcfg, trc, 3, MAX_SEQ, device="cpu")
    assert sorted(tc) == sorted(jc) and "kv" not in tc
    for leaf in STATE_LEAVES:
        assert tuple(tc[leaf].shape) == jc[leaf].shape, leaf
        assert tc[leaf].dtype == torch.float32
        assert float(tc[leaf].abs().max()) == 0.0
    assert tc["pos"].dtype == torch.int32


def _batch_axes(cache_init):
    """Each leaf's batch axis, found as the reference engine finds it
    (``_batch_axes``): the one axis whose size differs between caches of
    2 and 3 slots."""
    a, b = cache_init(2), cache_init(3)
    return {name: next(i for i, (p, q) in enumerate(zip(a[name].shape,
                                                        b[name].shape))
                       if p != q) for name in a}


def test_batch_axes_match_reference():
    jcfg, rc, tcfg, trc = _cfgs("float32")
    want = _batch_axes(lambda n: JM.cache_init(jcfg, rc, n, max_seq=MAX_SEQ,
                                               as_shape=True))
    assert want == _batch_axes(lambda n: TM.cache_init(
        tcfg, trc, n, MAX_SEQ, device="cpu"))
    assert want == {name: TM._BATCH_AXIS[name] for name in want}
    # a slot's view writes through to that slot only
    tc = TM.cache_init(tcfg, trc, 3, MAX_SEQ, device="cpu")
    view = TM.slot_view(tc, 1)
    for leaf in STATE_LEAVES:
        view[leaf].fill_(2.0)
        assert float(tc[leaf].narrow(want[leaf], 1, 1).min()) == 2.0
        assert float(tc[leaf].narrow(want[leaf], 0, 1).abs().max()) == 0.0


def test_init_model_is_seeded():
    cfg = treg.smoke(ARCH)
    a = TM.init_model(cfg, seed=3, device="cpu")
    b = TM.init_model(cfg, seed=3, device="cpu")
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    assert len(a.slstm) == cfg.n_layers // cfg.slstm_every
    assert a.mlstm[0][0].w_qkv.shape == (2 * cfg.d_model, 6 * cfg.d_model)


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


class _AdmittedStates:
    """Records the largest |mC| of a slot's row as each request's first
    prefill chunk starts (wraps the port's ``prefill_step_cached``)."""

    def __init__(self, monkeypatch):
        self.first_chunk = []
        inner = TM.prefill_step_cached

        def recorded(params, cfg, rc, tokens, cache, **kw):
            if int(cache["pos"][0]) == 0:
                self.first_chunk.append(float(cache["mC"].abs().max()))
            return inner(params, cfg, rc, tokens, cache, **kw)
        monkeypatch.setattr(TM, "prefill_step_cached", recorded)


@pytest.fixture(scope="module", params=NAMES)
def engines(request, host_mesh):
    jcfg, rc, tcfg, trc = _cfgs(request.param)
    with jax.set_mesh(host_mesh):
        params = JM.init_model(jax.random.PRNGKey(0), jcfg)
        jeng = JEngine(params, jcfg, rc, **KNOBS)
        jtoks = _drive(jeng, JRequest)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    teng = TEngine(tparams, tcfg, trc, device="cpu", **KNOBS)
    with pytest.MonkeyPatch.context() as mp:
        admitted = _AdmittedStates(mp)
        ttoks = _drive(teng, TRequest)
    return request.param, jeng, jtoks, teng, ttoks, admitted


def test_engine_greedy_tokens_match_reference(engines):
    _, jeng, jtoks, teng, ttoks, _ = engines
    assert len(ttoks) == N_FIRST + N_RESUBMIT
    assert ttoks == jtoks
    assert [r.rid for r in teng.finished] == [r.rid for r in jeng.finished]
    assert not any(r.restored for r in teng.finished)


@pytest.mark.parametrize("key", STATS)
def test_engine_stats_match_reference(engines, key):
    _, jeng, _, teng, _, _ = engines
    assert teng.stats[key] == jeng.stats[key]
    if key in ("flushes", "store_bytes", "prefix_hits"):
        assert teng.stats[key] == 0       # no pages: nothing to flush


def test_engine_tier_trace_matches_reference(engines):
    _, jeng, _, teng, _, _ = engines
    assert teng.tier.snapshot() == jeng.tier.snapshot()
    assert teng.tier.ops == jeng.tier.ops
    assert teng.tier.op_ns == jeng.tier.op_ns
    assert not teng.store.pages and not teng.flusher.pending


@pytest.mark.parametrize("leaf", [*STATE_LEAVES, "pos"])
def test_engine_cache_matches_reference(engines, leaf):
    name, jeng, _, teng, _, _ = engines
    if leaf == "pos":
        np.testing.assert_array_equal(teng.cache["pos"].numpy(),
                                      np.asarray(jeng.cache["pos"]))
        return
    _assert_state_close(_np(teng.cache[leaf]), _np(jeng.cache[leaf]),
                        3e-5 if name == "float32" else 6e-2)


def test_engine_states_not_reset_at_admission(engines):
    """The reference's engine copies: a request admitted into a slot that
    served before starts its scan from the state left there (the first
    four requests start from the cache's zeros, the later ones on used
    slots); the greedy tokens above equal the reference's only so."""
    _, _, _, _, _, admitted = engines
    states = admitted.first_chunk
    assert len(states) == N_FIRST + N_RESUBMIT
    assert states[:KNOBS["n_slots"]] == [0.0] * KNOBS["n_slots"]
    assert min(states[KNOBS["n_slots"]:]) > 0.0
