"""The HOST tier (``core.hdm`` with ``enable_host_tier``) against the
reference and against the port's DEVICE tier, on the CPU.

On the CPU the host is the device: the HOST tier's leaves live in host
arenas (``hdm.host_empty``), every read "copies" them with a clone and
AdamW streams m, v and the master through its two buffers piece by
piece, so the code paths of the card run, copies aside. The reference
runs at the same ``param_tier`` / ``optimizer_tier`` (its HOST without
the ``pinned_host`` memory kind, which XLA:CPU cannot place: POOL's
sharding). Held, on smoke qwen3-1.7b in f32 (``tests/test_kernel_parity.
py``'s 3e-5, leaf by leaf):

 * the specs and ``bytes_per_device`` of HOST equal the reference's;
 * one training step at (host, host), (device, host) and (pool, host):
   the loss and each gradient leaf against the reference's, the AdamW
   step by ``tests/test_torch_dp_train.py``'s rule, and the whole step
   bit for bit the port's DEVICE step (pieces of 4 KiB, so every leaf but
   the norms streams in several);
 * the order in which the stream issues and waits for its copies, at SR
   depth 0, 1 and 2, in the forward pass and in the backward pass's
   recompute, with at most depth + 1 layers in flight;
 * a decode step's logits against the reference's at ``param_tier=
   "host"`` and an engine run's tokens, stats and tier trace against the
   port's DEVICE engine;
 * a checkpoint's restore into the HOST state in place;
 * int8 error feedback with its residuals on the HOST tier: each leaf's
   residual written back in place, the codes and residuals bit for bit
   those of residuals on the device, on one rank and on FSDP shards;
 * the refusal of DEVICE beside HOST on a data axis of two ranks.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import MeshConfig, RunConfig, SHAPES
from repro.core import hdm as jhdm
from repro.core import deterministic_store as jds
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.parallel import sharding as jsh
from repro_torch import bridge
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MeshConfig as TMeshConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.core import hdm as thdm
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tcomp
from repro_torch.parallel import sharding as tsh
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.engine import Request, ServingEngine

ARCH = "qwen3-1.7b"
F32 = dict(atol=3e-5, rtol=3e-5)
LR = 1e-2
PAIRS = [("host", "host"), ("device", "host"), ("pool", "host")]
B, S = 2, 16


def _cfgs():
    return (dataclasses.replace(jreg.smoke(ARCH), dtype="float32"),
            dataclasses.replace(treg.smoke(ARCH), dtype="float32"))


def _trc(tcfg, pair=("device", "device"), depth=1, shape="train_4k"):
    return TRunConfig(model=tcfg, shape=TSHAPES[shape], mesh=TMeshConfig(),
                      param_tier=pair[0], optimizer_tier=pair[1],
                      enable_host_tier="host" in pair,
                      sr_prefetch_depth=depth)


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    params = JM.init_model(jax.random.PRNGKey(0), jcfg)
    return jax.tree_util.tree_map(np.asarray, params)


def _batch():
    rng = np.random.default_rng(3)
    return {k: rng.integers(0, 256, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def _tbatch():
    return {k: torch.from_numpy(v) for k, v in _batch().items()}


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


def test_specs_and_bytes_match_reference(weights):
    """HOST's specs are the reference's for ``tier="host"`` (POOL's), and
    so are its bytes a rank on a data axis of 2 and on one device."""
    jcfg, tcfg = _cfgs()
    tparams = bridge.params_from_jax(weights, tcfg, device="cpu")
    shapes = jax.eval_shape(lambda: JM.init_model(jax.random.PRNGKey(0),
                                                  jcfg))
    got = thdm.HDMStore(tier=thdm.HOST).specs(tparams)
    assert got == thdm.HDMStore(tier=thdm.POOL).specs(tparams)
    for name, spec in got.items():
        path, n_idx = tsh.ref_path(name)
        want = jhdm.HDMStore(mesh=None, tier="host").specs(shapes)
        for part in path.split("/"):
            want = want[part]
        assert spec == tuple(want)[n_idx:], name
    for shape in ((2, 1), (1, 1)):
        jmesh = types.SimpleNamespace(devices=np.empty(shape),
                                      axis_names=("data", "model"))
        want = jhdm.bytes_per_device(shapes, jhdm.HDMStore(jmesh,
                                                           tier="host"))
        tmesh = types.SimpleNamespace(shape=(1,) + shape)
        for host in (False, True):
            store = thdm.HDMStore(tmesh, tier=thdm.HOST,
                                  enable_host_tier=host)
            assert thdm.bytes_per_device(tparams, store) == want


@pytest.fixture(scope="module")
def reference_steps(weights, host_mesh):
    """The reference's loss, gradients and one train step at each pair:
    run once for each ``param_tier`` among them, the one tier its step
    reads (its ``optimizer_tier`` only places the state, through
    ``state_specs``, on a mesh of one device here); POOL and HOST give
    it the same specs."""
    jcfg, _ = _cfgs()
    opt_cfg = jadamw.AdamWConfig(learning_rate=LR, warmup_steps=0)
    b = {k: jnp.asarray(v) for k, v in _batch().items()}
    out = {}
    with jax.set_mesh(host_mesh):
        params = jax.tree_util.tree_map(jnp.asarray, weights)
        for pair in PAIRS:
            same = next((q for q in out if q[0] == pair[0]), None)
            if same is not None:
                out[pair] = out[same]
                continue
            rc = RunConfig(model=jcfg, shape=SHAPES["train_4k"],
                           mesh=MeshConfig(), param_tier=pair[0],
                           optimizer_tier=pair[1])
            specs = jsh.param_specs(jax.eval_shape(lambda: params),
                                    tier=rc.param_tier)

            def run(p, batch, rc=rc, specs=specs):
                # the body of its build_train_step at one microbatch
                loss, g = jax.value_and_grad(lambda q: JM.loss_fn(
                    q, jcfg, rc, batch, specs))(p)
                new_p, opt, _ = jadamw.update(
                    jds.apply_ds(g, specs, rc.ds_enabled),
                    jadamw.init(p, opt_cfg), p, opt_cfg)
                return loss, g, new_p, opt
            loss, grads, new_p, opt = jax.jit(run)(params, b)
            out[pair] = {"loss": float(loss), "g": _leaves(grads),
                         "p": _leaves(new_p), "m": _leaves(opt.m),
                         "v": _leaves(opt.v), "master": _leaves(opt.master)}
    return out


def _port_step(weights, pair, monkeypatch):
    """The port's loss, gradients and one step at ``pair`` from the
    reference's weights: (loss, grads, the new state, the state's
    whole model)."""
    _, tcfg = _cfgs()
    rc = _trc(tcfg, pair)
    opt_cfg = tadamw.AdamWConfig(learning_rate=LR, warmup_steps=0)
    monkeypatch.setattr(tadamw, "CHUNK_BYTES", 4096)
    state = tsteps.init_state(bridge.params_from_jax(weights, tcfg,
                                                     device="cpu"),
                              rc, opt_cfg)
    loss, grads = tsteps.loss_and_grads(state.params, tcfg, rc, _tbatch())
    state, _ = tsteps.build_train_step(tcfg, rc, opt_cfg)(state, _tbatch())
    return float(loss), grads, state


@pytest.mark.parametrize("pair", PAIRS, ids="-".join)
def test_train_step_matches_reference_and_device(weights, reference_steps,
                                                 pair, monkeypatch):
    """One step at ``pair``: the loss and each gradient leaf within 3e-5
    of the reference's; the step's m, v, masters and parameters by
    ``tests/test_torch_dp_train.py``'s rule; the whole step (loss,
    gradients, parameters, m, v, masters) bit for bit the port's DEVICE
    step from the same weights; the state where its tiers put it."""
    _, tcfg = _cfgs()
    want = reference_steps[pair]
    loss, grads, state = _port_step(weights, pair, monkeypatch)
    on_host = {"params": pair[0] == "host", "m": True, "v": True,
               "master": True}
    parts = {"params": list(state.params.parameters()), "m": state.opt.m,
             "v": state.opt.v, "master": state.opt.master}
    for key, tensors in parts.items():
        for t in tensors:
            assert (thdm.host_target(t) is not None) == on_host[key], key
    np.testing.assert_allclose(loss, want["loss"], **F32)

    def tree(tensors):
        return _leaves(bridge.params_to_numpy(state.params, tcfg,
                                              [t.detach() for t in tensors]))
    for got, ref in zip(tree(grads), want["g"]):
        np.testing.assert_allclose(got, ref, **F32)
    p0 = _leaves(weights)
    b1, b2 = tadamw.AdamWConfig.b1, tadamw.AdamWConfig.b2
    for got_p, got_mp, got_m, got_v, g, i in zip(
            tree(parts["params"]), tree(parts["master"]), tree(parts["m"]),
            tree(parts["v"]), want["g"], range(len(p0))):
        np.testing.assert_allclose(got_mp, want["master"][i], atol=2 * LR,
                                   rtol=0)
        np.testing.assert_allclose(got_p, want["p"][i], atol=2 * LR, rtol=0)
        err = F32["atol"] + F32["rtol"] * np.abs(g)
        assert np.all(np.abs(got_m - want["m"][i]) <= (1 - b1) * err
                      + 1e-6 * np.abs(want["m"][i]))
        assert np.all(np.abs(got_v - want["v"][i]) <= (1 - b2) * err * (
            2 * np.abs(g) + err) + 1e-6 * np.abs(want["v"][i]))
        sure = np.abs(g) > 3e-5 * max(1.0, np.abs(g).max())
        moved = np.abs(np.abs(got_mp - p0[i])[sure] - LR)
        assert moved.max(initial=0.0) <= LR / 2
    # the port's DEVICE step, from the same weights
    dloss, dgrads, dstate = _port_step(weights, ("device", "device"),
                                       monkeypatch)
    assert dloss == loss
    for a, b in zip(grads, dgrads):
        assert torch.equal(a, b)
    dparts = {"params": list(dstate.params.parameters()), "m": dstate.opt.m,
              "v": dstate.opt.v, "master": dstate.opt.master}
    for key in parts:
        for a, b in zip(parts[key], dparts[key]):
            assert torch.equal(a.detach(), b.detach()), key


def _expected_order(n, depth):
    """The stream's (event, layer) sequence: forward, then backward."""
    fwd, back = [], []
    if depth == 0:
        for i in range(n):
            fwd += [("issue", i), ("wait", i)]
        for i in reversed(range(n)):
            back += [("issue", i), ("wait", i)]
        return fwd + back
    fwd = [("issue", i) for i in range(min(n, depth + 1))]
    for i in range(n):
        fwd.append(("wait", i))
        if i + depth + 1 < n:
            fwd.append(("issue", i + depth + 1))
    issued = set()
    for i in reversed(range(n)):
        for j in range(i, i - depth - 1, -1):
            if j >= 0 and j not in issued:
                issued.add(j)
                back.append(("issue", j))
        back.append(("wait", i))
    return fwd + back


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_stream_issues_copies_ahead(weights, depth):
    """The HOST stream's copies in training, recorded by ``sharding.
    HOST_TRACE``: in the forward pass layer i + depth's is issued before
    layer i's body waits for its own; in the backward pass layer i -
    depth's when layer i's backward begins, before its recompute waits;
    at depth 0 each in line. The leaves outside the stream are read once,
    first. At no point are more than depth + 1 layers in flight."""
    _, tcfg = _cfgs()
    rc = _trc(tcfg, ("host", "host"), depth)
    opt_cfg = tadamw.AdamWConfig(learning_rate=LR, warmup_steps=0)
    state = tsteps.init_state(bridge.params_from_jax(weights, tcfg,
                                                     device="cpu"),
                              rc, opt_cfg)
    tsh.HOST_TRACE = []
    try:
        tsteps.loss_and_grads(state.params, tcfg, rc, _tbatch())
        trace = tsh.HOST_TRACE
    finally:
        tsh.HOST_TRACE = None
    assert trace[:2] == [("issue", None), ("wait", None)]
    layers = [e for e in trace if isinstance(e[1], int)]
    assert len(layers) == len(trace) - 2
    assert layers == _expected_order(tcfg.n_layers, depth)
    live = 0
    for event, _ in layers:
        live += 1 if event == "issue" else -1
        assert 0 <= live <= depth + 1


def test_decode_and_engine_with_host_weights(weights, host_mesh):
    """A decode step from the HOST tier: logits within 3e-5 of the
    reference's at ``param_tier="host"``; an engine run with its weights
    on the HOST tier (every leaf in host arenas, the prefetch kept):
    tokens, stats and the tier's ops and op_ns equal the port's DEVICE
    engine's on the same traffic."""
    jcfg, tcfg = _cfgs()
    rc = RunConfig(model=jcfg, shape=SHAPES["decode_32k"], mesh=MeshConfig(),
                   kv_page_size=8, param_tier="host")
    trc = dataclasses.replace(_trc(tcfg, ("host", "host"),
                                   shape="decode_32k"), kv_page_size=8)
    toks = np.random.default_rng(4).integers(1, 256, (B, 5)).astype(
        np.int32)
    with jax.set_mesh(host_mesh):
        params = jax.tree_util.tree_map(jnp.asarray, weights)
        specs = jsh.param_specs(jax.eval_shape(lambda: params), tier="host")
        jc = JM.cache_init(jcfg, rc, B, max_seq=32)
        _, jc = JM.prefill_step_cached(params, cfg=jcfg, rc=rc,
                                       tokens=jnp.asarray(toks), cache=jc,
                                       param_specs=specs)
        jl, _ = JM.decode_step(params, cfg=jcfg, rc=rc,
                               tokens=jnp.asarray(toks[:, -1:]), cache=jc,
                               param_specs=specs)
    host = thdm.HDMStore(tier=thdm.HOST, enable_host_tier=True).place(
        bridge.params_from_jax(weights, tcfg, device="cpu"))
    tc = TM.cache_init(tcfg, trc, B, 32, device="cpu")
    TM.prefill_step_cached(host, tcfg, trc, torch.from_numpy(toks), tc)
    tl, _ = TM.decode_step(host, tcfg, trc, torch.from_numpy(toks[:, -1:]),
                           tc)
    np.testing.assert_allclose(bridge.to_numpy(tl), np.asarray(jl), **F32)

    prompts = [np.random.default_rng(5 + i).integers(1, 256, n).tolist()
               for i, n in enumerate((9, 21, 14))]
    runs = {}
    for pair in (("device", "device"), ("host", "host")):
        engine = ServingEngine(
            bridge.params_from_jax(weights, tcfg, device="cpu"), tcfg,
            _trc(tcfg, pair, shape="decode_32k"),
            config=ServeConfig(n_slots=2, max_seq=64, prefill_chunk=8,
                               tier_topology=("dram", "ssd-fast"), seed=0),
            device="cpu")
        hs = [engine.submit(Request(rid=i, prompt=p, max_new_tokens=5))
              for i, p in enumerate(prompts)]
        engine.run(max_ticks=500)
        hs += [engine.submit(Request(rid=10, prompt=prompts[0],
                                     max_new_tokens=5))]
        engine.run(max_ticks=500)
        stats = {k: v for k, v in engine.stats.items()
                 if k != "prefill_time_s"}
        runs[pair] = ([h.result() for h in hs], stats, engine.tier.ops,
                      engine.tier.op_ns, engine)
    (want, *_), (got, *_) = runs.values()
    assert got == want and hs[-1].request.restored
    for i in (1, 2, 3):
        assert list(runs.values())[1][i] == list(runs.values())[0][i]
    engine = runs["host", "host"][4]
    assert engine._hot_rc.sr_prefetch_depth == 1
    assert all(thdm.host_target(p) is not None
               for p in engine.params.parameters())


def test_checkpoint_restores_host_leaves_in_place(weights, tmp_path):
    """``launch.train``'s checkpoint of a HOST state, restored to host
    memory and loaded into another HOST state: the same tensors (host
    arenas, in place) now holding the saved values bit for bit; and the
    train driver's resume at the HOST tier keeps every leaf there."""
    _, tcfg = _cfgs()
    rc = _trc(tcfg, ("host", "host"))
    opt_cfg = tadamw.AdamWConfig(learning_rate=LR, warmup_steps=0)

    def fresh():
        return tsteps.init_state(bridge.params_from_jax(
            weights, tcfg, device="cpu"), rc, opt_cfg)
    state, _ = tsteps.build_train_step(tcfg, rc, opt_cfg)(fresh(), _tbatch())
    ck = Checkpointer(str(tmp_path))
    ck.save(1, ttrain.state_dict(state), blocking=True)
    other = fresh()
    before = {k: (t, t.data_ptr()) for k, t in
              ttrain.state_dict(other).items() if k != "opt/step"}
    _, flat, _ = ck.restore(device="cpu")
    other = ttrain.load_state_dict(other, flat)
    saved = ttrain.state_dict(state)
    after = ttrain.state_dict(other)
    for k, (t, ptr) in before.items():
        assert after[k].data_ptr() == ptr, k
        assert thdm.host_target(after[k]) is not None or k.startswith(
            "params/"), k
        assert torch.equal(after[k], saved[k]), k
    assert all(thdm.host_target(p) is not None
               for p in other.params.parameters())
    assert int(other.opt.step) == int(state.opt.step) == 1
    # the train driver at the HOST tier: its resume restores to host
    # memory and loads into the HOST state in place
    kw = dict(smoke=True, seq_len=16, global_batch=2, device="cpu",
              ckpt_dir=str(tmp_path / "driver"), param_tier="host",
              optimizer_tier="host", enable_host_tier=True)
    ttrain.train(ARCH, steps=1, **kw)
    run = ttrain.train(ARCH, steps=1, resume=True, **kw)
    st = run["state"]
    assert all(thdm.host_target(t) is not None for t in (
        *st.params.parameters(), *st.opt.m, *st.opt.v, *st.opt.master))


class _HalfOfTwo:
    """Rank 0 of two whose peer's block maxima are its own."""
    rank, size = 0, 2

    @staticmethod
    def all_reduce(t, op):
        assert op == "max"
        return t.clone()


@pytest.mark.parametrize("sharded", [False, True], ids=["one-rank",
                                                         "shards"])
def test_int8_ef_keeps_host_residuals_in_place(sharded):
    """``compress_grads`` with residuals on the HOST tier (host arenas):
    the same gradients and residuals, bit for bit, as with residuals on
    the device, each new residual written into its HOST tensor in place;
    on one rank and on FSDP shards (whose residuals are read twice)."""
    rng = np.random.default_rng(6)
    shapes = [(4, 96), (6, 40), (3,)]
    grads = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             .to(torch.bfloat16) for s in shapes]
    plain = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             * 0.01 for s in shapes]
    host = thdm.host_like(plain, "cpu", torch.float32)
    for h, r in zip(host, plain):
        h.copy_(r)
    kw = {}
    if sharded:
        kw = dict(group=_HalfOfTwo(), layouts=[((8, 96), 0), ((6, 80), 1),
                                               None])
    want_g, want_r = tcomp.compress_grads(grads, plain, **kw)
    got_g, got_r = tcomp.compress_grads(grads, host, **kw)
    for g, w in zip(got_g, want_g):
        assert torch.equal(g, w)
    for r, h, w in zip(got_r, host, want_r):
        assert r is h and thdm.host_target(r) is not None
        assert torch.equal(r, w)


def test_int8_ef_step_on_host_equals_device(weights):
    """A training step with int8 error feedback at (host, host): its
    residuals stay on the HOST tier, and the step's parameters,
    residuals and masters equal the DEVICE step's bit for bit."""
    _, tcfg = _cfgs()
    opt_cfg = tadamw.AdamWConfig(learning_rate=LR, warmup_steps=0)
    out, held = {}, {}
    for pair in (("host", "host"), ("device", "device")):
        rc = dataclasses.replace(_trc(tcfg, pair), grad_compression="int8_ef")
        state = tsteps.init_state(bridge.params_from_jax(
            weights, tcfg, device="cpu"), rc, opt_cfg)
        held[pair] = list(state.residuals)
        state, _ = tsteps.build_train_step(tcfg, rc, opt_cfg)(state,
                                                              _tbatch())
        out[pair] = state
    host, dev = out.values()
    assert all(r is h and thdm.host_target(r) is not None
               for r, h in zip(host.residuals, held["host", "host"]))
    for a, b in zip([*host.params.parameters(), *host.residuals,
                     *host.opt.master],
                    [*dev.params.parameters(), *dev.residuals,
                     *dev.opt.master]):
        assert torch.equal(a.detach(), b.detach())


def test_device_beside_host_on_a_data_axis_raises():
    """DEVICE beside HOST shards the data axis apart, either way round:
    it trains at (2, 1) and on one rank, the state taking the optimizer
    tier's placement (``steps.state_moves``: the state's FSDP slice of a
    DEVICE weight, or a HOST weight's state whole; the step at (2, 1),
    bit for bit its POOL twin: ``test_torch_tp_train.py``)."""
    _, tcfg = _cfgs()
    for pair in (("device", "host"), ("host", "device")):
        rc = _trc(tcfg, pair)
        TM.check_trainable(tcfg, (2, 1))
        tsteps.build_train_step(tcfg, rc, tadamw.AdamWConfig())
