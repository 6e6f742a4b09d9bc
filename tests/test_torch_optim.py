"""The port's optimizer and gradient compression against the reference.

``adamw.update`` / ``schedule`` / ``clip_by_global_norm`` on identical
inputs (three steps, bf16 and f32 parameters, the state carried across by
``bridge.adamw_state_from_jax``), the int8 error-feedback codes, scales
and residuals bit for bit, the reference's own optimizer and compression
cases (``tests/test_substrate.py:19-83``, ``tests/test_checkpoint.py:
86-131``) on the port, and the whole ``build_train_step`` (microbatches 1
and 2, with and without int8 error feedback) on smoke qwen3-1.7b in f32.

Tolerances. ``update`` fed identical gradients: 1e-6 relative (the two
libraries' ``pow``, ``cos`` and ``sqrt`` may part in the last bit). The
whole step: the loss at 3e-5; the gradients within 3e-5 of the global
norm; the f32 masters within ``2 * lr``: at step 1 the update is about
``lr * sign(g)``, and the sign of a near-zero gradient may flip between
the two libraries' roundings.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import torch

from repro.configs import registry as jreg
from repro.configs.base import MeshConfig, RunConfig, SHAPES
from repro.launch import steps as jsteps
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.parallel import sharding as shlib
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MeshConfig as TMeshConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.launch import steps as tsteps
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tcomp

TIGHT = dict(atol=1e-7, rtol=1e-6)


def _leaves(seed=0):
    """A bf16 matrix, an f32 matrix and an f32 vector (a ragged block)."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((16, 24)).astype(np.float32) * 0.1,
            rng.standard_normal((8, 40)).astype(np.float32) * 0.1,
            rng.standard_normal((300,)).astype(np.float32) * 0.1]


DTYPES = ["bfloat16", "float32", "float32"]


def _t(arr, dtype="float32"):
    return torch.from_numpy(np.asarray(arr, np.float32)).to(
        getattr(torch, dtype))


def _j(arr, dtype="float32"):
    return jnp.asarray(arr, dtype)


# ----------------------------------------------------------------- adamw


@pytest.mark.parametrize("use_master", [True, False])
def test_adamw_update_matches_reference(use_master):
    """Three steps of ``update`` on identical gradients, from a state the
    bridge carries across: parameters, moments, masters, the norm and the
    learning rate equal within 1e-6 relative (clipping active at step 2)."""
    cfg = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10,
               use_master=use_master)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
    leaves = _leaves()
    jp = {str(i): _j(a, d) for i, (a, d) in enumerate(zip(leaves, DTYPES))}
    tp = [_t(a, d) for a, d in zip(leaves, DTYPES)]
    jstate = jadamw.init(jp, jcfg)
    tstate = tadamw.init(tp, tcfg)
    rng = np.random.default_rng(1)
    for step in range(3):
        gs = [rng.standard_normal(a.shape).astype(np.float32)
              * (30.0 if step == 1 else 0.05) for a in leaves]
        jg = {str(i): _j(g, d) for i, (g, d) in enumerate(zip(gs, DTYPES))}
        tg = [_t(g, d) for g, d in zip(gs, DTYPES)]
        jp, jstate, jm = jadamw.update(jg, jstate, jp, jcfg)
        tp, tstate, tm = tadamw.update(tg, tstate, tp, tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        assert int(tstate.step) == int(jstate.step) == step + 1
        for i, d in enumerate(DTYPES):
            k = str(i)
            assert tp[i].dtype == getattr(torch, d)
            np.testing.assert_allclose(bridge.to_numpy(tp[i]),
                                       np.asarray(jp[k], np.float32),
                                       atol=1e-3 if d == "bfloat16" else
                                       1e-7, rtol=1e-6)
            for tt, jt in ((tstate.m, jstate.m), (tstate.v, jstate.v)):
                np.testing.assert_allclose(tt[i].numpy(), np.asarray(jt[k]),
                                           **TIGHT)
            if use_master:
                np.testing.assert_allclose(tstate.master[i].numpy(),
                                           np.asarray(jstate.master[k]),
                                           **TIGHT)
    if not use_master:
        assert tstate.master is None and jstate.master is None


def test_schedule_matches_reference():
    cfg = dict(learning_rate=3e-4, warmup_steps=10, total_steps=100,
               min_lr_ratio=0.1)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(
            float(tadamw.schedule(torch.tensor(s, dtype=torch.int32), tcfg)),
            float(jadamw.schedule(jnp.int32(s), jcfg)), rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    leaves = _leaves(2)
    jg = {str(i): _j(a, d) for i, (a, d) in enumerate(zip(leaves, DTYPES))}
    tg = [_t(a, d) for a, d in zip(leaves, DTYPES)]
    jc, jn = jadamw.clip_by_global_norm(jg, max_norm)
    tc, tn = tadamw.clip_by_global_norm(tg, max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(tadamw.global_norm(tc)),
                               float(jadamw.global_norm(jc)), rtol=1e-6)
    for i, d in enumerate(DTYPES):
        assert tc[i].dtype == getattr(torch, d)
        np.testing.assert_allclose(bridge.to_numpy(tc[i]),
                                   np.asarray(jc[str(i)], np.float32),
                                   rtol=1e-6 if d == "float32" else 1e-2,
                                   atol=1e-7)


# the reference's optimizer cases (tests/test_substrate.py:19-49)


def test_adamw_converges_quadratic():
    params = [torch.tensor([3.0, -2.0])]
    cfg = tadamw.AdamWConfig(learning_rate=0.1, weight_decay=0.0,
                             warmup_steps=0, total_steps=200)
    state = tadamw.init(params, cfg)
    for _ in range(150):
        params, state, _ = tadamw.update([2 * params[0]], state, params, cfg)
    assert float(params[0].abs().max()) < 0.05


def test_grad_clip():
    clipped, norm = tadamw.clip_by_global_norm([torch.full((4,), 100.0)],
                                               1.0)
    assert abs(float(tadamw.global_norm(clipped)) - 1.0) < 1e-5
    assert float(norm) > 100


def test_schedule_warmup_and_decay():
    cfg = tadamw.AdamWConfig(learning_rate=1.0, warmup_steps=10,
                             total_steps=100, min_lr_ratio=0.1)

    def lr(s):
        return float(tadamw.schedule(torch.tensor(s, dtype=torch.int32),
                                     cfg))
    assert lr(1) < lr(10)
    assert abs(lr(10) - 1.0) < 1e-5
    assert abs(lr(100) - 0.1) < 1e-3


# ------------------------------------------------------------ compression


@pytest.mark.parametrize("shape,scale", [((5, 300), 1.0), ((256,), 1e-3),
                                         ((3, 7, 11), 40.0), ((1,), 0.0)])
def test_int8_codes_scales_and_residuals_bit_for_bit(shape, scale):
    """``_quantize`` codes and scales, the round trip, and
    ``compress_leaf``'s gradient and residual equal the reference's bit for
    bit (f32 division, half-to-even rounding, the same clip)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x.reshape(-1)[:4] = [0.5, -0.5, 1.5, 2.5] if x.size >= 4 else 0.5
    r = (rng.standard_normal(shape) * scale * 0.01).astype(np.float32)
    tq, ts = tcomp._quantize(torch.from_numpy(x))
    jq, js = jcomp._quantize(jnp.asarray(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tcomp._dequantize(tq, ts, shape, torch.float32).numpy(),
        np.asarray(jcomp._dequantize(jq, js, shape, jnp.float32)))
    tg, tr = tcomp.compress_leaf(torch.from_numpy(x), torch.from_numpy(r))
    jg, jr = jcomp.compress_leaf(jnp.asarray(x), jnp.asarray(r))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_compress_grads_bf16_matches_reference():
    rng = np.random.default_rng(4)
    gs = [rng.standard_normal((3, 256)).astype(np.float32),
          rng.standard_normal((130,)).astype(np.float32)]
    tg = [_t(g, "bfloat16") for g in gs]
    jg = [_j(g, "bfloat16") for g in gs]
    tout, tres = tcomp.compress_grads(tg, tcomp.init_residuals(tg))
    jout, jres = jcomp.compress_grads(jg, jcomp.init_residuals(jg))
    for a, b in zip(tout, jout):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(bridge.to_numpy(a),
                                      np.asarray(b, np.float32))
    for a, b in zip(tres, jres):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# the reference's compression cases (tests/test_substrate.py:52-83 and
# tests/test_checkpoint.py:86-131)


@given(st.integers(0, 10_000))
@settings(max_examples=20, deadline=None)
def test_int8_ef_error_feedback_residual(seed):
    """deq + new_residual == g + old_residual (error feedback conserves
    mass)."""
    gen = torch.Generator().manual_seed(seed)
    g = torch.randn((300,), generator=gen) * 0.1
    r = torch.randn((300,), generator=gen) * 0.01
    deq, r2 = tcomp.compress_leaf(g, r)
    torch.testing.assert_close(deq + r2, g + r, atol=1e-6, rtol=1e-5)


def test_int8_ef_converges_over_steps():
    g = torch.linspace(-0.3, 0.4, 128)
    r = torch.zeros_like(g)
    sent = torch.zeros_like(g)
    for _ in range(50):
        deq, r = tcomp.compress_leaf(g, r)
        sent += deq
    torch.testing.assert_close(sent / 50, g, atol=5e-3, rtol=0)


def test_quantize_dequantize_exact_on_grid():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.integers(-127, 128, size=(7, 64)) * 0.037
                          ).astype(np.float32))
    q, s = tcomp._quantize(x)
    torch.testing.assert_close(tcomp._dequantize(q, s, x.shape,
                                                 torch.float32), x,
                               rtol=1e-6, atol=1e-7)


def test_error_feedback_identity():
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.standard_normal((5, 300)).astype(np.float32))
    res = torch.from_numpy((rng.standard_normal((5, 300)) * 0.01
                            ).astype(np.float32))
    deq, new_res = tcomp.compress_leaf(g, res)
    torch.testing.assert_close(deq + new_res, g + res, rtol=1e-6, atol=1e-6)
    step = float((g + res).abs().max()) / 127.0
    assert float(new_res.abs().max()) <= step


def test_compress_grads_listwise_and_residual_init():
    params = [torch.ones((3, 256)), torch.ones((130,))]
    res = tcomp.init_residuals(params)
    assert all(float(r.abs().max()) == 0.0 for r in res)
    grads = [p * 0.5 for p in params]
    out, new_res = tcomp.compress_grads(grads, res)
    assert len(out) == len(new_res) == len(grads)
    for g, o in zip(grads, out):
        torch.testing.assert_close(o, g, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("shapes,want", [
    ([(256,), (300,)], (256 + 4 * 1) + (300 + 4 * 2)),
    ([(1024, 1024)], 1024 * 1024 + 4 * 4096),
])
def test_compressed_bytes_formula(shapes, want):
    ts = [torch.zeros(s) for s in shapes]
    assert tcomp.compressed_bytes(ts) == want
    assert tcomp.compressed_bytes(ts) == jcomp.compressed_bytes(
        [jnp.zeros(s) for s in shapes])
    assert tcomp.compressed_bytes(ts) < 0.3 * sum(t.numel() * 4 for t in ts)


# ------------------------------------------------------- the whole step


@pytest.fixture(scope="module")
def dense(host_mesh):
    cfg = jreg.smoke("qwen3-1.7b")
    with jax.set_mesh(host_mesh):
        params = JM.init_model(jax.random.PRNGKey(0),
                               dataclasses.replace(cfg, dtype="float32"))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("compression", ["none", "int8_ef"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(host_mesh, dense, microbatches,
                                      compression):
    """One ``build_train_step`` step from the same weights and batch:
    loss, the gradients (relative to the global norm), the AdamW moments
    and the f32 masters against the reference's, at the tolerances of the
    module docstring; with int8 error feedback a code may round the other
    way, so the first moments and the residuals may part by one
    quantization step of the largest gradient block (times 1 - b1 for the
    moments)."""
    over = dict(microbatches=microbatches, grad_compression=compression)
    jcfg = dataclasses.replace(jreg.smoke("qwen3-1.7b"), dtype="float32")
    tcfg = dataclasses.replace(treg.smoke("qwen3-1.7b"), dtype="float32")
    # the reference's layer scan at SR depth 0 (in training its depth only
    # unrolls the scan: the same values, half the program to compile)
    rc = RunConfig(model=jcfg, shape=SHAPES["train_4k"], mesh=MeshConfig(),
                   sr_prefetch_depth=0, **over)
    trc = TRunConfig(model=tcfg, shape=TSHAPES["train_4k"],
                     mesh=TMeshConfig(), **over)
    jopt_cfg, topt_cfg = jadamw.AdamWConfig(), tadamw.AdamWConfig()
    lr = float(jadamw.schedule(jnp.int32(1), jopt_cfg))
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
    with jax.set_mesh(host_mesh):
        params = jax.tree_util.tree_map(jnp.asarray, dense)
        opt = jadamw.init(params, jopt_cfg)
        res = (jcomp.init_residuals(params) if compression == "int8_ef"
               else None)
        state, jm = jax.jit(jsteps.build_train_step(jcfg, rc, jopt_cfg))(
            jsteps.TrainState(params, opt, res),
            {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
        specs = shlib.param_specs(jax.eval_shape(lambda: params))
        _, jg = jax.value_and_grad(lambda p: JM.loss_fn(
            p, jcfg, dataclasses.replace(rc, microbatches=1),
            {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            specs))(params)
    tparams = bridge.params_from_jax(dense, tcfg, device="cpu")
    tstate = tsteps.init_state(tparams, trc, topt_cfg)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    _, tg = tsteps.loss_and_grads(tparams, tcfg,
                                  dataclasses.replace(trc, microbatches=1),
                                  batch)
    tstate, tm = tsteps.build_train_step(tcfg, trc, topt_cfg)(tstate, batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(float(tm["lr"]), lr, rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=3e-5)
    jg_flat = jax.tree_util.tree_leaves(jg)
    gnorm = float(jadamw.global_norm(jg))
    got = jax.tree_util.tree_leaves(bridge.params_to_numpy(tparams, tcfg,
                                                           tg))
    for a, b in zip(got, jg_flat):
        assert np.abs(a - np.asarray(b)).max() <= 3e-5 * gnorm
    masters = jax.tree_util.tree_leaves(bridge.params_to_numpy(
        tparams, tcfg, tstate.opt.master))
    for a, b in zip(masters, jax.tree_util.tree_leaves(state.opt.master)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2 * lr, rtol=0)
    for a, b in zip(jax.tree_util.tree_leaves(bridge.params_to_numpy(
            tparams, tcfg)), jax.tree_util.tree_leaves(state.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2 * lr, rtol=0)
    # m = (1 - b1) g: the gradients' bound, plus one int8 step where a
    # code rounds the other way
    one_step = (max(np.abs(np.asarray(g)).max() for g in jg_flat) / 127.0
                if compression == "int8_ef" else 0.0)
    m = jax.tree_util.tree_leaves(bridge.params_to_numpy(
        tparams, tcfg, tstate.opt.m))
    for a, b in zip(m, jax.tree_util.tree_leaves(state.opt.m)):
        assert np.abs(a - np.asarray(b)).max() <= 0.1 * (
            3e-5 * gnorm + one_step)
    # the masters were written: at step 1 the update is lr (g / (|g| + eps)
    # + wd p), so wherever the gradient's sign is sure (clear of both
    # libraries' difference and of an int8 code of zero) a master moved
    # by lr within wd |p| (< lr / 2 here)
    clear = 3e-5 * gnorm + one_step
    n_moved = 0
    for a, p0, g in zip(masters, jax.tree_util.tree_leaves(dense), got):
        sure = np.abs(g) > clear
        assert np.abs(np.abs(a - p0)[sure] - lr).max(initial=0.0) <= lr / 2
        n_moved += int(sure.sum())
    assert n_moved > 0
    assert int(tstate.opt.step) == int(state.opt.step) == 1
    if compression == "int8_ef":
        res = jax.tree_util.tree_leaves(bridge.params_to_numpy(
            tparams, tcfg, tstate.residuals))
        for a, b in zip(res, jax.tree_util.tree_leaves(state.residuals)):
            assert np.abs(a - np.asarray(b)).max() <= one_step
    else:
        assert tstate.residuals is None and state.residuals is None


def test_adamw_state_from_jax_aligns_with_parameters(dense):
    """The bridge's optimizer state: the reference's moments and masters,
    each in the place of its parameter."""
    tcfg = dataclasses.replace(treg.smoke("qwen3-1.7b"), dtype="float32")
    jstate = jadamw.init(jax.tree_util.tree_map(jnp.asarray, dense),
                         jadamw.AdamWConfig())
    jstate = jstate._replace(
        step=jnp.int32(3),
        m=jax.tree_util.tree_map(lambda a: a * 2.0, jstate.master))
    tstate = bridge.adamw_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate), tcfg, device="cpu")
    tparams = bridge.params_from_jax(dense, tcfg, device="cpu")
    assert int(tstate.step) == 3
    for p, m, mp, v in zip(tparams.parameters(), tstate.m, tstate.master,
                           tstate.v):
        torch.testing.assert_close(mp, p.float())
        torch.testing.assert_close(m, 2.0 * p.float())
        assert v.dtype == torch.float32 and not v.any()
