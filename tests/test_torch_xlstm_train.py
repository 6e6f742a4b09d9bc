"""xLSTM's training forms against the reference on the CPU, one rank.

``mlstm_apply`` (the chunkwise form from a zero state, chunks of
``min(256, S)``, its stabilizers detached) and ``slstm_apply`` (the
sequential scan of the cells) against the reference's on one layer of the
smoke xlstm-125m's weights (carried across by ``repro_torch.bridge``), at
S = 100 (one chunk of its own length, no multiple of 256), 256 (exactly
one chunk) and, for the mLSTM, 512 (two chunks, the state carried
between them), in f32 (3e-5) and bf16 (2e-2), the output and the block's
own contribution (output less input; within the same tolerance of its
size); the reference's refusal of a sequence its chunk does not divide;
every gradient of a loss through each form; then one whole AdamW step of
smoke xlstm-125m in f32 against the reference's (``tests/
test_torch_optim.py``'s rule: loss and clip norm, m, masters and
parameters within 2 lr and moved by lr where the gradient's sign is
sure). The loss and every gradient of the whole model are held to the
reference in ``tests/test_torch_train.py`` with the other families.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import MeshConfig, RunConfig, SHAPES
from repro.launch import steps as jsteps
from repro.models import model as JM
from repro.models import xlstm as jx
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MeshConfig as TMeshConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.launch import steps as tsteps
from repro_torch.models import xlstm as tx
from repro_torch.optim import adamw as tadamw

ARCH = "xlstm-125m"
NAMES = ["float32", "bfloat16"]
LENGTHS = [100, 256, 512]


def _tol(name):
    return (dict(atol=2e-2, rtol=2e-2) if name == "bfloat16"
            else dict(atol=3e-5, rtol=3e-5))


@pytest.fixture(scope="module")
def weights(host_mesh):
    """The reference's smoke weights in both dtypes, and the port's models
    built from them."""
    out = {}
    for name in NAMES:
        cfg = dataclasses.replace(jreg.smoke(ARCH), dtype=name)
        with jax.set_mesh(host_mesh):
            params = JM.init_model(jax.random.PRNGKey(0), cfg)
        tcfg = dataclasses.replace(treg.smoke(ARCH), dtype=name)
        model = bridge.params_from_jax(jax.tree_util.tree_map(
            np.asarray, params), tcfg, device="cpu")
        out[name] = (cfg, params, tcfg, model)
    return out


def _layers(weights, name):
    """(reference mLSTM layer, port mLSTM, reference sLSTM, port sLSTM):
    group 0's first mLSTM layer and its sLSTM layer."""
    cfg, params, tcfg, model = weights[name]
    grp = params["groups"]
    return (jax.tree_util.tree_map(lambda a: a[0, 0], grp["mlstm"]),
            model.mlstm[0][0],
            jax.tree_util.tree_map(lambda a: a[0], grp["slstm"]),
            model.slstm[0])


def _x(s, d, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, s, d)) * 0.5).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return bridge.to_numpy(x)
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("form,s", [("mlstm", s) for s in LENGTHS]
                         + [("slstm", s) for s in LENGTHS[:2]])
@pytest.mark.parametrize("name", NAMES)
def test_training_form_matches_reference(weights, form, name, s):
    cfg, _, tcfg, _ = weights[name]
    jm, tm, js, ts = _layers(weights, name)
    x = _x(s, cfg.d_model)
    jfn, tfn, jl, tl = ((jx.mlstm_apply, tx.mlstm_apply, jm, tm)
                        if form == "mlstm" else
                        (jx.slstm_apply, tx.slstm_apply, js, ts))
    want = _np(jfn(jl, cfg, jnp.asarray(x, name)))
    xt = torch.from_numpy(x).to(getattr(torch, name))
    got = _np(tfn(tl, tcfg, xt))
    np.testing.assert_allclose(got, want, **_tol(name))
    # the block's own part, clear of the residual it is added to
    x_in = _np(xt)
    delta_got, delta_want = got - x_in, want - x_in
    tol = _tol(name)
    assert np.abs(delta_got - delta_want).max() <= tol["atol"] * max(
        1.0, np.abs(delta_want).max())
    assert np.abs(delta_want).max() > 1e-3


def test_mlstm_apply_refuses_a_ragged_sequence(weights):
    """300 tokens over chunks of 256: the reference asserts, the port
    raises."""
    cfg, _, tcfg, _ = weights["float32"]
    jm, tm, _, _ = _layers(weights, "float32")
    x = _x(300, cfg.d_model)
    with pytest.raises(AssertionError):
        jx.mlstm_apply(jm, cfg, jnp.asarray(x))
    with pytest.raises(ValueError, match="no multiple"):
        tx.mlstm_apply(tm, tcfg, torch.from_numpy(x))


@pytest.mark.parametrize("form,s", [("mlstm", 512), ("slstm", 128)])
def test_training_form_grads_match_reference(weights, form, s):
    """The gradient of a loss through one layer, for every weight of the
    layer and the input, in f32: the mLSTM over two chunks, whose
    detached stabilizers (m_loc, m_new) are the reference's
    ``stop_gradient``s; the sLSTM over 128 cells."""
    cfg, _, tcfg, _ = weights["float32"]
    jm, tm, js, ts = _layers(weights, "float32")
    x = _x(s, cfg.d_model, seed=5)
    rng = np.random.default_rng(6)
    w_out = rng.standard_normal((s, cfg.d_model)).astype(np.float32)
    jfn, tfn, jl, tl = ((jx.mlstm_apply, tx.mlstm_apply, jm, tm)
                        if form == "mlstm" else
                        (jx.slstm_apply, tx.slstm_apply, js, ts))
    jg = jax.grad(lambda p, xx: jnp.sum(jfn(p, cfg, xx) * w_out),
                  argnums=(0, 1))(jl, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    leaves = [p for p in tl.parameters()]
    for p in leaves:
        p.requires_grad_(True)
    out = (tfn(tl, tcfg, xt) * torch.from_numpy(w_out)).sum()
    grads = torch.autograd.grad(out, leaves + [xt])
    for p in leaves:
        p.requires_grad_(False)
    np.testing.assert_allclose(_np(grads[-1]), _np(jg[1]), atol=3e-5,
                               rtol=3e-5)
    got = dict(zip([n for n, _ in tl.named_parameters()], grads[:-1]))
    ref = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
           for path, leaf in jax.tree_util.tree_leaves_with_path(jg[0])}
    names = {n: n.replace(".", "/") for n in got}
    assert sorted(names.values()) == sorted(ref)
    scale = max(np.abs(_np(v)).max() for v in ref.values())
    for n, r in names.items():
        err = np.abs(_np(got[n]) - _np(ref[r])).max()
        assert err <= 3e-5 * scale, (form, r, err, scale)


def test_adamw_step_matches_reference(host_mesh, weights):
    """One ``build_train_step`` step of smoke xlstm-125m in f32 from the
    same weights and batch against the reference's."""
    cfg, params, tcfg, _ = weights["float32"]
    # the reference's layer scan at SR depth 0 (in training its depth only
    # unrolls the scan: the same values, half the program to compile)
    rc = RunConfig(model=cfg, shape=SHAPES["train_4k"], mesh=MeshConfig(),
                   sr_prefetch_depth=0)
    trc = TRunConfig(model=tcfg, shape=TSHAPES["train_4k"],
                     mesh=TMeshConfig())
    lr = 1e-2
    jopt = jadamw.AdamWConfig(learning_rate=lr, warmup_steps=0)
    topt = tadamw.AdamWConfig(learning_rate=lr, warmup_steps=0)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    with jax.set_mesh(host_mesh):
        state, jm = jax.jit(jsteps.build_train_step(cfg, rc, jopt))(
            jsteps.TrainState(params, jadamw.init(params, jopt), None), jb)
    model = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          params),
                                   tcfg, device="cpu")
    # copies: the step writes the parameters in place
    p0 = [np.array(a) for a in jax.tree_util.tree_leaves(
        bridge.params_to_numpy(model, tcfg))]
    tstate = tsteps.init_state(model, trc, topt)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    _, tg = tsteps.loss_and_grads(model, tcfg, trc, batch)
    tstate, tm = tsteps.build_train_step(tcfg, trc, topt)(tstate, batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=3e-5)
    # the port's gradients (held to the reference's in
    # tests/test_torch_train.py) give the signs that are sure
    gnorm = float(jm["grad_norm"])
    got = jax.tree_util.tree_leaves(bridge.params_to_numpy(model, tcfg, tg))
    masters = jax.tree_util.tree_leaves(bridge.params_to_numpy(
        model, tcfg, tstate.opt.master))
    for a, b in zip(masters, jax.tree_util.tree_leaves(state.opt.master)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2 * lr, rtol=0)
    for a, b in zip(jax.tree_util.tree_leaves(bridge.params_to_numpy(
            model, tcfg)), jax.tree_util.tree_leaves(state.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2 * lr, rtol=0)
    m = jax.tree_util.tree_leaves(bridge.params_to_numpy(model, tcfg,
                                                         tstate.opt.m))
    for a, b in zip(m, jax.tree_util.tree_leaves(state.opt.m)):
        assert np.abs(a - np.asarray(b)).max() <= 0.1 * 3e-5 * gnorm
    clear, n_moved = 3e-5 * gnorm, 0
    for a, w0, g in zip(masters, p0, got):
        sure = np.abs(g) > clear
        assert np.abs(np.abs(a - w0)[sure] - lr).max(initial=0.0) <= lr / 2
        n_moved += int(sure.sum())
    assert n_moved > 0
    assert int(tstate.opt.step) == int(state.opt.step) == 1
