"""The port's SSD scan and Mamba2 layer against the reference on the CPU.

* ``ssd`` (plain chunked form, the CPU side of the ``csrc/ssd_scan.cu``
  wrapper) and the plain recurrence against the reference's Pallas
  ``ssd`` (interpret mode off the TPU) and its ``ssd_scan_ref`` oracle, at
  the shapes of ``tests/test_kernels.py::test_ssd_scan`` and the same
  tolerance (atol = rtol = 1e-4);
* the carried state: a sequence split in two (ragged splits included) and
  scanned piecewise from ``h0`` equals one scan of the whole;
* ``mamba_apply`` and ``mamba_step`` against the reference's, and the
  serving prefill ``mamba_prefill_chunk`` against a loop of the
  reference's ``mamba_step`` (y, ``h`` and ``conv``) -- the function the
  reference engine's prefill scan computes.

Inputs are drawn with numpy; weights are the reference's, carried across
through ``repro_torch.bridge``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels.mamba2_scan.ops import ssd as jax_ssd
from repro.kernels.mamba2_scan.ref import ssd_scan_ref
from repro.models import mamba2 as jm
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.kernels.mamba2_scan import ops, ref
from repro_torch.models import mamba2 as tm

TOL = dict(atol=1e-4, rtol=1e-4)        # tests/test_kernels.py::test_ssd_scan
SHAPES = [(1, 32, 2, 8, 16, 16), (2, 64, 3, 8, 16, 32),
          (1, 64, 1, 16, 8, 64)]


def _inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((b, s, h, p)).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    la = (-np.abs(rng.standard_normal((b, s, h))) * 0.1).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return xdt, bm, cm, la, h0


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax_ssd(xdt, bm, cm, la, chunk):
    return np.asarray(jax_ssd(jnp.asarray(xdt), jnp.asarray(bm),
                              jnp.asarray(cm), jnp.asarray(la), chunk=chunk))


# -------------------------------------------------------------- the scan

@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_ssd_plain_matches_pallas_and_oracle(b, s, h, p, n, chunk):
    xdt, bm, cm, la, _ = _inputs(0, b, s, h, p, n)
    want = _jax_ssd(xdt, bm, cm, la, chunk)
    c = s // chunk
    lac = jnp.moveaxis(jnp.cumsum(jnp.asarray(la).reshape(b, c, chunk, h),
                                  axis=2), 3, 1)
    oracle = ssd_scan_ref(
        jnp.moveaxis(jnp.asarray(xdt).reshape(b, c, chunk, h, p), 3, 1),
        jnp.asarray(bm).reshape(b, c, chunk, n),
        jnp.asarray(cm).reshape(b, c, chunk, n), lac)
    oracle = np.asarray(jnp.moveaxis(oracle, 1, 3).reshape(b, s, h, p))
    before = ops.launches
    y, h_last = ops.ssd(*_t(xdt, bm, cm, la), chunk=chunk)
    assert ops.launches == before            # CPU runs the plain version
    assert y.dtype == torch.float32 and tuple(y.shape) == (b, s, h, p)
    assert tuple(h_last.shape) == (b, h, p, n)
    np.testing.assert_allclose(y.numpy(), want, **TOL)
    np.testing.assert_allclose(y.numpy(), oracle, **TOL)
    y_rec, h_rec = ref.ssd_recurrent_ref(*_t(xdt, bm, cm, la))
    np.testing.assert_allclose(y_rec.numpy(), want, **TOL)
    np.testing.assert_allclose(h_last.numpy(), h_rec.numpy(), **TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
@pytest.mark.parametrize("split", [0.5, 0.3])
def test_ssd_state_carry_matches_one_scan(b, s, h, p, n, chunk, split):
    """ssd(x[:s1]) then ssd(x[s1:], h0=h1) == the reference's ssd(x);
    s1 = 0.3 s is not a chunk multiple (ragged tails on both halves)."""
    xdt, bm, cm, la, _ = _inputs(1, b, s, h, p, n)
    want = _jax_ssd(xdt, bm, cm, la, chunk)
    s1 = int(s * split)
    full = _t(xdt, bm, cm, la)
    y1, h1 = ops.ssd(*(a[:, :s1] for a in full), chunk=chunk)
    y2, h2 = ops.ssd(*(a[:, s1:] for a in full), h0=h1, chunk=chunk)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), want, **TOL)
    _, h_all = ref.ssd_recurrent_ref(*full)
    np.testing.assert_allclose(h2.numpy(), h_all.numpy(), **TOL)


@pytest.mark.parametrize("chunk", [1, 5, 16, 64])
def test_ssd_forms_agree_from_a_nonzero_state(chunk):
    """Chunked form at any chunk (ragged ones too) == the recurrence, both
    started from the same nonzero h0."""
    xdt, bm, cm, la, h0 = _inputs(2, 2, 37, 3, 8, 16)
    y_rec, h_rec = ref.ssd_recurrent_ref(*_t(xdt, bm, cm, la, h0))
    y, h_last = ops.ssd(*_t(xdt, bm, cm, la), h0=torch.from_numpy(h0),
                        chunk=chunk)
    np.testing.assert_allclose(y.numpy(), y_rec.numpy(), **TOL)
    np.testing.assert_allclose(h_last.numpy(), h_rec.numpy(), **TOL)


def test_ssd_wrapper_checks():
    xdt, bm, cm, la, h0 = _t(*_inputs(3, 1, 8, 2, 16, 16))
    with pytest.raises(ValueError):
        ops.ssd(xdt, bm, cm, la[:, :4])
    with pytest.raises(ValueError):
        ops.ssd(xdt, bm, cm[:, :, :8], la)
    with pytest.raises(ValueError):
        ops.ssd(xdt, bm, cm, la, h0=h0[:, :1])
    with pytest.raises(TypeError):
        ops.ssd(xdt.double(), bm, cm, la)
    with pytest.raises(TypeError):
        ops.ssd(xdt, bm, cm, la, h0=h0.bfloat16())


# ------------------------------------------------------------ the layer

@pytest.fixture(scope="module")
def layers():
    """The first Mamba2 layer of smoke zamba2, per dtype, in both
    frameworks (the port's from ``bridge.params_from_jax``)."""
    out = {}
    for name in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(jreg.smoke("zamba2-2.7b"), dtype=name)
        tcfg = dataclasses.replace(treg.smoke("zamba2-2.7b"), dtype=name)
        params = JM.init_model(jax.random.PRNGKey(0), jcfg)
        tparams = bridge.params_from_jax(
            jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
        jlayer = jax.tree_util.tree_map(lambda a: a[0, 0], params["groups"])
        out[name] = (jcfg, jlayer, tcfg, tparams.groups[0][0])
    return out


def _tol(name):
    return TOL if name == "float32" else dict(atol=2e-2, rtol=2e-2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return bridge.to_numpy(x)
    return np.asarray(jnp.asarray(x, jnp.float32))


DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _u(cfg, b, s, seed, name):
    """One numpy draw of a layer input, as (jax array, torch tensor)."""
    a = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    jdt, tdt = DTYPES[name]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [8, 12])
def test_mamba_apply_matches_reference(layers, name, s):
    jcfg, jlayer, tcfg, tlayer = layers[name]
    ju, tu = _u(jcfg, 2, s, 4, name)
    want = jm.mamba_apply(jlayer, jcfg, ju, chunk=4)
    got = tm.mamba_apply(tlayer, tcfg, tu, chunk=4)
    assert got.dtype == tu.dtype and tuple(got.shape) == tuple(ju.shape)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))


def _state(cfg, b, seed):
    """A nonzero f32 state, as a slot's previous tenant leaves it."""
    rng = np.random.default_rng(seed)
    shapes = {k: v.shape for k, v in jm.mamba_state_init(cfg, b).items()}
    return {k: (rng.standard_normal(shp) * 0.3).astype(np.float32)
            for k, shp in shapes.items()}


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_mamba_step_matches_reference(layers, name):
    jcfg, jlayer, tcfg, tlayer = layers[name]
    st = _state(jcfg, 2, 5)
    ju, tu = _u(jcfg, 2, 1, 6, name)
    jy, jst = jm.mamba_step(jlayer, jcfg, ju,
                            {k: jnp.asarray(v) for k, v in st.items()})
    ty, tst = tm.mamba_step(tlayer, tcfg, tu,
                            {k: torch.from_numpy(v) for k, v in st.items()})
    np.testing.assert_allclose(_np(ty), _np(jy), **_tol(name))
    for k in ("h", "conv"):
        np.testing.assert_allclose(_np(tst[k]), _np(jst[k]), **TOL)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [1, 2, 7])
def test_mamba_prefill_chunk_matches_step_loop(layers, name, c):
    """One chunked call from a nonzero state == c reference mamba_step
    calls; c = 2 is shorter than the conv window."""
    jcfg, jlayer, tcfg, tlayer = layers[name]
    st = _state(jcfg, 2, 7)
    ju, tu = _u(jcfg, 2, c, 8, name)
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    ys = []
    for t in range(c):
        y, jst = jm.mamba_step(jlayer, jcfg, ju[:, t:t + 1], jst)
        ys.append(y)
    want = jnp.concatenate(ys, axis=1)
    got, tst = tm.mamba_prefill_chunk(
        tlayer, tcfg, tu, {k: torch.from_numpy(v) for k, v in st.items()})
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))
    for k in ("h", "conv"):
        assert tst[k].dtype == torch.float32
        np.testing.assert_allclose(_np(tst[k]), _np(jst[k]), **TOL)
