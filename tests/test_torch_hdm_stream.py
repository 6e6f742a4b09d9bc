"""The port's paged weight-streaming matmul against the reference on the
CPU.

``repro_torch.kernels.hdm_stream.ops.stream_matmul`` (its plain version on
CPU tensors) against the reference's ``stream_matmul`` (the Pallas kernel
in interpret mode, as ``tests/test_kernels.py`` runs it) and its oracle
``paged_matmul_ref``, at the shapes of ``tests/test_kernels.py`` and
``HDM_SHAPES`` of ``tests/test_kernel_parity.py``: f32, bf16, and f32
weights that went through the int8 page format. Tolerances follow
``tests/test_kernel_parity.py``: f32 3e-5, bf16 2e-2. The CUDA kernel is
held to the plain version on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hdm_stream.ops import stream_matmul as jax_stream_matmul
from repro.kernels.hdm_stream.ref import paged_matmul_ref
from repro.models import kv_quant as jkvq
from repro_torch.kernels.hdm_stream import ops
from repro_torch.kernels.hdm_stream.ref import paged_matmul_ref as plain_ref

# (M, K, N, page_k, n_pages, block_m, block_n)
SHAPES = [
    (32, 64, 64, 16, 8, 32, 32),      # tests/test_kernels.py
    (64, 128, 96, 32, 4, 32, 48),
    (32, 64, 32, 32, 4, 32, 32),      # HDM_SHAPES
    (64, 32, 32, 16, 4, 32, 32),
]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return (dict(atol=2e-2, rtol=2e-2) if name == "bfloat16"
            else dict(atol=3e-5, rtol=3e-5))


def _qdq(w):
    """f32 weights through the int8 page format and back, viewed as
    [n_pages, page_k, N, 1] pages (``tests/test_kernel_parity.py``)."""
    wr = jnp.asarray(w).reshape(w.shape + (1,))
    s = jkvq.page_scales(wr)
    return np.array(jkvq.dequantize_pages(jkvq.quantize_pages(wr, s), s)
                    ).reshape(w.shape)


def _inputs(shape, seed, qdq=False):
    m, k, n, page_k, n_pages, _, _ = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((n_pages, page_k, n)).astype(np.float32)
    if qdq:
        w = _qdq(w)
    pids = rng.permutation(n_pages)[:k // page_k].astype(np.int32)
    return x, w, pids


def _run(shape, name, x, w, pids):
    jdt, tdt = DTYPES[name]
    _, _, _, _, _, bm, bn = shape
    got = ops.stream_matmul(torch.from_numpy(x).to(tdt),
                            torch.from_numpy(w).to(tdt),
                            torch.from_numpy(pids))
    assert got.dtype == tdt and got.shape == (x.shape[0], w.shape[-1])
    xj, wj = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    kernel = jax_stream_matmul(xj, wj, jnp.asarray(pids), block_m=bm,
                               block_n=bn)
    oracle = paged_matmul_ref(xj, wj, jnp.asarray(pids))
    got = got.float().numpy()
    for want in (kernel, oracle):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   **_tol(name))


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_stream_matmul_matches_reference(shape, name):
    _run(shape, name, *_inputs(shape, 0))


@pytest.mark.parametrize("shape", SHAPES)
def test_stream_matmul_int8_qdq_weights_match_reference(shape):
    _run(shape, "float32", *_inputs(shape, 1, qdq=True))


def test_ragged_m_and_n_plain_version():
    """The port widens the op to ragged M and N (the decode batch is 8):
    the plain version is the oracle's function at any M and N."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 48)).astype(np.float32)
    w = rng.standard_normal((5, 16, 37)).astype(np.float32)
    pids = np.array([4, 0, 2], np.int32)
    got = ops.stream_matmul(*(torch.from_numpy(a) for a in (x, w, pids)))
    want = x @ np.concatenate([w[i] for i in pids])
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=3e-5)
    assert torch.equal(got, plain_ref(*(torch.from_numpy(a)
                                        for a in (x, w, pids))))


def test_stream_matmul_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((4, 32))
    w = torch.zeros((4, 16, 8))
    with pytest.raises(ValueError, match="pages"):
        ops.stream_matmul(x, w, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError, match="dtype"):
        ops.stream_matmul(x, w.bfloat16(), torch.zeros(2, dtype=torch.int32))
