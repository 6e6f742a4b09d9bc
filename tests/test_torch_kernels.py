"""Plain versions of the port's kernels against the reference on the CPU.

Each port kernel widens a Pallas kernel (``repro.kernels``, run in
interpret mode off the TPU) to what the serving path needs: the paged
decode takes a per-slot ``kv_len[B]`` (the Pallas kernel one scalar, so it
is applied slot by slot here), the flash prefill a per-row query offset
``pos[B]`` with ragged lengths (the Pallas kernel is its offset-0 causal
case; offsets > 0 are held to the serving path's jnp
``chunk_prefill_attention``). Tolerances follow
``tests/test_kernel_parity.py``: f32 3e-5, bf16 2e-2. The CUDA kernels
themselves are held to these plain versions on the card by
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode as jax_decode
from repro.kernels.decode_attention.ref import paged_flash_decode_ref
from repro.kernels.flash_attention.ops import attention as jax_attention
from repro.models import attention as jattn
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.models import attention as tattn

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return (dict(atol=2e-2, rtol=2e-2) if name == "bfloat16"
            else dict(atol=3e-5, rtol=3e-5))


def _pair(rng, shape, name):
    """One numpy draw as (jax array, torch tensor) in the named dtype."""
    a = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = DTYPES[name]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------ paged decode

@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_paged_decode_plain_matches_pallas_per_slot(name, softcap):
    rng = np.random.default_rng(1)
    b, p, page, hkv, g, d = 4, 3, 16, 2, 2, 16
    q_j, q_t = _pair(rng, (b, 1, hkv * g, d), name)
    k_j, k_t = _pair(rng, (b, p, page, hkv, d), name)
    v_j, v_t = _pair(rng, (b, p, page, hkv, d), name)
    kv_len = np.array([1, 17, 48, 30], np.int32)      # 1 .. a full cache
    got = dops.paged_decode(q_t, k_t, v_t, torch.from_numpy(kv_len),
                            logit_softcap=softcap)
    assert got.dtype == q_t.dtype and got.shape == q_t.shape
    for i in range(b):
        want = jax_decode(q_j[i:i + 1], k_j[i:i + 1], v_j[i:i + 1],
                          int(kv_len[i]), logit_softcap=softcap)
        np.testing.assert_allclose(_np(got[i:i + 1]), _np(want),
                                   **_tol(name))


def test_paged_decode_plain_matches_oracle():
    rng = np.random.default_rng(2)
    b, p, page, hkv, g, d = 3, 4, 8, 2, 4, 16
    q_j, q_t = _pair(rng, (b, 1, hkv * g, d), "float32")
    k_j, k_t = _pair(rng, (b, p, page, hkv, d), "float32")
    v_j, v_t = _pair(rng, (b, p, page, hkv, d), "float32")
    kv_len = np.array([5, 32, 9], np.int32)
    got = dops.paged_decode(q_t, k_t, v_t, torch.from_numpy(kv_len))
    for i in range(b):
        want = paged_flash_decode_ref(
            q_j[i:i + 1].reshape(1, hkv, g, d),
            jnp.moveaxis(k_j[i:i + 1], 3, 1), jnp.moveaxis(v_j[i:i + 1], 3, 1),
            int(kv_len[i]))
        np.testing.assert_allclose(_np(got[i]).reshape(hkv, g, d),
                                   _np(want)[0], atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_paged_decode_attention_matches_serving_path(mesh_ctx, name):
    """Write-then-attend of the decode tick, positions past the cache end
    (an idle slot keeps advancing) included: the reference clamps the
    write and sees the whole cache."""
    rng = np.random.default_rng(3)
    b, p, page, hkv, g, d = 4, 2, 8, 2, 2, 16
    q_j, q_t = _pair(rng, (b, 1, hkv * g, d), name)
    k_j, k_t = _pair(rng, (b, p, page, hkv, d), name)
    v_j, v_t = _pair(rng, (b, p, page, hkv, d), name)
    nk_j, nk_t = _pair(rng, (b, 1, hkv, d), name)
    nv_j, nv_t = _pair(rng, (b, 1, hkv, d), name)
    pos = np.array([0, 7, 15, 40], np.int32)
    o_j, kp_j, vp_j = jattn.paged_decode_attention(
        q_j, k_j, v_j, nk_j, nv_j, jnp.asarray(pos), batch_axes=None,
        page_axes=None)
    o_t = tattn.paged_decode_attention(q_t, k_t, v_t, nk_t, nv_t,
                                       torch.from_numpy(pos))
    np.testing.assert_allclose(_np(o_t), _np(o_j), **_tol(name))
    np.testing.assert_array_equal(_np(k_t), _np(kp_j))
    np.testing.assert_array_equal(_np(v_t), _np(vp_j))


def test_paged_decode_wrapper_checks():
    q = torch.zeros(2, 1, 4, 16)
    pages = torch.zeros(2, 2, 8, 2, 16)
    ok = torch.tensor([3, 4], dtype=torch.int32)
    before = dops.launches
    dops.paged_decode(q, pages, pages, ok)
    assert dops.launches == before          # CPU runs the plain version
    with pytest.raises(ValueError):
        dops.paged_decode(q, pages, pages, torch.tensor([3], dtype=torch.int32))
    with pytest.raises(ValueError):
        dops.paged_decode(q[:, :, :3], pages, pages, ok)
    with pytest.raises(TypeError):
        dops.paged_decode(q, pages.bfloat16(), pages.bfloat16(), ok)
    assert dops.split_count(2048) == 8 and dops.split_count(300) == 2


# ---------------------------------------------------------- flash prefill

@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_flash_prefill_plain_matches_pallas_at_offset_zero(name, softcap):
    rng = np.random.default_rng(4)
    b, s, hkv, g, d = 2, 32, 2, 2, 16
    q_j, q_t = _pair(rng, (b, s, hkv * g, d), name)
    k_j, k_t = _pair(rng, (b, s, hkv, d), name)
    v_j, v_t = _pair(rng, (b, s, hkv, d), name)
    want = jax_attention(q_j, k_j, v_j, causal=True, q_block=16,
                         kv_block=16, logit_softcap=softcap)
    got = fops.flash_prefill(q_t, k_t, v_t, torch.zeros(b, dtype=torch.int32),
                             logit_softcap=softcap)
    assert got.dtype == q_t.dtype and got.shape == q_t.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("c,smax,pos", [
    (8, 48, (5, 17)),          # offsets past a block edge
    (7, 45, (0, 38)),          # ragged chunk and cache, chunk at the end
    (1, 40, (12, 39)),         # one-token chunks
])
def test_flash_prefill_plain_matches_chunk_prefill(name, softcap, c, smax,
                                                   pos):
    rng = np.random.default_rng(5)
    b, hkv, g, d = 2, 2, 2, 16
    q_j, q_t = _pair(rng, (b, c, hkv * g, d), name)
    k_j, k_t = _pair(rng, (b, smax, hkv, d), name)
    v_j, v_t = _pair(rng, (b, smax, hkv, d), name)
    p = np.asarray(pos, np.int32)
    want = jattn.chunk_prefill_attention(q_j, k_j, v_j, jnp.asarray(p),
                                         logit_softcap=softcap)
    got = fops.flash_prefill(q_t, k_t, v_t, torch.from_numpy(p),
                             logit_softcap=softcap)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))


def test_flash_prefill_wrapper_checks():
    q = torch.zeros(1, 4, 4, 16)
    cache = torch.zeros(1, 8, 2, 16)
    pos = torch.zeros(1, dtype=torch.int32)
    before = fops.launches
    fops.flash_prefill(q, cache, cache, pos)
    assert fops.launches == before          # CPU runs the plain version
    with pytest.raises(ValueError):
        fops.flash_prefill(q, cache[:, :, :, :8], cache[:, :, :, :8], pos)
    with pytest.raises(ValueError):
        fops.flash_prefill(q, cache, cache, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError):
        fops.flash_prefill(q.bfloat16(), cache, cache, pos)


def test_write_rows_clamps_like_dynamic_update_slice():
    buf = torch.zeros(2, 6, 1, 1)
    new = torch.arange(1, 7, dtype=torch.float32).reshape(2, 3, 1, 1)
    tattn.write_rows(buf, new, torch.tensor([1, 5], dtype=torch.int32))
    want = jax.vmap(lambda b_, n_, p_: jax.lax.dynamic_update_slice(
        b_, n_, (p_, 0, 0)))(jnp.zeros((2, 6, 1, 1)), jnp.asarray(new.numpy()),
                             jnp.asarray([1, 5], jnp.int32))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(want))
