"""The two Hopper instances' launch plans and arithmetic, on the CPU.

``csrc/flash_prefill.cu``'s "wgmma" instance (TMA, a producer warp, two
consumer warpgroups on wgmma) takes bf16 chunks of the training loss's
length at D 128; ``csrc/paged_decode.cu``'s "mma" instance (the group's
query heads as the 16 rows of tensor-core products) takes gemma-2b's D 256
decode in both modes. Both run only on the card; here their plans are
checked (what ``plan()`` routes to them, shared memory, the grid, the
launch order, what ``check_plan`` refuses), and their arithmetic, written
out plainly in ``ref.py`` (``flash_prefill_tiled_ref``,
``paged_decode_mma_ref``, ``paged_decode_int8_mma_ref``), is held to the
reference: its Pallas kernels in interpret mode, as its own tests run them,
and its jnp serving paths where the Pallas kernel has no such input (a
chunk at pos > 0, the int8 mode's fresh row). Tolerances follow
``tests/test_kernel_parity.py``: f32 3e-5, bf16 2e-2.
"""
import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode as jax_decode
from repro.kernels.flash_attention.ops import attention as jax_attention
from repro.models import attention as jattn
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.decode_attention import ref as dref
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.models import kv_quant

MAX_SMEM = 232448
N_SMS = 132
BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8
TRAIN = (8, 4096, 16, 8, 128)            # (b, c, h, hkv, d): the loss's
GEMMA_DECODE = (8, 8, 1, 2048, 256, 256)  # (b, h, hkv, smax, page, d)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU products on one intra-op thread, beside the suite's other
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(dtype):
    return (dict(atol=2e-2, rtol=2e-2) if dtype == BF16
            else dict(atol=3e-5, rtol=3e-5))


def _pair(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------ prefill plans

def test_train_shape_runs_the_hopper_instance():
    """The training loss's shape names "wgmma": 128 rows per CTA (64
    positions x G 2), 3 stages of 128-key K/V tiles, inside the block's
    shared memory; the grid covers the rows once and check_plan takes it."""
    b, c, h, hkv, d = TRAIN
    p = fops.plan(b, c, h, hkv, d, BF16)
    assert (p.kernel, p.rows, p.stages) == ("wgmma", 128, 3)
    assert p.smem_bytes == 1024 + 2 * 128 * 128 + 3 * 2 * 2 * 128 * 128 + 128
    assert p.smem_bytes <= MAX_SMEM
    assert p.grid == (c * (h // hkv) // 128, hkv, b)
    fops.check_plan(p, b, c, h, hkv, d, BF16)


def _check_longest_first(b, c, h, hkv):
    """The order the CTAs of a "wgmma" launch start in covers every (row
    tile, kv head, batch row) once; it takes the (kv head, batch row)
    pairs in groups of ``WGMMA_GROUP_PAIRS`` (the last group holds the
    rest), and within a group the key tiles a CTA reads at pos 0 never
    grow, from the longest row tile's to one."""
    p = fops.wgmma_plan(b, c, h, hkv)
    gx, g = p.grid[0], h // hkv
    order = fops.wgmma_order(p)
    assert len(set(order)) == len(order) == gx * hkv * b
    pairs, n = hkv * b, fops.WGMMA_GROUP_PAIRS
    at = 0
    for first in range(0, pairs, n):
        size = min(n, pairs - first) * gx
        group = order[at:at + size]
        at += size
        assert {bb * hkv + hk for _, hk, bb in group} == set(
            range(first, min(first + n, pairs)))
        work = [-(-((t + 1) * p.rows // g) // fops.WGMMA_KEYS)
                for t, _, _ in group]
        assert work[0] == -(-c // fops.WGMMA_KEYS) and work[-1] == 1
        assert all(x >= y for x, y in zip(work, work[1:]))
    assert at == len(order)


def test_train_shape_starts_the_longest_tiles_first():
    """At the training shape: 64 pairs in 16 groups of 4."""
    b, c, h, hkv, d = TRAIN
    assert fops.plan(b, c, h, hkv, d, BF16).kernel == "wgmma"
    _check_longest_first(b, c, h, hkv)


def test_wgmma_order_closes_on_a_short_group():
    """6 pairs: a group of 4, then one of the 2 left."""
    _check_longest_first(3, 1024, 4, 2)


def test_wgmma_order_uses_the_kernels_group():
    """``WGMMA_GROUP_PAIRS`` is the kernel's ``kWgGroupPairs``."""
    src = (Path(fops.__file__).parents[2] / "csrc"
           / "flash_prefill.cu").read_text()
    got = re.findall(r"constexpr int kWgGroupPairs = (\d+);", src)
    assert got == [str(fops.WGMMA_GROUP_PAIRS)]


@pytest.mark.parametrize("shape,want", [
    ((1, 256, 16, 8, 128), ("mma", 16, 3)),     # qwen3-1.7b's chunk
    ((1, 256, 32, 32, 80), ("mma", 32, 3)),     # zamba2-2.7b's chunk
    ((2, 2048, 16, 8, 128), ("mma", 64, 3)),    # the dry run's prefill
    ((8, 4096, 16, 8, 80), ("mma", 64, 3)),     # D 80: not the instance's
    ((1, 4096, 32, 8, 128), ("mma", 64, 3)),    # the VLM's G 4
    ((1, 4096, 32, 2, 128), ("mma", 64, 3)),    # glm4-9b's G 16
], ids=["qwen3", "zamba2", "2048", "d80", "g4-4096", "g16-4096"])
def test_serving_chunks_keep_their_plans(shape, want):
    """Chunks shorter than ``WGMMA_MIN_CHUNK``, head dims other than 128,
    and query-head groups outside ``WGMMA_GROUPS`` keep the plans they
    had."""
    b, c, h, hkv, d = shape
    p = fops.plan(b, c, h, hkv, d, BF16)
    assert (p.kernel, p.rows, p.stages) == want
    assert p == fops.mma_plan(b, c, h, hkv, d, p.rows, p.stages)


def test_train_shape_f32_keeps_the_tf32_instance():
    b, c, h, hkv, d = TRAIN
    assert fops.plan(b, c, h, hkv, d, F32).kernel == "tf32"


def test_check_plan_refuses_a_mismatched_wgmma_plan():
    """Other stages or rows, shared memory off by 16 bytes, another grid,
    f32, D 80 or a group outside ``WGMMA_GROUPS`` are refused; the
    old "mma" plans stay launchable at the training shape."""
    b, c, h, hkv, d = TRAIN
    p = fops.plan(b, c, h, hkv, d, BF16)
    for bad in (fops.wgmma_plan(b, c, h, hkv, 2),
                fops.wgmma_plan(b, c, h, hkv, 4),
                dataclasses.replace(p, rows=64),
                dataclasses.replace(p, smem_bytes=p.smem_bytes - 16),
                dataclasses.replace(p, grid=(p.grid[0] + 1,) + p.grid[1:])):
        with pytest.raises(ValueError):
            fops.check_plan(bad, b, c, h, hkv, d, BF16)
    with pytest.raises(ValueError):
        fops.check_plan(p, b, c, h, hkv, d, F32)
    with pytest.raises(ValueError):
        fops.check_plan(fops.wgmma_plan(b, c, h, hkv), b, c, h, hkv, 80,
                        BF16)
    for hh, kk in ((24, 8), (32, 8), (32, 2)):     # G 3, 4 and 16
        with pytest.raises(ValueError):
            fops.check_plan(fops.wgmma_plan(b, c, hh, kk), b, c, hh, kk, d,
                            BF16)
    for rows, stages in ((64, 3), (64, 2)):
        fops.check_plan(fops.mma_plan(b, c, h, hkv, d, rows, stages),
                        b, c, h, hkv, d, BF16)


# ------------------------------------------------------------- decode plans

@pytest.mark.parametrize("kv_dtype", [BF16, I8], ids=str)
def test_gemma_decode_runs_the_mma_instance(kv_dtype):
    """gemma-2b's tick (8 slots x 2048 tokens, one kv head of 8 query
    heads, D 256), both modes: the "mma" instance, >= 2 x 132 CTAs at
    Smax, 32-token tiles inside a page, splits that cover the cache once,
    the whole group in one CTA, inside the block's shared memory."""
    b, h, hkv, smax, page, d = GEMMA_DECODE
    p = dops.plan(b, h, hkv, smax, page, d, kv_dtype)
    assert (p.kernel, p.group_pad, p.group_rows, p.group_chunks) == (
        "mma", 16, 8, 1)
    assert p.n_splits * hkv * b >= 2 * N_SMS
    assert page % p.tile == 0 and p.split % p.tile == 0
    assert p.n_splits * p.split == smax
    assert p.smem_bytes <= MAX_SMEM
    assert p.part_acc == (b, hkv, p.n_splits, 8, d)
    assert p.counters == (b, hkv, 1)
    dops.check_plan(p, b, h, hkv, smax, page, d, kv_dtype)


@pytest.mark.parametrize("shape,routed", [
    ((8, 32, 8, 2048, 256, 128), True),     # the VLM: G 4 at D 128
    ((8, 32, 2, 2048, 256, 128), True),     # glm4-9b: G 16
    ((8, 48, 4, 2048, 256, 128), True),     # starcoder2-15b: G 12
    ((8, 16, 8, 2048, 256, 128), False),    # qwen3-1.7b: G 2
    ((8, 32, 32, 2048, 256, 80), False),    # zamba2-2.7b: D 80
    ((8, 16, 8, 2048, 256, 64), False),     # granite: D 64
    ((8, 16, 16, 2048, 256, 256), False),   # G 1 at D 256
], ids=["vlm", "glm4", "starcoder2", "qwen3", "zamba2", "granite",
        "g1-d256"])
def test_decode_routing_at_the_serving_shapes(shape, routed):
    """The tensor-core instance takes groups of at least 4 at D 128 and
    256 (bf16 q; both modes), with at least 2 x 132 CTAs at Smax; the
    other serving shapes keep the lanes instance's plans."""
    b, h, hkv, smax, page, d = shape
    for kv_dtype in (BF16, I8):
        p = dops.plan(b, h, hkv, smax, page, d, kv_dtype)
        if routed:
            assert p == dops.mma_plan(b, h, hkv, smax, page, d, kv_dtype)
            assert p.n_splits * hkv * b >= 2 * N_SMS
            assert dops.plan(b, h, hkv, smax, page, d, kv_dtype,
                             F32).kernel == "lanes"
        else:
            assert p == dops.lanes_plan(b, h, hkv, smax, page, d, kv_dtype)


def test_decode_f32_q_over_int8_keeps_the_lanes_instance():
    b, h, hkv, smax, page, d = GEMMA_DECODE
    assert dops.plan(b, h, hkv, smax, page, d, I8, F32).kernel == "lanes"


def test_decode_check_plan_refuses_mismatched_mma_plans():
    """f32 q, f32 pages, D 64, 17 query heads a kv head, pages that are not
    whole tiles, and a plan with any field changed are refused; the lanes
    plan at gemma's shape stays launchable (for the in-call comparison)."""
    b, h, hkv, smax, page, d = GEMMA_DECODE
    p = dops.plan(b, h, hkv, smax, page, d, BF16)
    for bad in (dataclasses.replace(p, split=64),
                dataclasses.replace(p, n_splits=p.n_splits + 1),
                dataclasses.replace(p, tile=16),
                dataclasses.replace(p, stages=2),
                dataclasses.replace(p, smem_bytes=p.smem_bytes - 16),
                dataclasses.replace(p, group_pad=8)):
        with pytest.raises(ValueError):
            dops.check_plan(bad, b, h, hkv, smax, page, d, BF16)
    with pytest.raises(ValueError):
        dops.check_plan(p, b, h, hkv, smax, page, d, I8, F32)
    with pytest.raises(ValueError):
        dops.mma_plan(b, h, hkv, smax, page, d, F32)
    for args in ((b, h, hkv, smax, page, 64, BF16),
                 (b, 17, 1, smax, page, d, BF16),
                 (b, h, hkv, 2048, 48, d, BF16)):
        with pytest.raises(ValueError):
            dops.mma_plan(*args)
    dops.check_plan(dops.lanes_plan(b, h, hkv, smax, page, d, BF16),
                    b, h, hkv, smax, page, d, BF16)


# --------------------------------------------- the decode's plain models

B_D, P_D, PAGE_D, G_D, D_D = 5, 4, 64, 8, 256     # D 256, G 8, one kv head


def _decode_case(dtype, seed):
    rng = np.random.default_rng(seed)
    h = G_D
    q = _pair(rng, (B_D, 1, h, D_D), dtype)
    k = _pair(rng, (B_D, P_D, PAGE_D, 1, D_D), dtype)
    v = _pair(rng, (B_D, P_D, PAGE_D, 1, D_D), dtype)
    split = dops.mma_plan(B_D, h, 1, P_D * PAGE_D, PAGE_D, D_D, BF16).split
    return q, k, v, split


@pytest.mark.parametrize("dtype", [F32, BF16], ids=str)
def test_decode_mma_model_matches_pallas(dtype):
    """Slots of length 1, split - 1, split, split + 1 and Smax (the plan's
    32-token split at this shape): the instance's arithmetic against the
    Pallas kernel, slot by slot, and its return_ml partials against the
    reference's ``_flash_decode_partial``."""
    (q_j, q_t), (k_j, k_t), (v_j, v_t), split = _decode_case(dtype, 21)
    assert split == dops.MMA_TILE
    smax = P_D * PAGE_D
    kv_len = np.array([1, split - 1, split, split + 1, smax], np.int32)
    got = dref.paged_decode_mma_ref(q_t, k_t, v_t, torch.from_numpy(kv_len),
                                    split)
    assert got.dtype == dtype and got.shape == q_t.shape
    for i in range(B_D):
        want = jax_decode(q_j[i:i + 1], k_j[i:i + 1], v_j[i:i + 1],
                          int(kv_len[i]))
        np.testing.assert_allclose(_np(got[i:i + 1]), _np(want),
                                   **_tol(dtype))
    o, m, l = dref.paged_decode_mma_ref(q_t, k_t, v_t,
                                        torch.from_numpy(kv_len), split,
                                        return_ml=True)
    acc, jm, jl = jattn._flash_decode_partial(
        q_j, k_j.reshape(B_D, smax, 1, D_D), v_j.reshape(B_D, smax, 1, D_D),
        jnp.asarray(kv_len))
    want_o = (_np(acc) / _np(jl)[..., None]).reshape(B_D, 1, G_D, D_D)
    np.testing.assert_allclose(o.numpy(), want_o, **_tol(dtype))
    np.testing.assert_allclose(m.numpy(), (_np(jm) / np.log(2.0)).reshape(
        B_D, -1), **_tol(dtype))
    np.testing.assert_allclose(l.numpy(), _np(jl).reshape(B_D, -1),
                               **_tol(dtype))


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_decode_int8_mma_model_matches_pallas(softcap):
    """The int8 mode with no fresh row (every row a code): the widened
    tiles' arithmetic in f32 against the Pallas kernel's ``quant=True``
    (f32, 3e-5), and its bf16 rounding (q, the widened tiles, p) against
    the same kernel given bf16 q (2e-2)."""
    rng = np.random.default_rng(22)
    smax = P_D * PAGE_D
    init = torch.full((B_D, P_D, 1), kv_quant.INIT_SCALE)
    (kc, ks), (vc, vs) = (kv_quant.requantize_pages(torch.from_numpy(
        rng.standard_normal((B_D, P_D, PAGE_D, 1, D_D), dtype=np.float32)),
        init) for _ in range(2))
    q = rng.standard_normal((B_D, 1, G_D, D_D), dtype=np.float32)
    split = dops.mma_plan(B_D, G_D, 1, smax, PAGE_D, D_D, I8).split
    kv_len = torch.tensor([1, split - 1, split, split + 1, smax],
                          dtype=torch.int32)
    zeros = torch.zeros(B_D, 1, 1, D_D)
    none = torch.full((B_D,), -1, dtype=torch.int32)
    for dtype in (F32, BF16):
        qt = torch.from_numpy(q).to(dtype)
        got = dref.paged_decode_int8_mma_ref(
            qt, kc, vc, ks, vs, zeros.to(dtype), zeros.to(dtype), None,
            softcap, split=split, kv_len=kv_len, fresh=none)
        qj = jnp.asarray(q, jnp.bfloat16 if dtype == BF16 else jnp.float32)
        for i in range(B_D):
            want = jax_decode(qj[i:i + 1], jnp.asarray(kc.numpy()[i:i + 1]),
                              jnp.asarray(vc.numpy()[i:i + 1]),
                              int(kv_len[i]), logit_softcap=softcap,
                              k_scale=jnp.asarray(ks.numpy()[i:i + 1]),
                              v_scale=jnp.asarray(vs.numpy()[i:i + 1]))
            np.testing.assert_allclose(_np(got[i:i + 1]), _np(want),
                                       **_tol(dtype))


@pytest.mark.parametrize("dtype", [F32, BF16], ids=str)
def test_decode_int8_mma_model_fresh_row(dtype):
    """The new token at full precision, on a tile's first and last row
    (pos 0, 31, 32, 63) and past a split edge: the model against the
    reference's int8 decode (dequantize, write the new row, attend)."""
    rng = np.random.default_rng(23)
    smax = P_D * PAGE_D
    init = torch.full((B_D, P_D, 1), kv_quant.INIT_SCALE)
    (kc, ks), (vc, vs) = (kv_quant.requantize_pages(torch.from_numpy(
        rng.standard_normal((B_D, P_D, PAGE_D, 1, D_D), dtype=np.float32)),
        init) for _ in range(2))
    q_j, q_t = _pair(rng, (B_D, 1, G_D, D_D), dtype)
    nk_j, nk_t = _pair(rng, (B_D, 1, 1, D_D), dtype)
    nv_j, nv_t = _pair(rng, (B_D, 1, 1, D_D), dtype)
    split = dops.mma_plan(B_D, G_D, 1, smax, PAGE_D, D_D, I8).split
    pos = np.array([0, 31, 32, 63, smax - 1], np.int32)
    got = dref.paged_decode_int8_mma_ref(q_t, kc, vc, ks, vs, nk_t, nv_t,
                                         torch.from_numpy(pos), split=split)
    want = jattn.paged_decode_attention(
        q_j, jnp.asarray(kc.numpy()), jnp.asarray(vc.numpy()), nk_j, nv_j,
        jnp.asarray(pos), batch_axes=None, page_axes=None,
        k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy()))[0]
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


# ------------------------------------------------ the prefill's plain model

@pytest.mark.parametrize("dtype", [F32, BF16], ids=str)
def test_prefill_tiled_model_matches_pallas_at_pos0(dtype):
    """A 512-token chunk at position 0, D 128, G 2 (the training loss's
    head layout): the Hopper instance's tiled arithmetic against the Pallas
    kernel's causal attention."""
    rng = np.random.default_rng(24)
    b, c, hkv, g, d = 1, 512, 2, 2, 128
    q_j, q_t = _pair(rng, (b, c, hkv * g, d), dtype)
    k_j, k_t = _pair(rng, (b, c, hkv, d), dtype)
    v_j, v_t = _pair(rng, (b, c, hkv, d), dtype)
    got = fref.flash_prefill_tiled_ref(q_t, k_t, v_t,
                                       torch.zeros(b, dtype=torch.int32))
    want = jax_attention(q_j, k_j, v_j, causal=True)
    assert got.dtype == dtype and got.shape == q_t.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", [F32, BF16], ids=str)
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_prefill_tiled_model_matches_chunk_prefill(dtype, softcap):
    """A ragged 37-token chunk at pos > 0 (one row ending at the cache's
    last key, one crossing a 128-key tile edge): the tiled model against
    the serving path's jnp chunk_prefill_attention (the Pallas kernel takes
    no offset)."""
    rng = np.random.default_rng(25)
    b, c, hkv, g, d, smax = 2, 37, 2, 2, 128, 300
    q_j, q_t = _pair(rng, (b, c, hkv * g, d), dtype)
    k_j, k_t = _pair(rng, (b, smax, hkv, d), dtype)
    v_j, v_t = _pair(rng, (b, smax, hkv, d), dtype)
    pos = np.array([smax - c, 110], np.int32)
    got = fref.flash_prefill_tiled_ref(q_t, k_t, v_t, torch.from_numpy(pos),
                                       softcap)
    want = jattn.chunk_prefill_attention(q_j, k_j, v_j, jnp.asarray(pos),
                                         logit_softcap=softcap)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
