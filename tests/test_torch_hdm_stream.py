"""The port's paged weight-streaming matmul against the reference on the
CPU.

``repro_torch.kernels.hdm_stream.ops.stream_matmul`` (its plain version on
CPU tensors) against the reference's ``stream_matmul`` (the Pallas kernel
in interpret mode, as ``tests/test_kernels.py`` runs it) and its oracle
``paged_matmul_ref``, at the shapes of ``tests/test_kernels.py`` and
``HDM_SHAPES`` of ``tests/test_kernel_parity.py``: f32, bf16, and f32
weights that went through the int8 page format. Tolerances follow
``tests/test_kernel_parity.py``: f32 3e-5, bf16 2e-2. The CUDA kernel is
held to the plain version on the card by ``chip_smoke.py``; here its launch
plans (``ops.plan``: instance by dtype and M, K tiles inside a page,
K-splits and N strips covering the product once, shared memory, a grid
that fills the card), the skinny instances' split-K arithmetic
(``ref.paged_matmul_split_ref``, against the Pallas kernel and the oracle)
and the f32 tile instance's 3xTF32 product (``tf32.matmul_3xtf32`` over
the gathered pages, against the Pallas kernel in f32).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hdm_stream.ops import stream_matmul as jax_stream_matmul
from repro.kernels.hdm_stream.ref import paged_matmul_ref
from repro.models import kv_quant as jkvq
from repro_torch.kernels import tf32
from repro_torch.kernels.hdm_stream import ops
from repro_torch.kernels.hdm_stream.ref import paged_matmul_ref as plain_ref
from repro_torch.kernels.hdm_stream.ref import paged_matmul_split_ref

MAX_SMEM = 232448
N_SMS = 132
BF16, F32 = torch.bfloat16, torch.float32

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


# ------------------------------------------------------------ launch plans

# (m, k, n, page_k): qwen3-1.7b's MLP width as chip_smoke.py runs it (the
# decode batch and a prefill chunk), M 16/17 around the skinny edge, and
# the shapes above
PLAN_SHAPES = {
    "qwen3 M=8": (8, 2048, 6144, 256),
    "qwen3 M=16": (16, 2048, 6144, 256),
    "qwen3 M=17": (17, 2048, 6144, 256),
    "qwen3 M=256": (256, 2048, 6144, 256),
    "pages of 64": (8, 512, 128, 64),
    **{f"test {s[:4]}": s[:4] for s in SHAPES},
}


@pytest.mark.parametrize("dtype", [BF16, F32], ids=str)
@pytest.mark.parametrize("shape", PLAN_SHAPES.values(),
                         ids=PLAN_SHAPES.keys())
def test_plan_instance_tiles_and_cover(shape, dtype):
    m, k, n, page_k = shape
    p = ops.plan(m, k, n, page_k, dtype)
    ops.check_plan(p, m, k, n, page_k, dtype)
    assert p.smem_bytes <= MAX_SMEM
    if n % (8 if dtype == BF16 else 4) or page_k % 64:
        assert p.instance == "scalar"
        return
    skinny, tile = ops.INSTANCES[dtype][0]
    assert p.instance == (skinny if m <= ops.SKINNY_M else tile)
    # K tiles never cross a page
    assert page_k % p.tile_k == 0 and k % p.tile_k == 0
    # the K-splits cover K's tiles exactly once, in order, none empty
    cover = np.zeros(k // p.tile_k, np.int64)
    for s in range(p.splits):
        lo = s * p.tiles_per_split
        hi = min(k // p.tile_k, lo + p.tiles_per_split)
        assert lo < hi
        cover[lo:hi] += 1
    np.testing.assert_array_equal(cover, 1)
    # N strips (and M tiles) cover the product once
    assert (p.grid[0] - 1) * p.tile_n < n <= p.grid[0] * p.tile_n
    if p.instance == skinny:
        assert m <= p.tile_m == 16 and p.grid[1] == p.splits
        assert p.workspace == ((p.splits, m, n) if p.splits > 1 else ())
        assert p.counters == (p.grid[0] if p.splits > 1 else 0)
    else:
        assert p.splits == 1 and p.workspace == ()
        assert (p.grid[1] - 1) * p.tile_m < m <= p.grid[1] * p.tile_m


@pytest.mark.parametrize("m", [8, 256])
def test_plan_fills_the_card_at_qwen3_mlp(m):
    """The decode batch and a prefill chunk at qwen3-1.7b's MLP width both
    put at least one CTA on every SM: 96 strips x 4 K-splits (384) at
    M = 8, 48 x 2 (or 96 x 2) block tiles at M = 256."""
    p = ops.plan(m, 2048, 6144, 256, BF16)
    assert p.grid[0] * p.grid[1] >= N_SMS
    if m == 8:
        assert (p.instance, p.grid, p.splits) == ("skinny", (96, 4), 4)
    else:
        assert p.instance == "tile" and p.tile_m * p.tile_n <= 128 * 128


@pytest.mark.parametrize("change,exc", [
    (dict(splits=3), ValueError),                 # splits leave tiles out
    (dict(stages=5), ValueError),                 # past the ring's depth
    (dict(smem_bytes=1024), ValueError),          # too little shared memory
    (dict(instance="tile"), ValueError),          # the wrong instance
])
def test_check_plan_refuses(change, exc):
    import dataclasses
    p = ops.plan(8, 2048, 6144, 256, BF16)
    with pytest.raises(exc):
        ops.check_plan(dataclasses.replace(p, **change), 8, 2048, 6144, 256,
                       BF16)


def test_check_plan_refuses_tiles_across_pages_and_f32():
    p = ops.plan(8, 2048, 6144, 256, BF16)
    with pytest.raises(ValueError, match="cross"):
        ops.check_plan(p, 8, 2048, 6144, 32, BF16)
    with pytest.raises(ValueError, match="bf16"):
        ops.check_plan(p, 8, 2048, 6144, 256, F32)
    tile = ops.plan(256, 2048, 6144, 256, BF16)
    with pytest.raises(ValueError):
        ops.check_plan(tile, 8, 2048, 6144, 256, BF16)   # M 8 on "tile"


# ------------------------------------------------- split-K arithmetic

SPLIT_SHAPES = SHAPES + [(8, 128, 64, 32, 6, 8, 32)]     # and the M = 8 case


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_split_ref_matches_reference(shape, splits, name):
    """K cut into ``splits`` runs, partials added in split order, against
    the Pallas kernel (interpret mode) and the oracle."""
    m, k, n, page_k, n_pages, bm, bn = shape
    x, w, pids = _inputs(shape, 3)
    jdt, tdt = DTYPES[name]
    rows = -(-k // splits)
    got = paged_matmul_split_ref(torch.from_numpy(x).to(tdt),
                                 torch.from_numpy(w).to(tdt),
                                 torch.from_numpy(pids), rows)
    assert got.dtype == tdt and got.shape == (m, n)
    xj, wj = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    kernel = jax_stream_matmul(xj, wj, jnp.asarray(pids), block_m=bm,
                               block_n=bn)
    oracle = paged_matmul_ref(xj, wj, jnp.asarray(pids))
    for want in (kernel, oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **_tol(name))


def test_split_ref_at_the_plan_matches_plain():
    """At the M = 8 plan's K-splits (4 runs of 512 rows) the split sum
    equals the plain version within f32 3e-5 (sums in another order)."""
    p = ops.plan(8, 2048, 6144, 256, BF16)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((8, 2048), generator=gen)
    w = torch.randn((16, 256, 6144), generator=gen) * 0.02
    ids = torch.randperm(16, generator=gen)[:8].to(torch.int32)
    got = paged_matmul_split_ref(x, w, ids, p.tiles_per_split * p.tile_k)
    torch.testing.assert_close(got, plain_ref(x, w, ids), atol=3e-5,
                               rtol=3e-5)


# ------------------------------------------------------- f32 instances

F32_TOL = dict(atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("shape,want", [
    ((8, 2048, 6144, 256), "skinny_f32"),     # qwen3's decode batch
    ((16, 2048, 6144, 256), "skinny_f32"),
    ((17, 2048, 6144, 256), "tile_f32"),
    ((256, 2048, 6144, 256), "tile_f32"),     # qwen3's prefill chunk
    ((8, 512, 128, 64), "skinny_f32"),
    ((256, 2048, 6144, 32), "scalar"),        # pages of half a K tile
    ((8, 2048, 6146, 256), "scalar"),         # N not in 16-byte chunks
    ((256, 2048, 6146, 256), "scalar"),
    ((256, 2048, 6148, 256), "tile_f32"),     # 16-byte chunks, not 8 bf16
], ids=str)
def test_f32_plan_instance(shape, want):
    """f32 goes to skinny_f32 at M <= 16 and tile_f32 above it; pages
    that are not whole 64-deep K tiles and a ragged N to the scalar
    instance, and only those."""
    m, k, n, page_k = shape
    p = ops.plan(m, k, n, page_k, F32)
    assert p.instance == want
    ops.check_plan(p, m, k, n, page_k, F32)
    if want != "scalar":
        with pytest.raises(ValueError):
            ops.check_plan(ops.scalar_plan(m, k, n, page_k), m, k, n,
                           page_k, F32)


@pytest.mark.parametrize("m", [8, 256])
def test_f32_plan_fills_the_card_at_qwen3_mlp(m):
    """Both f32 instances put at least one CTA on every SM at qwen3-1.7b's
    MLP width: 96 strips x 4 K-splits at M = 8, 96 x 4 blocks of 64 x 64
    at M = 256."""
    p = ops.plan(m, 2048, 6144, 256, F32)
    assert p.grid[0] * p.grid[1] >= N_SMS and p.smem_bytes <= MAX_SMEM
    assert p.instance == ("skinny_f32" if m == 8 else "tile_f32")
    if m == 8:
        assert p.grid == (96, 4) and p.workspace == (4, 8, 6144)


@pytest.mark.parametrize("plan_fn,args", [
    ("skinny", (2,)), ("skinny", (4,)), ("skinny", (8,)),
    *[("tile", t) for t in ops.TILE_F32_SHAPES]], ids=str)
@pytest.mark.parametrize("stages", [2, 3, 4])
def test_f32_sweep_plans_fit(plan_fn, args, stages):
    """Every plan of chip_smoke.py's f32 sweeps at M 8 and 256: f32 rows
    (skinny: 64 floats of W and of x; tile: x's padded to 68, W's to
    tile_n + 8), inside a block unless refused."""
    if plan_fn == "skinny":
        m, p = 8, ops.skinny_plan(8, 2048, 6144, *args, stages, F32)
        assert p.smem_bytes == 4 * stages * (64 * 64 + 16 * 64)
    else:
        m, p = 256, ops.tile_plan(256, 2048, 6144, *args, stages, F32)
        tm, tn = args
        assert p.smem_bytes == 4 * stages * (tm * 68 + 64 * (tn + 8))
        assert p.threads == (256 if tn == 96 else
                             tm // (32 if tm == 64 else 64) * tn // 32 * 32)
    if p.smem_bytes > MAX_SMEM:
        with pytest.raises(ValueError):
            ops.check_plan(p, m, 2048, 6144, 256, F32)
    else:
        ops.check_plan(p, m, 2048, 6144, 256, F32)


@pytest.mark.parametrize("case", ["skinny_f32 on bf16", "skinny_f32 M 17",
                                  "tile_f32 on M 8", "tile_f32 96x64",
                                  "tile on f32", "skinny on f32",
                                  "tile 128x96 bf16"])
def test_f32_check_plan_refuses(case):
    skf = ops.plan(8, 2048, 6144, 256, F32)
    tlf = ops.plan(256, 2048, 6144, 256, F32)
    bad, m, dtype = {
        "skinny_f32 on bf16": (skf, 8, BF16),
        "skinny_f32 M 17": (skf, 17, F32),
        "tile_f32 on M 8": (tlf, 8, F32),
        "tile_f32 96x64": (dataclasses.replace(tlf, tile_m=96), 256, F32),
        "tile on f32": (ops.plan(256, 2048, 6144, 256, BF16), 256, F32),
        "skinny on f32": (ops.plan(8, 2048, 6144, 256, BF16), 8, F32),
        "tile 128x96 bf16": (ops.tile_plan(256, 2048, 6144, 128, 96, 2,
                                               BF16), 256, BF16),
    }[case]
    with pytest.raises(ValueError):
        ops.check_plan(bad, m, 2048, 6144, 256, dtype)


# (M, K, N, page_k, n_pages, block_m, block_n): the decode batch and a
# block-tile M at f32 instances' shapes, small enough for interpret mode
F32_SHAPES = [(8, 512, 128, 64, 12, 8, 64), (16, 256, 192, 128, 3, 16, 64),
              (64, 512, 128, 64, 10, 32, 64), (96, 256, 256, 128, 4, 32, 128)]


def _pallas_f32(shape, seed):
    m, k, n, page_k, n_pages, bm, bn = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((n_pages, page_k, n)) * 0.02).astype(np.float32)
    pids = rng.permutation(n_pages)[:k // page_k].astype(np.int32)
    want = np.asarray(jax_stream_matmul(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(pids), block_m=bm,
                                        block_n=bn))
    return [torch.from_numpy(a) for a in (x, w, pids)], want


@pytest.mark.parametrize("shape", F32_SHAPES[:2], ids=str)
def test_skinny_f32_split_sum_matches_pallas(shape):
    """skinny_f32's arithmetic at its plan: f32 partials over the plan's
    K-splits, added in split order, against the Pallas kernel in f32."""
    (x, w, pids), want = _pallas_f32(shape, 6)
    m, k, n, page_k = shape[:4]
    p = ops.plan(m, k, n, page_k, F32)
    assert p.instance == "skinny_f32" and p.splits > 1
    got = paged_matmul_split_ref(x, w, pids, p.tiles_per_split * p.tile_k)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("shape", F32_SHAPES[2:], ids=str)
def test_tile_f32_3xtf32_matches_pallas(shape):
    """tile_f32's arithmetic: the 3xTF32 product of x and the gathered
    pages against the Pallas kernel in f32 at 3e-5, where one TF32
    product misses 1e-4."""
    (x, w, pids), want = _pallas_f32(shape, 7)
    m, k, n, page_k = shape[:4]
    assert ops.plan(m, k, n, page_k, F32).instance == "tile_f32"
    wg = w[pids.long()].reshape(k, n)
    np.testing.assert_allclose(tf32.matmul_3xtf32(x, wg).numpy(), want,
                               **F32_TOL)
    assert not np.allclose(tf32.matmul_tf32(x, wg).numpy(), want,
                           atol=1e-4, rtol=1e-4)
