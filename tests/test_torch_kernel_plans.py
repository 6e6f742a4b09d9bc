"""Launch plans of the two attention kernels, and their arithmetic, on the CPU.

``csrc/flash_prefill.cu`` and ``csrc/paged_decode.cu`` take their launch
(grid, rows or tokens per CTA, pipeline stages, shared memory, workspace)
as given from ``plan()`` in their wrappers; the kernels run only on the
card, so what surrounds them is checked here: every shape that
``chip_smoke.py`` and the three full-width serving paths use must fit the
H100's 232,448 bytes of shared memory a block, decode splits must cover
the cache exactly once on page boundaries with tiles that never cross a
page, and the bf16 prefill grid must fill the card's 132 SMs at qwen3's
chunk. The f32 prefill's 3xTF32 plans and the SSD scan's splits are
checked in ``tests/test_torch_tf32_ssd.py``.

The decode kernel's split-and-merge arithmetic (per-split ``acc``, max and
sum, merged in split order) is written out plainly in
``ref.paged_decode_split_ref`` and held to the Pallas kernel (interpret
mode, slot by slot, since it takes one scalar ``kv_len``) and to its jnp
oracle. Tolerances follow ``tests/test_kernel_parity.py``: f32 3e-5 (sums
over a few hundred keys in another order), bf16 2e-2 (the inputs' and
output's rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode as jax_decode
from repro.kernels.decode_attention.ref import paged_flash_decode_ref
from repro.models import attention as jattn
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.decode_attention import ref as dref
from repro_torch.kernels.flash_attention import ops as fops

MAX_SMEM = 232448
N_SMS = 132
BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8

# (b, h, hkv, smax, page, d): the serving paths at full width (8 slots x
# 2048 tokens in pages of 256; glm4-9b's G 16 and starcoder2-15b's G 12
# split over two CTAs each), chip_smoke.py's edge shapes (G = 1 and
# G = 8 at D 128, up to 9 slots), and the smoke models (2 slots x 64 tokens
# in pages of 8, D 16)
DECODE_SHAPES = {
    "qwen3-1.7b": (8, 16, 8, 2048, 256, 128),
    "glm4-9b": (8, 32, 2, 2048, 256, 128),
    "starcoder2-15b": (8, 48, 4, 2048, 256, 128),
    "zamba2-2.7b": (8, 32, 32, 2048, 256, 80),
    "edges G=1": (9, 8, 8, 2048, 256, 128),
    "edges G=8": (9, 16, 2, 2048, 256, 128),
    "smoke": (2, 4, 4, 64, 8, 16),
}
# (b, c, h, hkv, smax, d): chunks of 256 (and 37, ragged) at both paths'
# widths, G = 8 and D 64 from chip_smoke.py's edges, the smoke models' chunk
PREFILL_SHAPES = {
    "qwen3-1.7b": (1, 256, 16, 8, 2048, 128),
    "zamba2-2.7b": (1, 256, 32, 32, 2048, 80),
    "ragged G=2": (2, 37, 16, 8, 2048, 128),
    "ragged G=1": (2, 37, 32, 32, 2048, 80),
    "G=8": (2, 256, 16, 2, 2048, 128),
    "D=64": (2, 37, 16, 8, 2048, 64),
    "smoke": (2, 8, 4, 4, 64, 16),
    "gemma-2b": (1, 256, 8, 1, 2048, 256),
    "ragged D=256 G=1": (2, 37, 8, 8, 2048, 256),
    "ragged D=256 G=8": (2, 37, 8, 1, 2048, 256),
}


@pytest.mark.parametrize("kv_dtype", [BF16, F32, I8], ids=str)
@pytest.mark.parametrize("shape", DECODE_SHAPES.values(),
                         ids=DECODE_SHAPES.keys())
def test_decode_plan_splits_tiles_and_fits(shape, kv_dtype):
    b, h, hkv, smax, page, d = shape
    p = dops.plan(b, h, hkv, smax, page, d, kv_dtype)
    assert p.smem_bytes <= MAX_SMEM
    # splits covering [0, smax) exactly once: whole pages on the lanes
    # instance, whole 32-token tiles on the tensor-core one (G >= 4 at
    # D 128 in bf16 q, the group in one CTA of 16 rows)
    step = page if p.kernel == "lanes" else p.tile
    assert p.split % step == 0
    cover = np.zeros(smax, np.int64)
    for si in range(p.n_splits):
        lo, hi = si * p.split, min(smax, (si + 1) * p.split)
        assert lo < hi and lo % step == 0
        cover[lo:hi] += 1
    np.testing.assert_array_equal(cover, 1)
    # tiles never cross a page
    assert page % p.tile == 0 and p.split % p.tile == 0
    g = h // hkv
    if p.kernel == "mma":
        assert g >= dops.MMA_MIN_GROUP and d in dops.MMA_HEAD_DIMS
        assert (p.tile, p.group_pad, p.group_rows, p.group_chunks) == (
            dops.MMA_TILE, dops.MMA_ROWS, g, 1)
        assert p.n_splits * hkv * b >= dops.MMA_MIN_CTAS or (
            p.split == dops.MMA_TILE)
        assert p.part_acc == (b, hkv, p.n_splits, g, d)
        assert p.counters == (b, hkv, 1)
        return
    # a tile is at most 4 rows per row slot; a row is 16-byte chunks on a
    # power-of-two group of lanes
    assert p.tile <= dops.ROWS_PER_THREAD * (dops.THREADS // p.lanes)
    row_bytes = d * kv_dtype.itemsize
    assert row_bytes % 16 == 0 and p.lanes * 16 >= row_bytes
    assert p.lanes & (p.lanes - 1) == 0 and p.lanes <= 32
    # the group: CTAs of equal rows (at most MAX_GROUP, none empty) that
    # cover it once, on the smallest instance that holds the rows
    assert p.group_rows <= dops.MAX_GROUP and p.group_rows <= p.group_pad
    assert p.group_chunks == -(-g // dops.MAX_GROUP)
    assert (p.group_chunks - 1) * p.group_rows < g
    assert g <= p.group_chunks * p.group_rows
    assert p.group_pad == (2 if p.group_rows <= 2 else 8)
    assert p.part_acc == (b, hkv, p.n_splits, g, d)
    assert p.part_ml == (b, hkv, p.n_splits, g, 2)
    assert p.counters == (b, hkv, p.group_chunks)


def test_decode_plan_main_path_numbers():
    """qwen3-1.7b's tick: 8 splits of one 256-token page, 8 KB tiles of
    K and V (32 bf16 tokens, 64 int8 ones), 4 stages."""
    bf = dops.plan(8, 16, 8, 2048, 256, 128, BF16)
    i8 = dops.plan(8, 16, 8, 2048, 256, 128, I8)
    assert (bf.split, bf.n_splits, bf.tile, bf.stages) == (256, 8, 32, 4)
    assert (i8.tile, i8.lanes, bf.lanes) == (64, 8, 16)
    assert bf.tile * 128 * 2 == i8.tile * 128 == 8192
    assert dops.split_count(2048) == 8 and dops.split_count(64, 8) == 1


@pytest.mark.parametrize("args", [
    (8, 20, 8, 2048, 256, 128, BF16),    # 20 query heads over 8 kv heads
    (8, 16, 8, 2048, 256, 256, F32),     # a row of 64 chunks
    (8, 16, 8, 2000, 256, 128, BF16),    # cache not whole pages
])
def test_decode_plan_rejects(args):
    with pytest.raises(ValueError):
        dops.plan(*args)


def test_decode_workspace_is_made_once():
    p = dops.plan(2, 4, 4, 64, 8, 16, F32)
    dev = torch.device("cpu")
    first = dops._workspace(dev, p)
    again = dops._workspace(dev, p)
    assert all(a is b for a, b in zip(first, again))
    assert first[2].dtype == torch.int32 and not first[2].any()
    dops._WORKSPACE.pop((dev, p.part_acc, p.counters))


@pytest.mark.parametrize("dtype", [BF16, F32], ids=str)
@pytest.mark.parametrize("shape", PREFILL_SHAPES.values(),
                         ids=PREFILL_SHAPES.keys())
def test_prefill_plan_rows_and_fits(shape, dtype):
    b, c, h, hkv, _, d = shape
    p = fops.plan(b, c, h, hkv, d, dtype)
    assert p.smem_bytes <= MAX_SMEM
    n_rows = c * (h // hkv)
    assert p.grid[1:] == (hkv, b)
    assert (p.grid[0] - 1) * p.rows < n_rows <= p.grid[0] * p.rows
    if d in fops.MMA_HEAD_DIMS:
        assert p.kernel == ("mma" if dtype == BF16 else "tf32")
        assert p.rows in (16, 32, 64) and p.stages >= 2
    elif d == 256 and dtype == BF16:
        assert p.kernel == "mma256"
        assert p.rows in (16, 32, 64) and p.stages in (2, 3)
    elif d == 256:
        assert p.kernel == "tf32_256"
        assert p.rows == 16 and p.stages in (2, 3)
    else:
        assert p.kernel == "scalar" and p.stages == 1


@pytest.mark.parametrize("name", ["qwen3-1.7b", "zamba2-2.7b"])
def test_prefill_plan_fills_the_card(name):
    """At the serving chunk the tensor-core grid has a CTA for every SM:
    qwen3's 512 rows per kv head x 8 kv heads in 16-row CTAs (256),
    zamba2's 256 x 32 in 32-row CTAs (256)."""
    b, c, h, hkv, _, d = PREFILL_SHAPES[name]
    p = fops.plan(b, c, h, hkv, d, BF16)
    assert p.kernel == "mma"
    assert p.grid[0] * p.grid[1] * p.grid[2] >= N_SMS
    assert (p.rows, p.grid[0] * p.grid[1]) == {"qwen3-1.7b": (16, 256),
                                               "zamba2-2.7b": (32, 256)}[name]


@pytest.mark.parametrize("rows,stages", [(16, 2), (16, 3), (16, 4),
                                         (32, 3), (64, 3)])
def test_prefill_mma_plans_at_qwen3_chunk(rows, stages):
    """The tensor-core plans chip_smoke.py times at qwen3's chunk: q's
    rows and a ring of ``stages`` 64-key K and V tiles, bf16 rows padded
    to D + 8, inside the block's shared memory; plan() takes 16 rows and
    3 stages of them."""
    p = fops.mma_plan(1, 256, 16, 8, 128, rows, stages)
    assert p.smem_bytes == 2 * 136 * (rows + stages * 2 * 64) <= MAX_SMEM
    assert p.grid == (512 // rows, 8, 1) and p.stages == stages
    assert fops.plan(1, 256, 16, 8, 128, BF16) == fops.mma_plan(
        1, 256, 16, 8, 128, 16, 3)


@pytest.mark.parametrize("d,dtype", [(16, BF16), (32, BF16), (256, BF16),
                                     (16, F32), (256, F32)], ids=str)
def test_prefill_plan_scalar_instances(d, dtype):
    """The head dims without a tensor-core instance stay on the scalar
    kernel in both dtypes (D 16 and 32), named by the plan (no kernel is
    tried in place of another). D 256 has its own tensor-core instances,
    "mma256" in bf16 and "tf32_256" in f32. f32 at the tensor-core head
    dims is checked in ``tests/test_torch_tf32_ssd.py``."""
    want = {256: "mma256" if dtype == BF16 else "tf32_256"}.get(d, "scalar")
    assert fops.plan(1, 256, 16, 8, d, dtype).kernel == want


@pytest.mark.parametrize("rows,stages", [(16, 2), (16, 3), (32, 2), (32, 3),
                                         (64, 2)])
def test_prefill_d256_plans_at_gemma_chunk(rows, stages):
    """The D 256 plans chip_smoke.py times at gemma-2b's chunk (256 tokens
    x 8 query heads over one kv head: 2048 rows): q's rows and a ring of
    ``stages`` 64-key K and V tiles, bf16 rows padded to 264, inside the
    block's shared memory; the grid covers the 2048 rows once."""
    b, c, h, hkv, _, d = PREFILL_SHAPES["gemma-2b"]
    p = fops.d256_plan(b, c, h, hkv, rows, stages)
    fops.check_plan(p, b, c, h, hkv, d, BF16)
    assert p.smem_bytes == 2 * 264 * (rows + stages * 2 * 64) <= MAX_SMEM
    assert p.grid == (2048 // rows, 1, 1)
    assert p.grid[0] * p.rows == c * (h // hkv)


def test_prefill_d256_plan_at_gemma_chunk():
    """plan() names the D 256 instance at gemma's chunk with rows and
    stages it takes; the 64-row, 3-stage ring (236,544 bytes) and rows
    or stages outside its range are refused."""
    import dataclasses
    b, c, h, hkv, _, d = PREFILL_SHAPES["gemma-2b"]
    p = fops.plan(b, c, h, hkv, d, BF16)
    assert (p.kernel, p.rows, p.stages) == ("mma256", fops.D256_ROWS,
                                            fops.D256_STAGES)
    assert p.smem_bytes <= MAX_SMEM and p.grid[0] * p.rows == 2048
    for bad in (fops.d256_plan(b, c, h, hkv, 64, 3),
                dataclasses.replace(p, stages=4),
                dataclasses.replace(p, rows=48),
                dataclasses.replace(p, smem_bytes=p.smem_bytes - 16)):
        with pytest.raises(ValueError):
            fops.check_plan(bad, b, c, h, hkv, d, BF16)
    with pytest.raises(ValueError):
        fops.check_plan(p, b, c, h, hkv, d, F32)       # f32 runs tf32_256


# ------------------------------------------------- split-and-merge arithmetic

def _pair(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tol(dtype):
    return (dict(atol=2e-2, rtol=2e-2) if dtype == BF16
            else dict(atol=3e-5, rtol=3e-5))


@pytest.mark.parametrize("dtype", [F32, BF16], ids=str)
@pytest.mark.parametrize("g", [1, 2, 8])
def test_split_merge_matches_pallas_and_oracle(dtype, g):
    """Slots of length 1, 255, 256, 257 and Smax around the plan's
    256-token split (pages of 64, so a split is 4 pages): the split-and-
    merge arithmetic against the Pallas kernel, slot by slot, and its jnp
    oracle."""
    rng = np.random.default_rng(11)
    b, p, page, hkv, d = 5, 8, 64, 2, 16
    smax = p * page
    split = dops.plan(b, hkv * g, hkv, smax, page, d, dtype).split
    assert split == 256
    q_j, q_t = _pair(rng, (b, 1, hkv * g, d), dtype)
    k_j, k_t = _pair(rng, (b, p, page, hkv, d), dtype)
    v_j, v_t = _pair(rng, (b, p, page, hkv, d), dtype)
    kv_len = np.array([1, 255, 256, 257, smax], np.int32)
    got = dref.paged_decode_split_ref(q_t, k_t, v_t, torch.from_numpy(kv_len),
                                      split)
    assert got.dtype == dtype and got.shape == q_t.shape
    for i in range(b):
        n = int(kv_len[i])
        want = jax_decode(q_j[i:i + 1], k_j[i:i + 1], v_j[i:i + 1], n)
        np.testing.assert_allclose(_np(got[i:i + 1]), _np(want),
                                   **_tol(dtype))
        oracle = paged_flash_decode_ref(
            q_j[i:i + 1].reshape(1, hkv, g, d),
            jnp.moveaxis(k_j[i:i + 1], 3, 1),
            jnp.moveaxis(v_j[i:i + 1], 3, 1), n)
        np.testing.assert_allclose(_np(got[i]).reshape(hkv, g, d),
                                   _np(oracle)[0], **_tol(dtype))


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_split_merge_matches_plain_at_main_path(softcap):
    """At qwen3-1.7b's tick shape and chip_smoke.py's ragged lengths, the
    plan's splits merged in order equal the exact softmax (f32, 3e-5)."""
    b, h, hkv, smax, page, d = DECODE_SHAPES["qwen3-1.7b"]
    gen = torch.Generator().manual_seed(3)
    q = torch.randn((b, 1, h, d), generator=gen)
    k, v = (torch.randn((b, smax // page, page, hkv, d), generator=gen)
            for _ in range(2))
    kv_len = torch.tensor([1, smax, 300, 777, 1024, 1500, 64, smax - 1],
                          dtype=torch.int32)
    split = dops.plan(b, h, hkv, smax, page, d, F32).split
    got = dref.paged_decode_split_ref(q, k, v, kv_len, split, softcap)
    want = dref.paged_decode_ref(q, k, v, kv_len, softcap)
    torch.testing.assert_close(got, want, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("kv_dtype", [BF16, I8], ids=str)
@pytest.mark.parametrize("name", ["glm4-9b", "starcoder2-15b"])
def test_decode_plan_splits_the_group(name, kv_dtype):
    """G 16 (glm4-9b) and G 12 (starcoder2-15b) at full width, both modes:
    plan() runs the tensor-core instance (the whole group in one CTA); the
    lanes instance, which still takes the shape (f32 q, and chip_smoke.py's
    in-call comparison), splits it over two CTAs per kv head of 8 + 8 and
    6 + 6 query heads on the 8-row instance, q staged in shared memory,
    with the same shared memory as its G 2 ... 8 plans of the 8-row
    instance."""
    b, h, hkv, smax, page, d = DECODE_SHAPES[name]
    assert dops.plan(b, h, hkv, smax, page, d, kv_dtype).kernel == "mma"
    p = dops.lanes_plan(b, h, hkv, smax, page, d, kv_dtype)
    rows = {"glm4-9b": 8, "starcoder2-15b": 6}[name]
    assert (p.group_chunks, p.group_rows, p.group_pad) == (2, rows, 8)
    g8 = dops.lanes_plan(b, 8 * hkv, hkv, smax, page, d, kv_dtype)
    assert p.smem_bytes == g8.smem_bytes <= MAX_SMEM
    assert p.counters == (b, hkv, 2)
    assert (p.split, p.n_splits, p.stages) == (256, 8, 4)


def _ml_case(rng, b, hkv, g, d, p, page, dtype):
    q_j, q_t = _pair(rng, (b, 1, hkv * g, d), dtype)
    k_j, k_t = _pair(rng, (b, p, page, hkv, d), dtype)
    v_j, v_t = _pair(rng, (b, p, page, hkv, d), dtype)
    return (q_j, k_j, v_j), (q_t, k_t, v_t)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=str)
@pytest.mark.parametrize("g", [1, 2, 12, 16])
def test_decode_ml_matches_reference_partials(dtype, g):
    """``return_ml``'s (o, m, l) against the reference's
    ``_flash_decode_partial`` (acc, m, l) on the same inputs: o = acc / l,
    m in base 2 (the reference's natural-log max times log2 e), the same
    l; a slot with no visible token gives m = -inf, l = 0, o = 0 (the
    reference leaves its padding there, which the combine weighs by 0)."""
    rng = np.random.default_rng(5)
    b, p, page, hkv, d = 5, 4, 16, 2, 16
    (q_j, k_j, v_j), (q_t, k_t, v_t) = _ml_case(rng, b, hkv, g, d, p, page,
                                                dtype)
    kv_len = np.array([0, 1, 17, 63, 64], np.int32)
    o, m, l = dops.paged_decode(q_t, k_t, v_t, torch.from_numpy(kv_len),
                                return_ml=True)
    assert o.dtype == m.dtype == l.dtype == F32
    acc, jm, jl = jattn._flash_decode_partial(
        q_j, k_j.reshape(b, p * page, hkv, d), v_j.reshape(b, p * page, hkv,
                                                           d),
        jnp.asarray(kv_len))
    live = kv_len > 0
    want_o = (_np(acc) / _np(jl)[..., None]).reshape(b, 1, hkv * g, d)
    tol = dict(atol=3e-5, rtol=3e-5)       # both in f32 from equal inputs
    np.testing.assert_allclose(o.numpy()[live], want_o[live], **tol)
    np.testing.assert_allclose(m.numpy()[live], (_np(jm) / np.log(2.0))
                               .reshape(b, -1)[live], **tol)
    np.testing.assert_allclose(l.numpy()[live], _np(jl).reshape(b, -1)[live],
                               **tol)
    assert np.all(np.isneginf(m.numpy()[~live]))
    assert not l.numpy()[~live].any() and not o.numpy()[~live].any()


@pytest.mark.parametrize("g", [2, 12])
def test_decode_int8_ml_rank_view(g):
    """The int8 mode's (o, m, l) with an explicit local length and fresh
    row: two halves of the cache, each a rank's pages with its own
    ``kv_len`` (0 after the owner) and ``fresh`` (-1 where the new row is
    not its), combined as the cross-rank combine does (base 2), equal the
    one-rank int8 decode at ``pos`` (f32, 3e-5)."""
    from repro_torch.models import kv_quant
    rng = np.random.default_rng(7)
    b, p, page, hkv, d = 4, 4, 16, 2, 16
    smax, half = p * page, p * page // 2
    q = torch.from_numpy(rng.standard_normal((b, 1, hkv * g, d),
                                             dtype=np.float32))
    init = torch.full((b, p, hkv), kv_quant.INIT_SCALE)
    codes = [kv_quant.requantize_pages(torch.from_numpy(rng.standard_normal(
        (b, p, page, hkv, d), dtype=np.float32)), init) for _ in range(2)]
    (kc, ks), (vc, vs) = codes
    nk, nv = (torch.from_numpy(rng.standard_normal((b, 1, hkv, d),
                                                   dtype=np.float32))
              for _ in range(2))
    pos = torch.tensor([0, 20, 32, 63], dtype=torch.int32)
    want = dops.paged_decode(q, kc, vc, k_scale=ks, v_scale=vs, new_k=nk,
                             new_v=nv, pos=pos)
    parts = []
    for r in range(2):
        pages = slice(r * p // 2, (r + 1) * p // 2)
        off = pos - r * half
        kv_len = (off + 1).clamp(0, half).to(torch.int32)
        fresh = torch.where((off >= 0) & (off < half), off, -1).to(
            torch.int32)
        parts.append(dops.paged_decode(
            q, kc[:, pages].contiguous(), vc[:, pages].contiguous(),
            kv_len, k_scale=ks[:, pages].contiguous(),
            v_scale=vs[:, pages].contiguous(), new_k=nk, new_v=nv,
            fresh=fresh, return_ml=True))
    m_g = torch.maximum(parts[0][1], parts[1][1])
    w = [torch.exp2(m - m_g) for _, m, _ in parts]
    l_g = sum(l * wi for (_, _, l), wi in zip(parts, w))
    acc = sum(o * (l * wi)[:, None, :, None] for (o, _, l), wi in
              zip(parts, w))
    got = acc / l_g[:, None, :, None]
    torch.testing.assert_close(got, want, atol=3e-5, rtol=3e-5)


# ------------------------------------------------------- flash prefill

@pytest.mark.parametrize("dtype", [F32, BF16], ids=str)
@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("g", [1, 8])
def test_flash_prefill_plain_matches_chunk_prefill_d80(dtype, softcap, g):
    """The tensor-core instance's widths: D 80 (zamba2's shared block) at
    G = 1 and G = 8, a ragged 37-token chunk ending at the cache's end
    beside one at an offset past a block edge, against the serving path's
    jnp chunk_prefill_attention."""
    from repro_torch.kernels.flash_attention.ops import flash_prefill
    rng = np.random.default_rng(12)
    b, c, hkv, d, smax = 2, 37, 2, 80, 80
    q_j, q_t = _pair(rng, (b, c, hkv * g, d), dtype)
    k_j, k_t = _pair(rng, (b, smax, hkv, d), dtype)
    v_j, v_t = _pair(rng, (b, smax, hkv, d), dtype)
    pos = np.array([smax - c, 5], np.int32)
    want = jattn.chunk_prefill_attention(q_j, k_j, v_j, jnp.asarray(pos),
                                         logit_softcap=softcap)
    got = flash_prefill(q_t, k_t, v_t, torch.from_numpy(pos),
                        logit_softcap=softcap)
    assert got.dtype == dtype and got.shape == q_t.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", [F32, BF16], ids=str)
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_flash_prefill_plain_matches_chunk_prefill_d256(dtype, softcap):
    """The D 256 instance's widths at gemma-2b's heads (one kv head of 8
    query heads): a ragged 37-token chunk ending at the cache's end beside
    one at an offset past a block edge, against the serving path's jnp
    chunk_prefill_attention."""
    from repro_torch.kernels.flash_attention.ops import flash_prefill
    rng = np.random.default_rng(13)
    b, c, hkv, g, d, smax = 2, 37, 1, 8, 256, 72
    q_j, q_t = _pair(rng, (b, c, hkv * g, d), dtype)
    k_j, k_t = _pair(rng, (b, smax, hkv, d), dtype)
    v_j, v_t = _pair(rng, (b, smax, hkv, d), dtype)
    pos = np.array([smax - c, 9], np.int32)
    want = jattn.chunk_prefill_attention(q_j, k_j, v_j, jnp.asarray(pos),
                                         logit_softcap=softcap)
    got = flash_prefill(q_t, k_t, v_t, torch.from_numpy(pos),
                        logit_softcap=softcap)
    assert got.dtype == dtype and got.shape == q_t.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
