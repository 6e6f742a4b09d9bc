"""The f32 tensor-core arithmetic and the split SSD scan, on the CPU.

``csrc/flash_prefill.cu``'s f32 kernel and ``csrc/ssd_scan.cu`` run their
products on tensor cores in error-compensated 3xTF32, and the SSD kernel
cuts the token axis into spans chained in order inside one launch. The
kernels run only on the card (``chip_smoke.py``); here their arithmetic is
written plainly and held to the reference:

* ``tf32.tf32_round`` does what ``cvt.rna.tf32.f32`` does, and with it the
  3xTF32 product meets the f32 tolerance (3e-5, ``tests/test_kernel_parity
  .py``) where one TF32 product misses 1e-4 -- for the f32 prefill's plain
  version at the int8 path's chunk and for the SSD's four products at
  zamba2's widths;
* ``ref.ssd_split_ref`` (per-span zero-state scans, then the chain) against
  the reference's Pallas ``ssd`` (interpret mode off the TPU) and its
  ``ssd_scan_ref`` oracle at ``tests/test_kernels.py``'s shapes plus a
  ragged S, from a nonzero state, at that test's 1e-4;
* the f32 prefill at D 256 (gemma-2b with int8 pages): its arithmetic,
  3xTF32 products of Q K^T over the head dim's four quarters added in
  quarter order (``tf32.matmul_3xtf32_parts``), then P V in 3xTF32, meets
  the reference's Pallas ``flash_attention`` in f32 (interpret mode off
  the TPU, as ``tests/test_kernel_parity.py`` runs it) at 3e-5, at one
  kv head, G 1 and 8, softcap 0 and 30, where one TF32 product misses
  1e-4;
* ``plan()`` of both kernels: shared memory within the H100's 232,448
  bytes a block, spans covering S exactly once on sub-chunk boundaries,
  the f32 prefill plans at the int8 chunk and at gemma-2b's, and the
  plans the C entries refuse.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import attention as jax_attention
from repro.kernels.mamba2_scan.ops import ssd as jax_ssd
from repro.kernels.mamba2_scan.ref import ssd_scan_ref
from repro_torch.kernels import tf32
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.mamba2_scan import ops as sops
from repro_torch.kernels.mamba2_scan import ref as sref

F32_TOL = dict(atol=3e-5, rtol=3e-5)     # tests/test_kernel_parity.py
CARD_TOL = dict(atol=1e-4, rtol=1e-4)    # chip_smoke.py's f32 gate
SSD_TOL = dict(atol=1e-4, rtol=1e-4)     # tests/test_kernels.py::test_ssd_scan
MAX_SMEM = 232448
F32 = torch.float32


def _misses(got, want, tol):
    return not torch.allclose(got, want, **tol)


# ------------------------------------------------------------ tf32_round

@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1 + 2 ** -11, 1 + 2 ** -10),            # a tie: away from zero
    (1 + 3 * 2 ** -11, 1 + 2 ** -9),         # a tie on an odd last place
    (-(1 + 2 ** -11), -(1 + 2 ** -10)),      # ties away on both signs
    (1 + 2 ** -10 + 2 ** -12, 1 + 2 ** -10),  # under half: down
    (1 + 2 ** -10 + 2 ** -11 + 2 ** -20, 1 + 2 ** -9),  # over half: up
    (2 - 2 ** -23, 2.0),                     # carries into the exponent
])
def test_tf32_round_is_cvt_rna(x, want):
    got = tf32.tf32_round(torch.tensor([x], dtype=F32))
    np.testing.assert_equal(got.numpy(), np.float32(want))


def test_tf32_round_keeps_ten_bits_and_splits():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 1e3)
    hi, lo = tf32.split_tf32(x)
    for t in (hi, lo):
        assert not (t.view(torch.int32) & 0x1FFF).any()
        torch.testing.assert_close(tf32.tf32_round(t), t, atol=0, rtol=0)
    # nearest: within half of TF32's last place (2^-11 of the value)
    assert float(((hi - x).abs() / x.abs()).max()) <= 2 ** -11
    # hi + lo holds x to ~2^-21 (lo truncated, as the tensor core reads it)
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2 ** -20


# ------------------------------------------------------ 3xTF32 vs f32

@pytest.mark.parametrize("b,c,h,hkv,smax,d,p0", [
    (1, 256, 16, 8, 2048, 128, 300),     # the int8 path's chunk (qwen3)
    (1, 256, 32, 32, 2048, 80, 300),     # zamba2's shared block in f32
], ids=["qwen3-int8-chunk", "zamba2-d80"])
def test_prefill_3xtf32_meets_f32_and_one_tf32_misses(b, c, h, hkv, smax, d,
                                                      p0):
    gen = torch.Generator().manual_seed(5)
    q = torch.randn((b, c, h, d), generator=gen)
    k, v = (torch.randn((b, smax, hkv, d), generator=gen) for _ in range(2))
    pos = torch.tensor([p0], dtype=torch.int32)
    want = fref.flash_prefill_ref(q, k, v, pos)
    three = fref.flash_prefill_ref(q, k, v, pos, mm=tf32.matmul_3xtf32)
    one = fref.flash_prefill_ref(q, k, v, pos, mm=tf32.matmul_tf32)
    torch.testing.assert_close(three, want, **F32_TOL)
    assert _misses(one, want, CARD_TOL)


def _subchunk(seed=6, h=80, p=64, n=64, q=64):
    """One 64-token sub-chunk at zamba2's widths (80 heads, P = N = 64),
    the scales of chip_smoke.py's SSD inputs, and a state of unit scale."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((h, q, p), generator=g)
    bm = torch.randn((1, q, n), generator=g) * 0.5
    cm = torch.randn((1, q, n), generator=g) * 0.5
    lq = torch.cumsum(-torch.rand((h, q), generator=g) * 0.2, dim=-1)
    state = torch.randn((h, p, n), generator=g)
    causal = torch.ones(q, q, dtype=torch.bool).tril()
    m = torch.where(causal, (cm @ bm.transpose(-1, -2))
                    * torch.exp(lq[:, :, None] - lq[:, None, :]), 0.0)
    w = torch.exp(lq[:, -1:] - lq)
    return {"C B^T": (cm, bm.transpose(-1, -2)),
            "M xdt": (m, x),
            "C h^T": (cm, state.transpose(-1, -2)),
            "(xdt w)^T B": ((x * w[..., None]).transpose(-1, -2), bm)}


@pytest.mark.parametrize("product", ["C B^T", "M xdt", "C h^T",
                                     "(xdt w)^T B"])
def test_ssd_products_3xtf32_meet_f32_and_one_tf32_misses(product):
    a, b = _subchunk()[product]
    want = torch.matmul(a, b)
    torch.testing.assert_close(tf32.matmul_3xtf32(a, b), want, **F32_TOL)
    assert _misses(tf32.matmul_tf32(a, b), want, CARD_TOL)


def test_ssd_split_3xtf32_meets_f32_at_zamba2_chunk():
    """The whole split scan at zamba2's chunk (S 256, 80 heads, P = N =
    64, 4 spans) from a nonzero state, its four products in 3xTF32."""
    g = torch.Generator().manual_seed(7)
    b, s, h, p, n = 1, 256, 80, 64, 64
    x = torch.randn((b, s, h, p), generator=g)
    bm, cm = (torch.randn((b, s, n), generator=g) * 0.5 for _ in range(2))
    la = -torch.rand((b, s, h), generator=g) * 0.2
    h0 = torch.randn((b, h, p, n), generator=g)
    want = sref.ssd_split_ref(x, bm, cm, la, h0)
    three = sref.ssd_split_ref(x, bm, cm, la, h0, mm=tf32.matmul_3xtf32)
    one = sref.ssd_split_ref(x, bm, cm, la, h0, mm=tf32.matmul_tf32)
    for got3, got1, ref in zip(three, one, want):
        torch.testing.assert_close(got3, ref, **F32_TOL)
        assert _misses(got1, ref, CARD_TOL)


# ------------------------------------------- the split scan vs the reference

# tests/test_kernels.py::test_ssd_scan's shapes, then a ragged S
SSD_SHAPES = [(1, 32, 2, 8, 16, 16), (2, 64, 3, 8, 16, 32),
              (1, 64, 1, 16, 8, 64), (1, 96, 2, 16, 16, 32)]
# (spans, sub-chunk): the kernel's 64-token sub-chunks, and sub-chunks of
# 8 tokens in 3 spans, so that the short sequences cross spans too
SPLITS = [(4, 64), (3, 8)]


def _inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((b, s, h, p)).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    la = (-np.abs(rng.standard_normal((b, s, h))) * 0.1).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return xdt, bm, cm, la, h0


def _reference(xdt, bm, cm, la, chunk):
    """The Pallas ssd (interpret mode) and the oracle, both from zero."""
    b, s, h, p = xdt.shape
    n = bm.shape[2]
    pallas = np.asarray(jax_ssd(jnp.asarray(xdt), jnp.asarray(bm),
                                jnp.asarray(cm), jnp.asarray(la),
                                chunk=chunk))
    c = s // chunk
    lac = jnp.moveaxis(jnp.cumsum(jnp.asarray(la).reshape(b, c, chunk, h),
                                  axis=2), 3, 1)
    oracle = ssd_scan_ref(
        jnp.moveaxis(jnp.asarray(xdt).reshape(b, c, chunk, h, p), 3, 1),
        jnp.asarray(bm).reshape(b, c, chunk, n),
        jnp.asarray(cm).reshape(b, c, chunk, n), lac)
    oracle = np.asarray(jnp.moveaxis(oracle, 1, 3).reshape(b, s, h, p))
    return pallas, oracle


@pytest.mark.parametrize("splits,sub", SPLITS)
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
def test_ssd_split_matches_pallas_and_oracle_from_a_state(b, s, h, p, n,
                                                          chunk, splits, sub):
    """The sequence's first 30% (ragged) scanned first gives a nonzero
    state; the split scan of the rest from it, joined to the first part,
    equals the reference's scan of the whole, and its last state the
    recurrence's."""
    xdt, bm, cm, la, _ = _inputs(0, b, s, h, p, n)
    pallas, oracle = _reference(xdt, bm, cm, la, chunk)
    full = [torch.from_numpy(a) for a in (xdt, bm, cm, la)]
    s1 = int(s * 0.3)
    y1, h1 = sref.ssd_split_ref(*(a[:, :s1] for a in full), splits=splits,
                                sub=sub)
    assert float(h1.abs().max()) > 0.1
    y2, h2 = sref.ssd_split_ref(*(a[:, s1:] for a in full), h0=h1,
                                splits=splits, sub=sub)
    y = torch.cat([y1, y2], 1).numpy()
    np.testing.assert_allclose(y, pallas, **SSD_TOL)
    np.testing.assert_allclose(y, oracle, **SSD_TOL)
    _, h_rec = sref.ssd_recurrent_ref(*full)
    np.testing.assert_allclose(h2.numpy(), h_rec.numpy(), **SSD_TOL)


@pytest.mark.parametrize("splits,sub", SPLITS + [(1, 64), (2, 16)])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
def test_ssd_split_matches_chunked_and_recurrence(b, s, h, p, n, chunk,
                                                  splits, sub):
    """From a random nonzero h0: the split scan against the wrapper's CPU
    form (the chunked einsum) and the recurrence, y and h_last."""
    xdt, bm, cm, la, h0 = (torch.from_numpy(a)
                           for a in _inputs(1, b, s, h, p, n))
    y, h_last = sref.ssd_split_ref(xdt, bm, cm, la, h0, splits, sub)
    y_c, h_c = sops.ssd(xdt, bm, cm, la, h0=h0, chunk=chunk)
    y_r, h_r = sref.ssd_recurrent_ref(xdt, bm, cm, la, h0)
    for got, want in ((y, y_c), (y, y_r), (h_last, h_c), (h_last, h_r)):
        torch.testing.assert_close(got, want, **SSD_TOL)


# ----------------------------------------------------------------- plans

@pytest.mark.parametrize("s", [1, 44, 63, 64, 65, 128, 200, 256, 300, 1000])
@pytest.mark.parametrize("splits", [1, 2, 4])
def test_ssd_plan_spans_cover_s_once(s, splits):
    pl = sops.split_plan(2, s, 80, 64, 64, splits)
    assert pl.smem_bytes <= MAX_SMEM and 1 <= pl.splits <= splits
    sub = sops.KERNEL_CHUNK
    cover = np.zeros(s, np.int64)
    for c in range(pl.splits):
        lo, hi = c * pl.span * sub, min(s, (c + 1) * pl.span * sub)
        assert lo < hi and lo % sub == 0          # non-empty, on boundaries
        cover[lo:hi] += 1
    np.testing.assert_array_equal(cover, 1)
    assert sref.split_spans(s, splits, sub) == [
        (c * pl.span * sub, min(s, (c + 1) * pl.span * sub))
        for c in range(pl.splits)]
    assert pl.part_h == (2, 80, pl.splits, 64, 64)
    assert pl.part_l == (2, 80, pl.splits) and pl.sync == (2, 80,
                                                           2 + pl.splits)
    sops.check_plan(pl, 2, s, 80, 64, 64)


def test_ssd_plan_main_path_numbers():
    """zamba2's chunk: 4 spans of one 64-token sub-chunk, 320 CTAs; a
    sequence of one sub-chunk or less is one span; the smoke width."""
    pl = sops.plan(1, 256, 80, 64, 64)
    assert (pl.splits, pl.span, pl.splits * 80) == (4, 1, 320)
    assert pl.smem_bytes == 4 * (64 * 68 * 4 + 2 * 64) == 70144
    assert sops.plan(1, 44, 80, 64, 64).splits == 1
    assert sops.plan(1, 64, 80, 64, 64).splits == 1
    assert sops.plan(2, 8, 4, 16, 16).splits == 1
    assert sops.split_plan(1, 256, 80, 64, 64, 2).span == 2


@pytest.mark.parametrize("change", ["span short", "span long", "smem",
                                    "workspace"])
def test_ssd_plan_rejects(change):
    pl = sops.plan(1, 256, 80, 64, 64)
    bad = {"span short": dict(span=1, splits=3),
           "span long": dict(splits=4, span=2),
           "smem": dict(smem_bytes=MAX_SMEM + 16),
           "workspace": dict(part_h=(1, 80, 3, 64, 64))}[change]
    with pytest.raises(ValueError):
        sops.check_plan(dataclasses.replace(pl, **bad), 1, 256, 80, 64, 64)
    with pytest.raises(ValueError):
        sops.split_plan(1, 256, 80, 32, 32, 4)   # no instance


def test_ssd_workspace_is_made_once():
    pl = sops.plan(1, 44, 2, 16, 16)
    dev = torch.device("cpu")
    first = sops._workspace(dev, pl)
    again = sops._workspace(dev, pl)
    assert all(a is b for a, b in zip(first, again))
    assert first[2].dtype == torch.int32 and not first[2].any()
    sops._WORKSPACE.pop((dev, pl.part_h))


# (b, c, h, hkv, d): the int8 path's chunk, ragged chunks at G = 2 and
# G = 1 (zamba2's D 80), G = 8, D 64 (chip_smoke.py's f32 edge shapes)
TF32_SHAPES = {
    "qwen3 int8 chunk": (1, 256, 16, 8, 128),
    "ragged G=2": (2, 37, 16, 8, 128),
    "ragged G=1 D=80": (2, 37, 32, 32, 80),
    "G=8": (2, 37, 16, 2, 128),
    "D=64": (2, 37, 16, 8, 64),
}


@pytest.mark.parametrize("rows,stages", [(16, 2), (16, 3), (32, 2), (32, 3),
                                         (64, 2), (64, 3)])
@pytest.mark.parametrize("shape", TF32_SHAPES.values(),
                         ids=TF32_SHAPES.keys())
def test_prefill_tf32_sweep_plans_fit(shape, rows, stages):
    """Every plan of chip_smoke.py's sweep: f32 rows padded to D + 4, a
    ring of ``stages`` 64-key K and V tiles, no staged q, inside a block."""
    b, c, h, hkv, d = shape
    p = fops.tf32_plan(b, c, h, hkv, d, rows, stages)
    assert p.smem_bytes == 4 * (d + 4) * stages * 2 * 64 <= MAX_SMEM
    n_rows = c * (h // hkv)
    assert p.grid == (-(-n_rows // rows), hkv, b)
    fops.check_plan(p, b, c, h, hkv, d, F32)


@pytest.mark.parametrize("d", [64, 80, 128])
def test_prefill_plan_f32_runs_the_tf32_kernel(d):
    """f32 at the tensor-core head dims (128: the int8 path's prefill; 80:
    zamba2's shared block in f32) is planned on the 3xTF32 kernel, never
    the scalar one."""
    p = fops.plan(1, 256, 16, 8, d, F32)
    assert p == fops.tf32_plan(1, 256, 16, 8, d, fops.TF32_ROWS,
                               fops.TF32_STAGES)
    fops.check_plan(p, 1, 256, 16, 8, d, F32)


def test_prefill_tf32_plan_at_int8_chunk():
    """The f32 plan at the int8 path's chunk is the sweep's choice on the
    3xTF32 kernel, 32-row CTAs (128 of 4 warps) and 2 stages: 135,168
    bytes; 3 stages take 202,752 (one CTA a SM either way)."""
    p = fops.plan(1, 256, 16, 8, 128, F32)
    assert p == fops.tf32_plan(1, 256, 16, 8, 128, fops.TF32_ROWS,
                               fops.TF32_STAGES)
    assert (p.kernel, p.rows, p.stages, p.grid) == ("tf32", 32, 2,
                                                    (16, 8, 1))
    assert p.smem_bytes == 135168
    assert fops.tf32_plan(1, 256, 16, 8, 128, 64, 3).smem_bytes == 202752


@pytest.mark.parametrize("case", ["stages 4", "rows 48", "bf16 on tf32",
                                  "f32 on mma", "scalar at D 128", "grid",
                                  "smem short"])
def test_prefill_plan_rejects(case):
    shape = (1, 256, 16, 8, 128)
    p = fops.tf32_plan(*shape, 32, 3)
    bad, dtype = {
        "stages 4": (fops.tf32_plan(*shape, 16, 4), F32),  # 270,336 bytes
        "rows 48": (fops.Plan("tf32", (11, 8, 1), 48, 3, p.smem_bytes), F32),
        "bf16 on tf32": (p, torch.bfloat16),
        "f32 on mma": (fops.mma_plan(*shape, 32, 3), F32),
        "scalar at D 128": (fops.Plan("scalar", (8, 8, 1), 64, 1, 200000),
                            F32),
        "grid": (dataclasses.replace(p, grid=(17, 8, 1)), F32),
        "smem short": (dataclasses.replace(p, smem_bytes=p.smem_bytes - 16),
                       F32),
    }[case]
    with pytest.raises(ValueError):
        fops.check_plan(bad, *shape, dtype)


# ------------------------------------------------- f32 prefill at D 256

# Q K^T over the head dim's four quarters, each warp's partial in 3xTF32,
# added in quarter order; P V in 3xTF32 (each warp its own 64 columns)
QUARTERS_QK = functools.partial(tf32.matmul_3xtf32_parts, parts=4)


@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("g", [1, 8])
def test_prefill_d256_quarters_3xtf32_meet_pallas_and_one_tf32_misses(g,
                                                                      cap):
    """Causal attention of 256 tokens at D 256 over one kv head (gemma's
    MQA) in f32: the Pallas kernel in interpret mode (two 128-key blocks)
    against the f32 D 256 instance's arithmetic and against one TF32
    product."""
    rng = np.random.default_rng(3)
    s, d = 256, 256
    q = rng.standard_normal((1, s, g, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, s, 1, d)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True,
                                    q_block=128, kv_block=128,
                                    logit_softcap=cap))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    pos = torch.zeros(1, dtype=torch.int32)
    three = fref.flash_prefill_ref(tq, tk, tv, pos, cap, mm=QUARTERS_QK,
                                   mm_pv=tf32.matmul_3xtf32)
    one = fref.flash_prefill_ref(tq, tk, tv, pos, cap, mm=tf32.matmul_tf32)
    np.testing.assert_allclose(three.numpy(), want, **F32_TOL)
    assert _misses(one, torch.from_numpy(want.copy()), CARD_TOL)


def test_prefill_d256_quarters_3xtf32_at_gemma_chunk():
    """gemma-2b's int8 prefill chunk (256 tokens at pos 300, 8 query heads
    over one kv head, a 2048-token cache) in f32: the D 256 instance's
    arithmetic meets the plain f32 version at 3e-5."""
    gen = torch.Generator().manual_seed(8)
    q = torch.randn((1, 256, 8, 256), generator=gen)
    k, v = (torch.randn((1, 2048, 1, 256), generator=gen) for _ in range(2))
    pos = torch.tensor([300], dtype=torch.int32)
    want = fref.flash_prefill_ref(q, k, v, pos)
    three = fref.flash_prefill_ref(q, k, v, pos, mm=QUARTERS_QK,
                                   mm_pv=tf32.matmul_3xtf32)
    torch.testing.assert_close(three, want, **F32_TOL)


# (b, c, h, hkv): gemma-2b's chunk, and chip_smoke.py's f32 D 256 edges
TQ_SHAPES = {"gemma-2b chunk": (1, 256, 8, 1), "ragged G=1": (2, 37, 8, 8),
             "ragged G=8": (2, 37, 8, 1)}


@pytest.mark.parametrize("stages", [2, 3])
@pytest.mark.parametrize("shape", TQ_SHAPES.values(), ids=TQ_SHAPES.keys())
def test_prefill_tf32_256_sweep_plans_fit(shape, stages):
    """Every plan of chip_smoke.py's f32 D 256 sweep: 16-row CTAs of two
    key groups of four warps (256 threads), a ring of ``stages`` K and V
    tiles of 32 f32 rows padded to 260 floats, and each group's four S
    partials of 16 rows x 16 keys, inside a block."""
    b, c, h, hkv = shape
    p = fops.tf32_256_plan(b, c, h, hkv, 16, stages)
    assert p.smem_bytes == 4 * (stages * 2 * 32 * 260 + 16 * 4 * 32)
    assert p.smem_bytes <= MAX_SMEM
    assert p.grid == (-(-c * (h // hkv) // 16), hkv, b)
    fops.check_plan(p, b, c, h, hkv, 256, F32)


def test_prefill_plan_f32_d256_runs_the_tf32_256_kernel():
    """f32 at D 256 is planned on the 3xTF32 D 256 kernel, never the
    scalar one: at gemma-2b's chunk 128 CTAs of 16 rows at the sweep's
    stages; a 3-stage ring takes 207,872 bytes and a 4-stage one does not
    fit."""
    p = fops.plan(1, 256, 8, 1, 256, F32)
    assert p == fops.tf32_256_plan(1, 256, 8, 1, fops.TQ_ROWS,
                                   fops.TQ_STAGES)
    assert (p.kernel, p.rows, p.grid) == ("tf32_256", 16, (128, 1, 1))
    fops.check_plan(p, 1, 256, 8, 1, 256, F32)
    assert fops.tf32_256_plan(1, 256, 8, 1, 16, 3).smem_bytes == 207872
    assert fops.tf32_256_plan(1, 256, 8, 1, 16, 4).smem_bytes > MAX_SMEM
    for d in (16, 32):                        # the scalar kernel's only
        assert fops.plan(1, 256, 8, 1, d, F32).kernel == "scalar"


@pytest.mark.parametrize("case", ["scalar at f32 D 256", "on bf16",
                                  "at D 128", "rows 32", "stages 4",
                                  "smem short", "grid"])
def test_prefill_tf32_256_plan_rejects(case):
    """check_plan refuses the scalar kernel at f32 D 256, the new kernel
    in bf16 or at another head dim, and rows, stages, shared memory or a
    grid it does not take."""
    shape = (1, 256, 8, 1)
    p = fops.tf32_256_plan(*shape, 16, 2)
    bad, d, dtype = {
        "scalar at f32 D 256": (fops.scalar_plan(*shape, 256), 256, F32),
        "on bf16": (p, 256, torch.bfloat16),
        "at D 128": (p, 128, F32),
        "rows 32": (fops.tf32_256_plan(*shape, 32, 2), 256, F32),
        "stages 4": (fops.tf32_256_plan(*shape, 16, 4), 256, F32),
        "smem short": (dataclasses.replace(p, smem_bytes=p.smem_bytes - 16),
                       256, F32),
        "grid": (dataclasses.replace(p, grid=(64, 1, 1)), 256, F32),
    }[case]
    with pytest.raises(ValueError):
        fops.check_plan(bad, *shape, d, dtype)
