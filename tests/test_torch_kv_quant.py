"""The port's int8 KV pages against the reference on the CPU.

* ``repro_torch.models.kv_quant`` bit for bit against
  ``repro.models.kv_quant`` on the same f32 inputs, with the edge cases of
  ``tests/test_kv_quant.py``: zero and subnormal pages, ``INIT_SCALE``, an
  untouched page bit-stable, monotone growth.
* The serving path requantizes only the pages a step wrote; the reference
  requantizes every page. Codes and scales must agree bit for bit after a
  decode write (page boundaries, the last position, a clamped ``pos``)
  and after a prefill chunk that crosses a page boundary.
* The int8 decode kernel's plain version against the reference's
  dequantize-then-oracle and the Pallas kernel's int8 mode (f32 3e-5).
* The int8 decode and prefill blocks against the reference's
  ``_paged_block_decode`` / ``_block_prefill_cached``: outputs at f32
  3e-5; codes within one step, scales within 1e-6 relative.
* The port engine alone mirrors ``tests/test_kv_quant.py``'s engine gates
  (flush -> restore -> decode byte-exact on the fully written prefix pages;
  the entry bytes about halve), and the port engine against the JAX engine
  with ``kv_quant="int8"`` on the traffic of ``tests/test_torch_serving.py``
  for smoke qwen3-1.7b and zamba2-2.7b (f32): identical greedy tokens,
  engine stats, tier snapshot, op trace and store bytes; scales within
  1e-6 relative; dequantized caches within 3e-5 plus one code step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import MeshConfig, RunConfig, SHAPES
from repro.kernels.decode_attention.kernel import paged_flash_decode
from repro.kernels.decode_attention.ref import paged_flash_decode_quant_ref
from repro.models import attention as jattn
from repro.models import kv_quant as jkvq
from repro.models import model as JM
from repro.models import transformer as JT
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MeshConfig as TMeshConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.models import attention as tattn
from repro_torch.models import kv_quant as tkvq
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

F32_TOL = dict(atol=3e-5, rtol=3e-5)
SCALE_RTOL = 1e-6
PAGE_SHAPES = [(2, 8, 2, 16), (1, 3, 4, 16, 4), (2, 2, 2, 4, 2, 8)]
MAGNITUDES = [1e-12, 1e-3, 1.0, 1e4, 1e12]


def _draw(shape, seed, magnitude=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * magnitude).astype(np.float32)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.array(x))


def _eq(got, want):
    """Bit-for-bit equality of a torch result and a jax one."""
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------- kv_quant, bit for bit

@pytest.mark.parametrize("shape", PAGE_SHAPES)
@pytest.mark.parametrize("magnitude", MAGNITUDES)
def test_quantize_roundtrip_bit_exact(shape, magnitude):
    xj, xt = _both(_draw(shape, 3, magnitude))
    sj, st = jkvq.page_scales(xj), tkvq.page_scales(xt)
    _eq(st, sj)
    qj, qt = jkvq.quantize_pages(xj, sj), tkvq.quantize_pages(xt, st)
    assert qt.dtype == torch.int8
    _eq(qt, qj)
    _eq(tkvq.dequantize_pages(qt, st), jkvq.dequantize_pages(qj, sj))
    # growth from a smaller and from a larger previous scale
    for prev in (_draw(st.shape, 4, magnitude) ** 2 * 1e-3 / 127,
                 np.asarray(sj) * 3.0):
        qj2, sj2 = jkvq.requantize_pages(xj, jnp.asarray(prev))
        qt2, st2 = tkvq.requantize_pages(xt, torch.from_numpy(prev))
        _eq(st2, sj2)
        _eq(qt2, qj2)


def test_constants_match_reference():
    assert tkvq.KV_QUANT_MODES == jkvq.KV_QUANT_MODES
    assert (tkvq.QMAX, tkvq.SCALE_FLOOR) == (jkvq.QMAX, jkvq.SCALE_FLOOR)
    assert tkvq.INIT_SCALE == jkvq.INIT_SCALE
    assert np.float32(tkvq.INIT_SCALE) >= np.finfo(np.float32).tiny


@pytest.mark.parametrize("fill", [0.0, 1e-40])
def test_zero_and_subnormal_pages(fill):
    xj, xt = _both(np.full((2, 8, 2, 16), fill, np.float32))
    st = tkvq.page_scales(xt)
    _eq(st, jkvq.page_scales(xj))
    assert (st.numpy() >= np.finfo(np.float32).tiny).all()
    qt = tkvq.quantize_pages(xt, st)
    _eq(qt, jkvq.quantize_pages(xj, jkvq.page_scales(xj)))
    assert not qt.any()
    # a fresh page at INIT_SCALE requantizes to itself
    init = torch.full(st.shape, tkvq.INIT_SCALE)
    q2, s2 = tkvq.requantize_pages(xt, init)
    assert not q2.any() and torch.equal(s2, init)


@pytest.mark.parametrize("shape", PAGE_SHAPES)
@pytest.mark.parametrize("magnitude", MAGNITUDES)
def test_untouched_page_bit_stable(shape, magnitude):
    xt = torch.from_numpy(_draw(shape, 5, magnitude))
    s = tkvq.page_scales(xt)
    q = tkvq.quantize_pages(xt, s)
    q2, s2 = tkvq.requantize_pages(tkvq.dequantize_pages(q, s), s)
    assert torch.equal(q2, q) and torch.equal(s2, s)


def test_scale_growth_is_monotone():
    xj, xt = _both(_draw((2, 8, 2, 16), 6))
    s0 = tkvq.page_scales(xt)
    _, s_small = tkvq.requantize_pages(xt * 0.01, s0)
    assert torch.equal(s_small, s0)
    q_big, s_big = tkvq.requantize_pages(xt * 100.0, s0)
    qj, sj = jkvq.requantize_pages(xj * 100.0, jkvq.page_scales(xj))
    _eq(s_big, sj)
    _eq(q_big, qj)
    assert (s_big >= s0).all() and q_big.abs().max() <= tkvq.QMAX


def test_validate_mode_spellings():
    assert tkvq.validate_mode("none") == "none"
    assert tkvq.validate_mode("int8") == "int8"
    with pytest.raises(ValueError, match="unknown"):
        tkvq.validate_mode("int4")
    with pytest.raises(ValueError, match="reserved"):
        tkvq.validate_mode("fp8")


# ------------------- one-page requantization vs the whole-cache pass

B, P, PAGE, HKV, G, D = 4, 4, 8, 2, 2, 16
SMAX = P * PAGE


def _int8_cache(seed):
    """int8 pages [B,P,page,Hkv,D] + f32 scales [B,P,Hkv] quantized from a
    random f32 cache, page 0 of row 0 left fresh (zeros, INIT_SCALE)."""
    x = _draw((B, P, PAGE, HKV, D), seed)
    x[0, 0] = 0.0
    prev = np.full((B, P, HKV), jkvq.INIT_SCALE, np.float32)
    q, s = jkvq.requantize_pages(jnp.asarray(x), jnp.asarray(prev))
    return np.array(q), np.array(s)


@pytest.mark.parametrize("pos", [[0, 8, 15, 31], [7, 16, 31, 40]],
                         ids=["page-starts", "page-ends-and-clamp"])
def test_decode_one_page_requant_equals_reference(mesh_ctx, pos):
    """Rows on a page's first and last position, on the last cache
    position and past it (clamped to Smax - 1)."""
    rng = np.random.default_rng(7)
    kq, ks = _int8_cache(8)
    vq, vs = _int8_cache(9)
    q = rng.standard_normal((B, 1, HKV * G, D)).astype(np.float32)
    nk = (rng.standard_normal((B, 1, HKV, D)) * 4).astype(np.float32)
    nv = (rng.standard_normal((B, 1, HKV, D)) * 4).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    want = jattn.paged_decode_attention(
        *map(jnp.asarray, (q, kq, vq, nk, nv, pos)), batch_axes=None,
        page_axes=None, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    t = [torch.from_numpy(a.copy()) for a in (q, kq, vq, nk, nv, pos, ks,
                                              vs)]
    o = tattn.paged_decode_attention(*t[:6], k_scale=t[6], v_scale=t[7])
    np.testing.assert_allclose(o.numpy(), np.asarray(want[0]), **F32_TOL)
    for got, w in zip((t[1], t[2], t[6], t[7]), want[1:]):
        _eq(got, w)
    assert not np.array_equal(t[6].numpy(), ks)      # a scale really grew


@pytest.mark.parametrize("pos", [[4, 12, 20, 27], [0, 30, 16, 9]],
                         ids=["crossing", "aligned-and-clamped"])
def test_prefill_one_page_requant_equals_reference(pos):
    """A 6-token chunk at offsets that cross a page boundary, start on one,
    and run past the end (clamped to Smax - C): the port requantizes the
    pages the chunk touched, the reference every page (its own
    ``requantize_pages`` on the dequantized cache with the chunk
    written)."""
    c = 6
    rng = np.random.default_rng(11)
    kq, ks = _int8_cache(12)
    vq, vs = _int8_cache(13)
    k = (rng.standard_normal((B, c, HKV, D)) * 3).astype(np.float32)
    v = (rng.standard_normal((B, c, HKV, D)) * 3).astype(np.float32)
    q = rng.standard_normal((B, c, HKV * G, D)).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    kv = {"k": torch.from_numpy(kq.copy()), "v": torch.from_numpy(vq.copy()),
          "k_scale": torch.from_numpy(ks.copy()),
          "v_scale": torch.from_numpy(vs.copy())}
    cfg = dataclasses.replace(treg.smoke("qwen3-1.7b"), n_kv_heads=HKV,
                              head_dim=D)
    TT._prefill_attention_int8(cfg, torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(pos),
                               kv)
    start = np.clip(pos, 0, SMAX - c)
    for name, codes, scale, new in (("k", kq, ks, k), ("v", vq, vs, v)):
        x = np.array(jkvq.dequantize_pages(jnp.asarray(codes),
                                           jnp.asarray(scale)))
        flat = x.reshape(B, SMAX, HKV, D)
        for b in range(B):
            flat[b, start[b]:start[b] + c] = new[b]
        wq, ws = jkvq.requantize_pages(jnp.asarray(x), jnp.asarray(scale))
        _eq(kv[name], wq)
        _eq(kv[name + "_scale"], ws)


# ------------------------------------- the int8 decode kernel's plain version

def test_int8_decode_plain_matches_pallas_and_oracle():
    """Where the new row equals its own code, the plain version is the
    Pallas kernel's int8 mode (interpret) and its oracle, slot by slot."""
    rng = np.random.default_rng(14)
    kq, ks = _int8_cache(15)
    vq, vs = _int8_cache(16)
    q = rng.standard_normal((B, 1, HKV * G, D)).astype(np.float32)
    pos = np.array([0, 9, 20, 31], np.int32)
    rows = np.arange(B)
    new = [np.asarray(jkvq.dequantize_pages(jnp.asarray(c), jnp.asarray(s))
                      ).reshape(B, SMAX, HKV, D)[rows, pos][:, None]
           for c, s in ((kq, ks), (vq, vs))]
    got = dops.paged_decode(*(torch.from_numpy(a) for a in (q, kq, vq)),
                            k_scale=torch.from_numpy(ks),
                            v_scale=torch.from_numpy(vs),
                            new_k=torch.from_numpy(new[0]),
                            new_v=torch.from_numpy(new[1]),
                            pos=torch.from_numpy(pos))
    # the Pallas layout: q [B,Hkv,G,D], pages [B,Hkv,P,page,D]
    qh = jnp.asarray(q.reshape(B, HKV, G, D))
    kh, vh = (jnp.moveaxis(jnp.asarray(a), 3, 1) for a in (kq, vq))
    ksh, vsh = (jnp.moveaxis(jnp.asarray(a), 2, 1) for a in (ks, vs))
    for b in range(B):
        sl = slice(b, b + 1)
        for want in (paged_flash_decode(
                qh[sl], kh[sl], vh[sl], int(pos[b]) + 1, interpret=True,
                k_scale=ksh[sl], v_scale=vsh[sl]),
                paged_flash_decode_quant_ref(qh[sl], kh[sl], vh[sl],
                                             ksh[sl], vsh[sl],
                                             int(pos[b]) + 1)):
            np.testing.assert_allclose(
                got[b].numpy().reshape(HKV, G, D),
                np.asarray(want)[0], **F32_TOL)


def test_int8_decode_attends_to_the_new_row_at_full_precision():
    """The new row enters the softmax unquantized: a query aligned with
    it sees its exact value, not its int8 code."""
    kq, ks = _int8_cache(17)
    vq, vs = _int8_cache(18)
    nk = torch.zeros((B, 1, HKV, D))
    nv = torch.full((B, 1, HKV, D), 0.123456789)
    nk[..., 0] = 200.0                               # dominates the softmax
    q = torch.zeros((B, 1, HKV * G, D))
    q[..., 0] = 1.0
    o = dops.paged_decode(q, torch.from_numpy(kq), torch.from_numpy(vq),
                          k_scale=torch.from_numpy(ks),
                          v_scale=torch.from_numpy(vs), new_k=nk, new_v=nv,
                          pos=torch.tensor([3, 8, 20, 31], dtype=torch.int32))
    np.testing.assert_allclose(o.numpy(), 0.123456789, atol=1e-5)


# ----------------------------------------- int8 blocks vs the reference

@pytest.fixture(scope="module")
def dense(host_mesh):
    jcfg = dataclasses.replace(jreg.smoke("qwen3-1.7b"), dtype="float32")
    tcfg = dataclasses.replace(treg.smoke("qwen3-1.7b"), dtype="float32")
    rc = RunConfig(model=jcfg, shape=SHAPES["decode_32k"], mesh=MeshConfig(),
                   kv_page_size=PAGE, kv_quant="int8")
    trc = TRunConfig(model=tcfg, shape=TSHAPES["decode_32k"],
                     mesh=TMeshConfig(), kv_page_size=PAGE, kv_quant="int8")
    with jax.set_mesh(host_mesh):
        params = JM.init_model(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    return jcfg, rc, params, tcfg, trc, tparams


def _assert_int8_close(got, want):
    """Codes within one step, scales within 1e-6 relative; returns how
    many codes differ."""
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=SCALE_RTOL, atol=0)
    n_diff = 0
    for name in ("k", "v"):
        d = np.abs(got[name].numpy().astype(np.int32)
                   - np.asarray(want[name]).astype(np.int32))
        assert d.max() <= 1, f"{name}: codes differ by {d.max()}"
        n_diff += int((d > 0).sum())
    return n_diff


def _layer_cache(seed, hkv, d):
    """One layer's int8 pages [B,P,page,Hkv,D] + scales, from random f32
    pages with row 0's last pages fresh."""
    x = _draw((2, P, PAGE, hkv, d), seed) * 0.5
    x[0, 2:] = 0.0
    prev = np.full((2, P, hkv), jkvq.INIT_SCALE, np.float32)
    out = {}
    for name, xs in (("k", x), ("v", x[::-1].copy())):
        q, s = jkvq.requantize_pages(jnp.asarray(xs), jnp.asarray(prev))
        out[name], out[name + "_scale"] = np.asarray(q), np.asarray(s)
    return out


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_int8_block_matches_reference(dense, host_mesh, kind):
    jcfg, rc, params, tcfg, trc, tparams = dense
    kv = _layer_cache(19, jcfg.n_kv_heads, jcfg.head_dim)
    rng = np.random.default_rng(20)
    c = 1 if kind == "decode" else 6
    x = (rng.standard_normal((2, c, jcfg.d_model)) * 0.5).astype(np.float32)
    pos = np.array([13, 6], np.int32)                 # a chunk crosses page 1
    positions = pos[:, None] + np.arange(c, dtype=np.int32)[None]
    layer = jax.tree_util.tree_map(lambda a: a[0], params["blocks"])
    jkv = {n: jnp.asarray(a) for n, a in kv.items()}
    tkv = {n: torch.from_numpy(a.copy()) for n, a in kv.items()}
    with jax.set_mesh(host_mesh):
        if kind == "decode":
            wy, wkv = JM._paged_block_decode(
                JT.block_decode_paged, layer, jcfg, jnp.asarray(x),
                jnp.asarray(pos), jkv, rc)
            y = TT.block_decode_paged(tparams.blocks[0], tcfg,
                                      torch.from_numpy(x),
                                      torch.from_numpy(pos), tkv)
        else:
            wy, wkv = JM._block_prefill_cached(
                layer, jcfg, rc, jnp.asarray(x), jnp.asarray(positions),
                jnp.asarray(pos), jkv, moe_mlp=False)
            y = TT.block_prefill_cached(tparams.blocks[0], tcfg,
                                        torch.from_numpy(x),
                                        torch.from_numpy(positions),
                                        torch.from_numpy(pos), tkv)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **F32_TOL)
    n_diff = _assert_int8_close(tkv, wkv)
    print(f"{kind}: {n_diff} codes differ by one step")


def test_bridge_carries_int8_cache(dense, host_mesh):
    """``cache_from_jax`` / ``cache_to_numpy`` carry the int8 codes and
    their f32 scales bit for bit, in the layout ``cache_init`` makes."""
    jcfg, rc, _, tcfg, trc, _ = dense
    with jax.set_mesh(host_mesh):
        jc = JM.cache_init(jcfg, rc, 2, max_seq=32)
    rng = np.random.default_rng(21)
    kv = {n: np.asarray(a) for n, a in jc["kv"].items()}
    kv["k"] = rng.integers(-127, 128, kv["k"].shape).astype(np.int8)
    kv["k_scale"] = rng.random(kv["k_scale"].shape).astype(np.float32)
    tc = bridge.cache_from_jax(dict(jc, kv=kv), device="cpu")
    want = TM.cache_init(tcfg, trc, 2, 32, device="cpu")
    assert {n: (t.dtype, t.shape) for n, t in tc["kv"].items()} == {
        n: (t.dtype, t.shape) for n, t in want["kv"].items()}
    assert torch.equal(want["kv"]["v_scale"], tc["kv"]["v_scale"])
    back = bridge.cache_to_numpy(tc)
    for n, a in kv.items():
        np.testing.assert_array_equal(back["kv"][n], a)
        assert back["kv"][n].dtype == a.dtype


# ---------------------------------- the port engine's own int8 gates

PROMPT = [1, 2, 3, 7, 9, 4, 2, 8, 1, 5, 6]


def _make(kv_quant, page_size=8):
    """Smoke engine with small pages (page 8, 4 pages at max_seq 32), as
    ``tests/test_kv_quant.py`` builds the reference's."""
    cfg = treg.smoke("qwen3-1.7b")
    rc = TRunConfig(model=cfg, shape=TSHAPES["decode_32k"],
                    mesh=TMeshConfig(), kv_page_size=page_size)
    params = TM.init_model(cfg, device="cpu")
    return TEngine(params, cfg, rc, device="cpu", n_slots=1, max_seq=32,
                   prefill_chunk=4, kv_quant=kv_quant)


def _flush(eng, rid):
    for _ in range(10):
        if rid in eng.store.pages:
            break
        eng.flusher.maybe_flush()
    assert rid in eng.store.pages
    return eng.store.pages[rid]


def test_port_tier_flush_restore_decode_byte_exact():
    eng = _make("int8")
    assert eng.cache["kv"]["k"].dtype == torch.int8
    assert eng.cache["kv"]["k_scale"].dtype == torch.float32
    eng.submit(TRequest(rid=42, prompt=PROMPT, max_new_tokens=4))
    original = eng.run(max_ticks=100)[0].generated
    entry = _flush(eng, 42)
    assert entry["kv"]["k"].dtype == torch.int8
    assert entry["kv"]["k_scale"].device.type == "cpu"
    pf = eng.stats["prefill_dispatches"]
    eng.submit(TRequest(rid=42, prompt=PROMPT, max_new_tokens=2))
    done = eng.run(max_ticks=100)
    assert done[-1].restored
    assert done[-1].generated == original[:2]
    assert eng.stats["prefill_dispatches"] == pf      # no re-prefill
    full = len(PROMPT) // 8                           # fully written pages
    for name in ("k", "k_scale", "v", "v_scale"):
        assert torch.equal(eng.cache["kv"][name][:, 0, :full],
                           entry["kv"][name][:, :full])


def test_port_quantized_entry_bytes_roughly_halved():
    sizes = {}
    for mode in ("none", "int8"):
        eng = _make(mode)
        eng.submit(TRequest(rid=1, prompt=PROMPT, max_new_tokens=2))
        eng.run(max_ticks=100)
        sizes[mode] = eng.store._entry_bytes(_flush(eng, 1))
        if mode == "none":
            itemsize = eng.cache["kv"]["k"].element_size()
    assert sizes["int8"] / sizes["none"] < 1.0 / itemsize + 0.05


# --------------------------------- port engine vs the JAX engine, int8

KNOBS = dict(n_slots=4, max_seq=64, prefill_chunk=8,
             tier_topology=("dram", "ssd-fast"), kv_quant="int8")
ENGINE_PAGE = 16
N_FIRST, N_RESUBMIT = 6, 3
ARCHS = ["qwen3-1.7b", "zamba2-2.7b"]


def _traffic():
    """The traffic of ``tests/test_torch_serving.py``."""
    rng = np.random.default_rng(11)
    first = [(rid, rng.integers(1, 256, int(n)).tolist(), 6)
             for rid, n in enumerate(rng.integers(5, 21, N_FIRST))]
    again = [(100 + rid, prompt, 5) for rid, prompt, _ in first[:N_RESUBMIT]]
    return first, again


def _drive(engine, request_cls):
    first, again = _traffic()
    for wave in (first, again):
        for rid, prompt, n in wave:
            engine.submit(request_cls(rid=rid, prompt=list(prompt),
                                      max_new_tokens=n))
        engine.run(max_ticks=500)
    return {r.rid: list(r.generated) for r in engine.finished}


@pytest.fixture(scope="module", params=ARCHS)
def engines(request, host_mesh):
    arch = request.param
    cfg = dataclasses.replace(jreg.smoke(arch), dtype="float32")
    rc = RunConfig(model=cfg, shape=SHAPES["decode_32k"], mesh=MeshConfig(),
                   kv_page_size=ENGINE_PAGE)
    with jax.set_mesh(host_mesh):
        params = JM.init_model(jax.random.PRNGKey(0), cfg)
        jeng = JEngine(params, cfg, rc, **KNOBS)
        jtoks = _drive(jeng, JRequest)
    tcfg = dataclasses.replace(treg.smoke(arch), dtype="float32")
    trc = TRunConfig(model=tcfg, shape=TSHAPES["decode_32k"],
                     mesh=TMeshConfig(), kv_page_size=ENGINE_PAGE)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    teng = TEngine(tparams, tcfg, trc, device="cpu", **KNOBS)
    ttoks = _drive(teng, TRequest)
    return arch, jeng, jtoks, teng, ttoks


def test_int8_engine_greedy_tokens_match_reference(engines):
    arch, jeng, jtoks, teng, ttoks = engines
    assert len(ttoks) == N_FIRST + N_RESUBMIT
    assert ttoks == jtoks
    restored = sorted(r.rid for r in teng.finished if r.restored)
    if arch == "qwen3-1.7b":
        assert restored == [100 + i for i in range(N_RESUBMIT)]
    else:                         # the hybrid is never restored
        assert restored == []


@pytest.mark.parametrize("key", ["prefix_hits", "restore_stall_ns",
                                 "tier_write_ns", "store_bytes", "flushes",
                                 "prefill_tokens", "decode_tokens", "steps",
                                 "clock_ns"])
def test_int8_engine_stats_match_reference(engines, key):
    _, jeng, _, teng, _ = engines
    assert teng.stats[key] == jeng.stats[key]


def test_int8_engine_tier_trace_matches_reference(engines):
    _, jeng, _, teng, _ = engines
    assert teng.tier.snapshot() == jeng.tier.snapshot()
    assert teng.tier.ops == jeng.tier.ops
    assert teng.tier.op_ns == jeng.tier.op_ns
    assert teng.tier.counters["write_bytes"] > 0


def _assert_pages_close(got, want):
    """Scales within 1e-6 relative; dequantized pages within 3e-5 plus one
    code step of their page. Returns the count of codes that differ."""
    n_diff = 0
    for name in ("k", "v"):
        gs, ws = got[name + "_scale"], np.asarray(want[name + "_scale"])
        np.testing.assert_allclose(gs, ws, rtol=SCALE_RTOL, atol=0)
        gq, wq = got[name], np.asarray(want[name])
        assert gq.dtype == wq.dtype == np.int8
        n_diff += int((gq != wq).sum())
        step = ws[..., :, None, :, None]
        dg = gq.astype(np.float32) * gs[..., :, None, :, None]
        dw = wq.astype(np.float32) * step
        bound = 3e-5 + 3e-5 * np.abs(dw) + step * (1 + 1e-6)
        assert (np.abs(dg - dw) <= bound).all(), (
            f"{name}: {n_diff} codes differ, beyond one step somewhere")
    return n_diff


def test_int8_engine_cache_matches_reference(engines):
    arch, jeng, _, teng, _ = engines
    got = bridge.cache_to_numpy(teng.cache)
    np.testing.assert_array_equal(got["pos"], np.asarray(jeng.cache["pos"]))
    assert np.abs(np.asarray(jeng.cache["kv"]["k"])).max() > 10
    n_diff = _assert_pages_close(got["kv"], jeng.cache["kv"])
    print(f"{arch}: {n_diff} of {2 * got['kv']['k'].size} codes differ")


def test_int8_engine_store_entries_match_reference(engines):
    _, jeng, _, teng, _ = engines
    assert list(teng.store.pages) == list(jeng.store.pages)
    assert teng.store.bytes == jeng.store.bytes
    for rid, jentry in jeng.store.pages.items():
        tentry = teng.store.pages[rid]
        assert tentry["pos"] == jentry["pos"]
        assert tentry.get("first_token") == jentry.get("first_token")
        assert set(tentry["kv"]) == set(jentry["kv"])
        _assert_pages_close({n: t.numpy() for n, t in tentry["kv"].items()},
                            jentry["kv"])
