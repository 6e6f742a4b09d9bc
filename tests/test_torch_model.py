"""Port model steps against the reference on the CPU: smoke qwen3-1.7b,
reference weights carried across through ``repro_torch.bridge``.

``decode_step`` and ``prefill_step_cached`` logits (and the paged caches
they write) at prefill chunk sizes 1, an odd size and the whole prompt;
the on-device sampler fed the reference's uniform draw; the cache layout.
Tolerances: f32 3e-5, bf16 2e-2 (``tests/test_kernel_parity.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import MeshConfig, RunConfig, SHAPES
from repro.models import model as JM
from repro.parallel import sharding as shlib
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MeshConfig as TMeshConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.models import model as TM

NAMES = ["float32", "bfloat16"]
PAGE, MAX_SEQ, B, PROMPT = 8, 32, 2, 7


def _tol(name):
    return (dict(atol=2e-2, rtol=2e-2) if name == "bfloat16"
            else dict(atol=3e-5, rtol=3e-5))


@pytest.fixture(scope="module")
def models(host_mesh):
    out = {}
    with jax.set_mesh(host_mesh):
        for name in NAMES:
            jcfg = dataclasses.replace(jreg.smoke("qwen3-1.7b"), dtype=name)
            tcfg = dataclasses.replace(treg.smoke("qwen3-1.7b"), dtype=name)
            rc = RunConfig(model=jcfg, shape=SHAPES["decode_32k"],
                           mesh=MeshConfig(), kv_page_size=PAGE)
            trc = TRunConfig(model=tcfg, shape=TSHAPES["decode_32k"],
                             mesh=TMeshConfig(), kv_page_size=PAGE)
            params = JM.init_model(jax.random.PRNGKey(0), jcfg)
            pspecs = shlib.param_specs(jax.eval_shape(lambda: params),
                                       tier=rc.param_tier,
                                       multi_pod_fsdp=False)
            tparams = bridge.params_from_jax(
                jax.tree_util.tree_map(np.asarray, params), tcfg,
                device="cpu")
            steps = {
                "prefill": jax.jit(functools.partial(
                    JM.prefill_step_cached, cfg=jcfg, rc=rc,
                    param_specs=pspecs)),
                "decode": jax.jit(functools.partial(
                    JM.decode_step, cfg=jcfg, rc=rc, param_specs=pspecs))}
            out[name] = (jcfg, rc, params, steps, tcfg, trc, tparams)
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return bridge.to_numpy(x)
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_cache_close(got, jc, name):
    """All layers in f32; in bf16 the first layer only — deeper layers
    see inputs that already carry each framework's own bf16 roundings."""
    layers = slice(None) if name == "float32" else slice(0, 1)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(got["kv"][leaf][layers],
                                   _np(jc["kv"][leaf])[layers], **_tol(name))


def _prompt():
    return np.random.default_rng(9).integers(1, 256, (B, PROMPT)).astype(
        np.int32)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("chunk", [1, 3, PROMPT])
def test_prefill_step_cached_logits_match(models, host_mesh, name, chunk):
    jcfg, rc, params, steps, tcfg, trc, tparams = models[name]
    toks = _prompt()
    jc = JM.cache_init(jcfg, rc, B, max_seq=MAX_SEQ)
    tc = TM.cache_init(tcfg, trc, B, MAX_SEQ, device="cpu")
    with jax.set_mesh(host_mesh):
        for s in range(0, PROMPT, chunk):
            part = toks[:, s:s + chunk]
            jl, jc = steps["prefill"](params, tokens=jnp.asarray(part),
                                      cache=jc)
            tl, tc = TM.prefill_step_cached(tparams, tcfg, trc,
                                            torch.from_numpy(part), tc)
            np.testing.assert_allclose(_np(tl), _np(jl), **_tol(name))
    np.testing.assert_array_equal(_np(tc["pos"]), np.asarray(jc["pos"]))
    _assert_cache_close(bridge.cache_to_numpy(tc), jc, name)
    # last_only computes the same final row
    tc2 = TM.cache_init(tcfg, trc, B, MAX_SEQ, device="cpu")
    last, _ = TM.prefill_step_cached(tparams, tcfg, trc,
                                     torch.from_numpy(toks), tc2,
                                     last_only=True)
    assert last.shape[1] == 1


@pytest.mark.parametrize("name", NAMES)
def test_decode_step_logits_match(models, host_mesh, name):
    """Ragged per-slot positions: row 1 starts 5 tokens later."""
    jcfg, rc, params, steps, tcfg, trc, tparams = models[name]
    toks = _prompt()
    jc = JM.cache_init(jcfg, rc, B, max_seq=MAX_SEQ)
    rng = np.random.default_rng(10)
    with jax.set_mesh(host_mesh):
        _, jc = steps["prefill"](params, tokens=jnp.asarray(toks), cache=jc)
        jc["pos"] = jc["pos"].at[1].add(5)
        tc = bridge.cache_from_jax(jax.tree_util.tree_map(np.asarray, jc),
                                   device="cpu")
        for _ in range(4):
            nt = rng.integers(1, 256, (B, 1)).astype(np.int32)
            jl, jc = steps["decode"](params, tokens=jnp.asarray(nt),
                                     cache=jc)
            tl, tc = TM.decode_step(tparams, tcfg, trc,
                                    torch.from_numpy(nt), tc)
            assert tl.shape == (B, 1, tcfg.vocab_size)
            np.testing.assert_allclose(_np(tl), _np(jl), **_tol(name))
    got = bridge.cache_to_numpy(tc)
    np.testing.assert_array_equal(got["pos"], np.asarray(jc["pos"]))
    _assert_cache_close(got, jc, name)


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
def test_sample_tokens_matches_reference(temperature):
    rng = np.random.default_rng(11)
    row = rng.standard_normal((6, 300)).astype(np.float32) * 3
    key = jax.random.PRNGKey(3)
    want = JM.sample_tokens(jnp.asarray(row), key, temperature)
    u = None
    if temperature:
        u = torch.tensor(np.asarray(
            jax.random.uniform(key, (6,), dtype=jnp.float32)))
    got = TM.sample_tokens(torch.from_numpy(row), u, temperature)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cache_layout_matches_reference():
    jcfg = jreg.smoke("qwen3-1.7b")
    tcfg = treg.smoke("qwen3-1.7b")
    rc = RunConfig(model=jcfg, shape=SHAPES["decode_32k"], mesh=MeshConfig(),
                   kv_page_size=PAGE)
    trc = TRunConfig(model=tcfg, shape=TSHAPES["decode_32k"],
                     mesh=TMeshConfig(), kv_page_size=PAGE)
    jc = JM.cache_init(jcfg, rc, 3, max_seq=MAX_SEQ, as_shape=True)
    tc = TM.cache_init(tcfg, trc, 3, MAX_SEQ, device="cpu")
    for leaf in ("k", "v"):
        assert tuple(tc["kv"][leaf].shape) == jc["kv"][leaf].shape
        assert tc["kv"][leaf].dtype == torch.bfloat16
    assert tuple(tc["pos"].shape) == jc["pos"].shape
    assert tc["pos"].dtype == torch.int32


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "xlstm-125m"])
def test_unported_families_raise(arch):
    """A family outside ``PORTED_FAMILIES`` still raises at every entry
    point; the VLM and xLSTM families, refused until they were ported, now
    init and lay out their caches as the reference does."""
    cfg = treg.smoke(arch)
    rc = TRunConfig(model=cfg, shape=TSHAPES["decode_32k"],
                    mesh=TMeshConfig(), kv_page_size=PAGE)
    other = dataclasses.replace(cfg, family="unported")
    for entry in (lambda c: TM.init_model(c, device="cpu"),
                  lambda c: TM.cache_init(c, rc, 3, MAX_SEQ, device="cpu")):
        with pytest.raises(NotImplementedError):
            entry(other)
    assert cfg.family in TM.PORTED_FAMILIES
    params = TM.init_model(cfg, device="cpu")
    assert TM.n_groups(cfg) == 2 and len(list(params.children())) == 4
    jcfg = jreg.smoke(arch)
    jrc = RunConfig(model=jcfg, shape=SHAPES["decode_32k"], mesh=MeshConfig(),
                    kv_page_size=PAGE)
    want = jax.tree_util.tree_map(
        lambda a: (a.shape, str(a.dtype)),
        JM.cache_init(jcfg, jrc, 3, max_seq=MAX_SEQ, as_shape=True))
    got = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        TM.cache_init(cfg, rc, 3, MAX_SEQ, device="cpu"))
    assert got == want


def test_init_model_is_seeded():
    cfg = treg.smoke("qwen3-1.7b")
    a = TM.init_model(cfg, seed=3, device="cpu")
    b = TM.init_model(cfg, seed=3, device="cpu")
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    assert len(a.blocks) == cfg.n_layers
    assert a.blocks[0].attn.wq.shape == (cfg.d_model, cfg.q_dim)
