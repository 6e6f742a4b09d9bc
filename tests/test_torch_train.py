"""The port's training forward against the reference on the CPU.

``softmax_xent``, ``chunked_attention`` (causal; and non-causal over 1601
keys, padded to whole blocks and masked), ``block_apply``, then
``loss_fn`` and its gradients for the dense, MoE, audio, hybrid, VLM and
xLSTM families at ``registry.smoke`` sizes (reference weights carried
across by ``repro_torch.bridge``, gradients carried back by
``bridge.params_to_numpy``); the layer stream (``stream_layers``) against
a direct loop, with and without remat, for forward and gradient; the
flash-prefill route of the loss (``use_pallas``) equal to the plain one
and refused under grad (both kernel wrappers refuse inputs that require
grad); the train step's input shapes; the loss decreasing over five
steps (``tests/test_models.py``'s four architectures). Tolerances: f32
3e-5, bf16 2e-2
(``tests/test_kernel_parity.py``); the ``use_pallas`` loss 2e-3
(``tests/test_models.py:154``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import MeshConfig, RunConfig, SHAPES
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.models import transformer as jtransformer
from repro.parallel import sharding as shlib
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MeshConfig as TMeshConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.core import speculative_read as sr
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import adamw as tadamw

FAMILIES = ["qwen3-1.7b", "granite-moe-1b-a400m", "musicgen-large",
            "zamba2-2.7b", "llama-3.2-vision-11b", "xlstm-125m"]
NAMES = ["float32", "bfloat16"]
B, S = 2, 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's smoke steps on one intra-op thread: their ops are tiny,
    and a pool of threads per process spins against the other test
    workers' pools (a module's seconds under the suite's six workers fell
    ~15x on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(name):
    return (dict(atol=2e-2, rtol=2e-2) if name == "bfloat16"
            else dict(atol=3e-5, rtol=3e-5))


def _np(x):
    if isinstance(x, torch.Tensor):
        return bridge.to_numpy(x)
    return np.asarray(jnp.asarray(x, jnp.float32))


def _batch(cfg, seed=0, b=B, s=S):
    """tokens, labels (and the VLM's f32 vision embeddings) from a seed."""
    rng = np.random.default_rng(seed)
    shape = (b, cfg.n_codebooks, s) if cfg.family == "audio" else (b, s)
    out = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = (rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _configs(arch, name, **rc_over):
    jcfg = dataclasses.replace(jreg.smoke(arch), dtype=name)
    tcfg = dataclasses.replace(treg.smoke(arch), dtype=name)
    # the reference's layer scan at SR depth 0: in training its depth only
    # sets how far the scan is unrolled (``depth + 1``), the same values
    # from half the program to compile
    rc = RunConfig(model=jcfg, shape=SHAPES["train_4k"], mesh=MeshConfig(),
                   **{"sr_prefetch_depth": 0, **rc_over})
    trc = TRunConfig(model=tcfg, shape=TSHAPES["train_4k"],
                     mesh=TMeshConfig(), **rc_over)
    return jcfg, rc, tcfg, trc


def _models(host_mesh, arch, name):
    """(jcfg, rc, params, specs, tcfg, trc, tparams): the reference's smoke
    weights and the port's model built from them, grads on."""
    jcfg, rc, tcfg, trc = _configs(arch, name)
    with jax.set_mesh(host_mesh):
        params = JM.init_model(jax.random.PRNGKey(0), jcfg)
        specs = shlib.param_specs(jax.eval_shape(lambda: params))
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            params),
                                     tcfg, device="cpu")
    tparams.requires_grad_(True)
    return jcfg, rc, params, specs, tcfg, trc, tparams


def _leaves(tree):
    return dict((jax.tree_util.keystr(p), l)
                for p, l in jax.tree_util.tree_leaves_with_path(tree))


def _assert_tree_close(got, want, tol, what):
    """Leaf-wise over the reference's pytree paths; both trees must have
    the same leaves."""
    g, w = _leaves(got), _leaves(want)
    assert sorted(g) == sorted(w), what
    for k in w:
        np.testing.assert_allclose(g[k], _np(w[k]), err_msg=f"{what} {k}",
                                   **tol)


def _assert_bf16_grads_accurate(arch, params, batch, got, want):
    """bf16 gradients of a mean cross-entropy are mostly far below 2e-2,
    so they are also held leaf by leaf against the exact ones: the port's
    f32 gradient of the same bf16 weights (the f32 case holds it to the
    reference at 3e-5). The port's error, in the norm of each leaf, is at
    most 2e-2 of that leaf's norm plus three times the reference's own
    bf16 error. Routing by bf16 scores sends a few tokens to other experts,
    so smoke granite's MoE leaves are off by 6-9% of their norm in the
    reference and up to 14% in the port; a zero, mis-cast or wrong leaf is
    off by about its whole norm."""
    _, _, tcfg, trc = _configs(arch, "float32")
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), params), tcfg, device="cpu")
    tparams.requires_grad_(True)
    _, g32 = tsteps.loss_and_grads(tparams, tcfg, trc, _torch_batch(batch))
    exact = _leaves(bridge.params_to_numpy(tparams, tcfg, g32))
    g, w = _leaves(got), _leaves(want)
    for k, e in exact.items():
        norm = np.linalg.norm(e)
        port = np.linalg.norm(g[k] - e)
        ref = np.linalg.norm(_np(w[k]) - e)
        assert port <= 2e-2 * norm + 3 * ref, (
            f"{arch} bf16 grad {k}: off the exact one by {port}, the "
            f"reference by {ref}, of norm {norm}")


# ---------------------------------------------------------------- pieces


def test_softmax_xent_matches_reference():
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 2, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 2, 7)).astype(np.int32)
    got = tlayers.softmax_xent(torch.from_numpy(logits),
                               torch.from_numpy(labels))
    want = jlayers.softmax_xent(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # bf16 logits are widened to f32 first, as the reference does
    lb = torch.from_numpy(logits).bfloat16()
    got16 = tlayers.softmax_xent(lb, torch.from_numpy(labels))
    want16 = jlayers.softmax_xent(jnp.asarray(logits, jnp.bfloat16),
                                  jnp.asarray(labels))
    np.testing.assert_allclose(float(got16), float(want16), rtol=1e-6)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("kv_heads,block", [(2, 16), (4, 64), (1, 8)])
def test_chunked_attention_causal_matches_reference(kv_heads, block,
                                                    softcap):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 64, kv_heads, 16)).astype(np.float32)
            for _ in range(2))
    got = tattn.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=True, kv_block=block,
                                  logit_softcap=softcap)
    want = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=True, q_block=block,
                                   kv_block=block, logit_softcap=softcap)
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_chunked_attention_padded_keys_match_reference(q_dtype):
    """Non-causal over the VLM's 1601 vision tokens: 512-key blocks, the
    last one padded and its padding masked; a bf16 query against f32 K/V
    (the VLM's training forward) promotes to f32 as the reference's
    einsum does, the output back in the query's dtype."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 1601, 2, 16)).astype(np.float32)
            for _ in range(2))
    tq = torch.from_numpy(q).to(getattr(torch, q_dtype))
    got = tattn.chunked_attention(tq, torch.from_numpy(k),
                                  torch.from_numpy(v), causal=False,
                                  kv_block=512)
    want = jattn.chunked_attention(jnp.asarray(q, q_dtype), jnp.asarray(k),
                                   jnp.asarray(v), causal=False, q_block=16,
                                   kv_block=512)
    assert got.dtype == tq.dtype and got.shape == (2, 32, 4, 16)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(q_dtype))


@pytest.mark.parametrize("name", NAMES)
def test_block_apply_matches_reference(host_mesh, name):
    jcfg, _, tcfg, _ = _configs("qwen3-1.7b", name)
    with jax.set_mesh(host_mesh):
        params = JM.init_model(jax.random.PRNGKey(0), jcfg)
    layer = jax.tree_util.tree_map(lambda a: np.asarray(a[1]),
                                   params["blocks"])
    tblock = bridge._block(layer, lambda a: bridge.to_tensor(a, "cpu"), ())
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((B, S, jcfg.d_model)) * 0.5).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want = jax.jit(lambda p, x, pos: jtransformer.block_apply(
        p, jcfg, x, pos, q_block=8, kv_block=8))(
            layer, jnp.asarray(x, name), jnp.asarray(pos))
    got = ttransformer.block_apply(tblock, tcfg,
                                   torch.from_numpy(x).to(
                                       getattr(torch, name)),
                                   torch.from_numpy(pos.copy()),
                                   kv_block=8)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))


# ---------------------------------------------------------- loss and grads


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(host_mesh, arch, name):
    jcfg, rc, params, specs, tcfg, trc, tparams = _models(host_mesh, arch,
                                                          name)
    batch = _batch(jcfg)
    with jax.set_mesh(host_mesh):
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p, b: JM.loss_fn(p, jcfg, rc, b, specs)))(
                params, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = tsteps.loss_and_grads(tparams, tcfg, trc, _torch_batch(batch))
    assert tl.dtype == torch.float32 and tl.shape == ()
    np.testing.assert_allclose(float(tl), float(jl), **_tol(name))
    assert abs(float(tl) - np.log(tcfg.vocab_size)) < 1.5
    got = bridge.params_to_numpy(tparams, tcfg, tg)
    _assert_tree_close(got, jg, _tol(name), f"{arch} {name} grad")
    if name == "bfloat16":
        _assert_bf16_grads_accurate(arch, params, batch, got, jg)
    for p, g in zip(tparams.parameters(), tg):
        assert g.dtype == p.dtype and g.shape == p.shape


def test_remat_and_policies_give_the_same_grads():
    """Remat off, on with nothing saved, and on saving the weight products
    give the same loss and gradients (only the schedule changes)."""
    cfg = dataclasses.replace(treg.smoke("granite-moe-1b-a400m"),
                              dtype="float32")
    batch = _torch_batch(_batch(cfg, seed=5))
    out = {}
    for remat, policy in ((False, "none"), (True, "none"), (True, "dots")):
        rc = TRunConfig(model=cfg, shape=TSHAPES["train_4k"],
                        mesh=TMeshConfig(), remat=remat,
                        remat_policy=policy)
        params = TM.init_model(cfg, seed=0, device="cpu")
        params.requires_grad_(True)
        out[(remat, policy)] = tsteps.loss_and_grads(params, cfg, rc, batch)
    base_l, base_g = out[(False, "none")]
    for key, (l, g) in out.items():
        torch.testing.assert_close(l, base_l, atol=1e-6, rtol=1e-6)
        for a, b in zip(g, base_g):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------- the stream


def _linear_layers(n_layers, d, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn((d, d), generator=gen) * (0.5 / np.sqrt(d))
            for _ in range(n_layers)]


@pytest.mark.parametrize("depth,granularity,mode", [
    (0, 1, "train"), (1, 1, "train"), (2, 1, "train"), (1, 2, "train"),
    (0, 1, "infer"), (1, 1, "infer"), (2, 1, "infer"), (2, 2, "infer"),
])
def test_stream_layers_matches_direct_loop(depth, granularity, mode):
    """The SR schedule is a pure schedule change (``tests/test_core.py``'s
    cases): the same numbers as the direct layer loop."""
    ws = _linear_layers(5, 8)
    x0 = torch.randn((3, 8), generator=torch.Generator().manual_seed(1))

    seen = []

    def body(x, w):
        seen.append(w)
        return torch.tanh(x @ w)

    out = sr.stream_layers(body, x0, ws, prefetch_depth=depth,
                           granularity=granularity, mode=mode, remat=False)
    ref = x0
    for w in ws:
        ref = torch.tanh(ref @ w)
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-6)
    assert all(a is b for a, b in zip(seen, ws)) and len(seen) == len(ws)


@pytest.mark.parametrize("remat,policy", [(False, "none"), (True, "none"),
                                          (True, "dots")])
def test_stream_layers_grad_matches_direct_loop(remat, policy):
    """Forward and gradient of the train stream, with remat on and off and
    each policy, against the direct loop (``tests/test_core.py:52``)."""
    ws = [w.requires_grad_(True) for w in _linear_layers(4, 6)]
    x0 = torch.randn((2, 6), generator=torch.Generator().manual_seed(1))

    def body(carry, w):
        x, aux = carry
        y = torch.tanh(x @ w)
        return y, aux + y.sum()

    out, aux = sr.stream_layers(
        body, (x0, torch.zeros(())), ws, prefetch_depth=1, mode="train",
        remat=remat, remat_policy=policy)
    got = torch.autograd.grad((out ** 2).sum() + aux, ws)
    x, aux_ref = x0, torch.zeros(())
    for w in ws:
        x = torch.tanh(x @ w)
        aux_ref = aux_ref + x.sum()
    want = torch.autograd.grad((x ** 2).sum() + aux_ref, ws)
    torch.testing.assert_close(out, x, atol=1e-6, rtol=1e-6)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


# ------------------------------------------------- kernel route, refusals


def test_pallas_loss_equals_plain_and_refuses_grad():
    """``use_pallas`` sends the dense blocks' attention through the
    flash-prefill wrapper (its plain version here, on the CPU): the same
    loss as ``chunked_attention`` within 2e-3 under ``no_grad``, and a
    forward under grad is refused -- the kernel has no backward."""
    cfg = treg.smoke("qwen3-1.7b")
    params = TM.init_model(cfg, seed=0, device="cpu")
    params.requires_grad_(True)
    batch = _torch_batch(_batch(cfg, b=2, s=64))
    losses = {}
    for flag in (False, True):
        rc = TRunConfig(model=cfg, shape=TSHAPES["train_4k"],
                        mesh=TMeshConfig(), use_pallas=flag)
        with torch.no_grad():
            losses[flag] = float(TM.loss_fn(params, cfg, rc, batch))
    np.testing.assert_allclose(losses[False], losses[True], atol=2e-3,
                               rtol=2e-3)
    rc = TRunConfig(model=cfg, shape=TSHAPES["train_4k"], mesh=TMeshConfig(),
                    use_pallas=True)
    with pytest.raises(RuntimeError, match="no backward"):
        tsteps.loss_and_grads(params, cfg, rc, batch)
    opt_cfg = tadamw.AdamWConfig(warmup_steps=0)
    step = tsteps.build_train_step(cfg, rc, opt_cfg)
    with pytest.raises(RuntimeError, match="no backward"):
        step(tsteps.init_state(params, rc, opt_cfg), batch)


def test_kernel_wrappers_refuse_inputs_that_require_grad():
    """Both wrappers whose kernels have no backward refuse, under grad,
    inputs that require grad (here through their plain route), and run
    under ``no_grad``."""
    from repro_torch.kernels.flash_attention.ops import flash_prefill
    from repro_torch.kernels.mamba2_scan.ops import ssd
    q = torch.randn((1, 8, 2, 16), requires_grad=True)
    kc = torch.randn((1, 8, 2, 16))
    pos = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="flash_prefill has no backward"):
        flash_prefill(q, kc, kc, pos)
    xdt = torch.randn((1, 8, 2, 4), requires_grad=True)
    bm = torch.randn((1, 8, 4))
    la = -torch.rand((1, 8, 2))
    with pytest.raises(RuntimeError, match="ssd has no backward"):
        ssd(xdt, bm, bm, la)
    with torch.no_grad():
        assert flash_prefill(q, kc, kc, pos).shape == q.shape
        assert ssd(xdt, bm, bm, la)[0].shape == xdt.shape
    assert flash_prefill(q.detach(), kc, kc, pos).shape == q.shape


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_input_specs_match_reference(arch):
    from repro.launch import steps as jsteps
    jcfg, rc, tcfg, trc = _configs(arch, "bfloat16")
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=8)
    want = jsteps.input_specs(jcfg, shape, rc)
    got = tsteps.input_specs(tcfg, dataclasses.replace(
        TSHAPES["train_4k"], global_batch=8), trc)
    assert sorted(got) == sorted(want)
    for k, (shp, dt) in got.items():
        assert shp == want[k].shape
        assert str(dt).removeprefix("torch.") == str(want[k].dtype)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m",
                                  "zamba2-2.7b", "xlstm-125m"])
def test_train_step_decreases_loss(arch):
    """``tests/test_models.py``'s five steps on the port."""
    cfg = treg.smoke(arch)
    rc = TRunConfig(model=cfg, shape=TSHAPES["train_4k"], mesh=TMeshConfig())
    opt_cfg = tadamw.AdamWConfig(learning_rate=1e-2, warmup_steps=0)
    state = tsteps.init_state(TM.init_model(cfg, seed=0, device="cpu"), rc,
                              opt_cfg)
    step = tsteps.build_train_step(cfg, rc, opt_cfg)
    batch = _torch_batch(_batch(cfg))
    losses = []
    for _ in range(5):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], (arch, losses)
