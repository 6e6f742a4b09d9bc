"""Training over the data axis, every family, against the reference at
the same mesh, on the CPU.

The reference's ``build_train_step`` runs on a (2, 1) mesh of two forced
host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``, one
subprocess for every case of this file): its state placed by
``steps.state_specs`` (weights, m, v and the f32 master FSDP-sharded over
the data axis on the POOL tier), the batch by ``steps.batch_specs``, the
gradients pinned to the pool specs by ``ds.apply_ds``; it writes the
loss, the gradients after DS and the state after one AdamW step, both
from one compiled program a case, its layer scan at SR depth 0 (in
training the reference's depth only sets how far its scan is unrolled,
``unroll = depth + 1``: the same values from half the program to
compile). The port runs the same cases as two gloo ranks (``launch.mesh.spawn``, a
``file://`` rendezvous under the test's temporary directory), each
placing the reference's weights and a fresh AdamW state by their tier
(``launch.steps.init_state(mesh=)``: its FSDP shards on POOL) and taking
its rows of the batch, through ``launch.steps.build_train_step(mesh=
)``: each layer gathered in its remat'd body, its gradients reduce-
scattered by the deterministic store, AdamW on the shards.

Held, for the dense, MoE, audio, hybrid, VLM and xLSTM families (smoke
sizes, batch 4 x 32 from ``np.random.default_rng(0)``, AdamW at lr 1e-2
without warmup): in f32 the loss (3e-5), every gradient -- each rank's
shard concatenated to the whole -- within 3e-5 (atol and rtol, element
by element, as the one-rank tests), and one AdamW step: m and v (the
gradients' bound carried through their updates, element by element),
the masters and the
parameters (within 2 lr: at step 1 a master moves by lr times the sign of
its gradient, and a near-zero gradient's sign may part between the two
libraries) and, where the gradient's sign is sure, a master moved by lr
within lr / 2 (``tests/test_torch_optim.py``'s rule). The bf16 cases are
``tests/test_torch_dp_train_bf16.py``'s.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
from repro_torch.launch import mesh
from repro_torch.launch import steps as tsteps
from repro_torch.optim import adamw as tadamw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("qwen3-1.7b", "granite-moe-1b-a400m", "musicgen-large",
            "zamba2-2.7b", "llama-3.2-vision-11b", "xlstm-125m")
B, S = 4, 32
LR = 1e-2
SPAWN_TIMEOUT_S = 300.0
F32_TOL = dict(atol=3e-5, rtol=3e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def case(name, arch, dtype="float32", shape=(2, 1), multi_pod=False,
         ds=True, int8_ef=False, microbatches=1, step=True, tier="pool",
         granularity=1, host_memory=False, opt_tier=None, over=None,
         same_as=None):
    """One training case: the reference's and the port's run configs
    (``tier``: the parameters' and, unless ``opt_tier`` names its own, the
    optimizer state's; with ``host_memory`` the port keeps a "host" tier
    in host arenas, ``enable_host_tier``, which the reference cannot on
    the CPU; ``over``: fields of the smoke config replaced in both;
    ``same_as``: an earlier case at the same mesh whose reference program
    computes this one's values -- it differs only in a knob that moves
    no value in the reference, its DS mode, gather granularity or tier
    placement -- so the reference reuses them and counts only this
    case's bytes)."""
    return dict(name=name, arch=arch, dtype=dtype, shape=list(shape),
                multi_pod=multi_pod, ds=ds, int8_ef=int8_ef,
                microbatches=microbatches, step=step, tier=tier,
                granularity=granularity, host_memory=host_memory,
                opt_tier=opt_tier or tier, over=over or {}, same_as=same_as)


def np_batch(arch, seed=0):
    """tokens, labels (and the VLM's f32 vision embeddings), B x S."""
    cfg = jreg.smoke(arch)
    rng = np.random.default_rng(seed)
    shape = (B, cfg.n_codebooks, S) if cfg.family == "audio" else (B, S)
    out = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = (rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def np_params(arch, dtype):
    """The reference's smoke weights (``PRNGKey(0)``), numpy leaves (bf16
    as 2-byte voids, which pickle without ml_dtypes)."""
    cfg = dataclasses.replace(jreg.smoke(arch), dtype=dtype)
    params = JM.init_model(jax.random.PRNGKey(0), cfg)

    def leaf(a):
        a = np.asarray(a)
        return a.view(np.dtype("V2")) if a.dtype.name == "bfloat16" else a
    return jax.tree_util.tree_map(leaf, params)


_JAX = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json, sys
    import repro  # installs the jax < 0.5 compat shims
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import registry
    from repro.configs.base import MeshConfig, RunConfig, SHAPES
    from repro.core import deterministic_store as ds
    from repro.core import hdm
    from repro.launch import steps
    from repro.launch.mesh import make_production_mesh
    from repro.models import model as M
    from repro.optim import adamw, compression
    from repro.parallel import sharding as shlib

    cases, batches, lr, out_dir = json.loads(sys.stdin.read())

    def flat(tree, prefix):
        return {prefix + "/" + "/".join(str(getattr(k, "key", k))
                                        for k in path): np.asarray(
                    leaf, np.float32)
                for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}

    params, done = {}, {}
    for c in cases:
        cfg = dataclasses.replace(registry.smoke(c["arch"]),
                                  dtype=c["dtype"], **c["over"])
        b = {k: np.asarray(v, np.float32 if k == "vision_embeds"
                           else np.int32)
             for k, v in batches[c["arch"]].items()}
        shape = dataclasses.replace(SHAPES["train_4k"],
                                    global_batch=b["tokens"].shape[0],
                                    seq_len=b["tokens"].shape[-1])
        rc = RunConfig(model=cfg, shape=shape,
                       mesh=MeshConfig(multi_pod=c["multi_pod"]),
                       ds_enabled=c["ds"], microbatches=c["microbatches"],
                       grad_compression="int8_ef" if c["int8_ef"]
                       else "none", param_tier=c["tier"],
                       optimizer_tier=c["opt_tier"],
                       sr_granularity=c["granularity"], sr_prefetch_depth=0)
        opt_cfg = adamw.AdamWConfig(learning_rate=lr, warmup_steps=0)
        if (c["arch"], c["dtype"]) not in params:
            params[c["arch"], c["dtype"]] = M.init_model(
                jax.random.PRNGKey(0), cfg)
        p0 = params[c["arch"], c["dtype"]]
        pmesh = make_production_mesh(shape=tuple(c["shape"]))
        stores = [hdm.HDMStore(pmesh, tier=tier,
                               multi_pod_fsdp=rc.mesh.multi_pod)
                  for tier in (rc.param_tier, rc.optimizer_tier)]

        def state_bytes(st):
            # the weights (and residuals) under the parameter tier, the
            # optimizer state under its own
            trees = [(st.params, 0), (st.opt.m, 1), (st.opt.v, 1),
                     (st.opt.master, 1), (st.residuals, 0)]
            return np.asarray(sum(hdm.bytes_per_device(t, stores[i])
                                  for t, i in trees if t is not None))
        if c["same_as"]:
            out = dict(done[c["same_as"]])
            with jax.set_mesh(pmesh):
                out["bytes"] = state_bytes(steps.state_shapes(cfg, rc,
                                                              opt_cfg))
            np.savez(os.path.join(out_dir, c["name"] + ".npz"), **out)
            continue
        with jax.set_mesh(pmesh):
            st_shapes = steps.state_shapes(cfg, rc, opt_cfg)
            st_shard = steps.shardings(pmesh, steps.state_specs(
                cfg, rc, st_shapes))
            bshard = shlib.shardings_from_specs(
                pmesh, steps.batch_specs(cfg, shape, rc))
            res = (compression.init_residuals(p0) if c["int8_ef"]
                   else None)
            state = jax.device_put(steps.TrainState(
                p0, adamw.init(p0, opt_cfg), res), st_shard)
            batch = jax.device_put({k: jnp.asarray(v).astype(
                cfg.dtype if k == "vision_embeds" else jnp.int32)
                for k, v in b.items()}, bshard)
            pspecs = shlib.param_specs(p0, tier=rc.param_tier,
                                       multi_pod_fsdp=rc.mesh.multi_pod)
            one = dataclasses.replace(rc, microbatches=1)

            def lg(p, bt):
                loss, g = jax.value_and_grad(
                    lambda q: M.loss_fn(q, cfg, one, bt, pspecs))(p)
                return loss, ds.apply_ds(g, pspecs, rc.ds_enabled)
            train_step = steps.build_train_step(cfg, rc, opt_cfg)

            def both(st, bt):
                # the loss and DS's gradients, and one step from the same
                # state: one compiled program for the two
                loss, grads = lg(st.params, bt)
                if not c["step"]:
                    return loss, grads
                return (loss, grads) + train_step(st, bt)
            got = jax.jit(both, in_shardings=(st_shard, bshard))(state,
                                                                 batch)
            loss, grads = got[:2]
            out = {"loss": np.asarray(loss, np.float32)}
            out.update(flat(grads, "g"))
            if c["int8_ef"]:
                for path, g in jax.tree_util.tree_leaves_with_path(grads):
                    key = "/".join(str(getattr(k, "key", k)) for k in path)
                    q, s = compression._quantize(g)
                    out["q/" + key] = np.asarray(q).reshape(-1)[:g.size]
                    out["s/" + key] = np.asarray(s).reshape(-1)
            if c["step"]:
                new, metrics = got[2:]
                out["step_loss"] = np.asarray(metrics["loss"], np.float32)
                out["grad_norm"] = np.asarray(metrics["grad_norm"],
                                              np.float32)
                out.update(flat(new.params, "p"))
                out.update(flat(new.opt.m, "m"))
                out.update(flat(new.opt.v, "v"))
                out.update(flat(new.opt.master, "master"))
                if new.residuals is not None:
                    out.update(flat(new.residuals, "r"))
                out["bytes"] = state_bytes(new)
        done[c["name"]] = out
        np.savez(os.path.join(out_dir, c["name"] + ".npz"), **out)
    print("JAX_TRAIN done")
""")


def run_reference(cases, out_dir):
    """Start the reference's cases in a subprocess; returns a function that
    waits for it and gives back ``{name: {key: array}}``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    log = os.path.join(out_dir, "jax.log")
    batches = {c["arch"]: {k: v.tolist() for k, v in
                           np_batch(c["arch"]).items()} for c in cases}
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", _JAX], stdin=subprocess.PIPE,
            stdout=err, stderr=subprocess.STDOUT, text=True, env=env)
    proc.stdin.write(json.dumps([cases, batches, LR, out_dir]))
    proc.stdin.close()

    def result():
        try:
            proc.wait(timeout=900)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        with open(log) as err:
            text = err.read()
        assert "JAX_TRAIN done" in text, text[-3000:]
        out = {}
        for c in cases:
            with np.load(os.path.join(out_dir, c["name"] + ".npz")) as z:
                out[c["name"]] = {k: z[k] for k in z.files}
        return out
    return result


def run_config(c, cfg):
    return RunConfig(model=cfg, shape=SHAPES["train_4k"],
                     mesh=MeshConfig(multi_pod=c["multi_pod"]),
                     ds_enabled=c["ds"], microbatches=c["microbatches"],
                     grad_compression="int8_ef" if c["int8_ef"] else "none",
                     param_tier=c["tier"], optimizer_tier=c["opt_tier"],
                     sr_granularity=c["granularity"],
                     enable_host_tier=c.get("host_memory", False))


def train_case(rank_mesh, c, params_np):
    """One rank's run of case ``c`` on the mesh: its shard of the
    reference's weights, its rows of the batch; the loss and the
    gradients (its shards), then one step's state (its shards) and
    metrics, and the collectives of that step by axis."""
    from repro_torch.data.pipeline import rows_of
    cfg = dataclasses.replace(treg.smoke(c["arch"]), dtype=c["dtype"],
                              **c.get("over", {}))
    rc = run_config(c, cfg)
    opt_cfg = tadamw.AdamWConfig(learning_rate=LR, warmup_steps=0)
    group = tsteps.batch_group(rc, rank_mesh)
    batch = {k: torch.from_numpy(v) for k, v in
             rows_of(np_batch(c["arch"]), group.rank, group.size).items()}
    if "vision_embeds" in batch:
        batch["vision_embeds"] = batch["vision_embeds"].to(
            getattr(torch, c["dtype"]))
    state = tsteps.init_state(bridge.params_from_jax(
        params_np, cfg, device="cpu"), rc, opt_cfg, mesh=rank_mesh)
    from repro_torch.core import deterministic_store as ds
    ranks = tsteps.train_ranks_of(rc, rank_mesh)
    reducer = (None if ranks.fsdp is None
               else ds.GradReducer(ranks.fsdp, c["ds"]))
    one = dataclasses.replace(rc, microbatches=1)
    loss, grads = tsteps.loss_and_grads(state.params, cfg, one, batch,
                                        group=ranks.fsdp, reducer=reducer,
                                        ranks=ranks)
    specs = tsteps.param_spec_list(state.params, rc)
    grads = ds.apply_ds(grads, specs, group=ranks.fsdp)
    from repro_torch.parallel import sharding
    axes = sharding.fsdp_axes(state.params)
    moves = tsteps.state_moves(state.params, rc, rank_mesh)
    out = {"loss": float(loss), "grads": [bridge.to_numpy(g) for g in grads],
           "axes": axes,
           "opt_axes": [a if mv is None else None if mv[0] == "gather"
                        else mv[1] for a, mv in zip(axes, moves)],
           "model_axes": [s.index("model") if "model" in s else None
                          for s in specs],
           "coords": rank_mesh.coords,
           "on_host": [sharding.host_target(t) is not None for t in (
               *state.params.parameters(), *state.opt.m, *state.opt.v,
               *state.opt.master)]}
    if c["step"]:
        from repro_torch.core import hdm
        out["bytes"] = hdm.bytes_per_device(state, hdm.HDMStore(
            rank_mesh, tier=c["tier"]))
        mesh.COLLECTIVES.clear()
        state, metrics = tsteps.build_train_step(cfg, rc, opt_cfg,
                                                 mesh=rank_mesh)(state, batch)
        out["collectives"] = dict(mesh.COLLECTIVES)
        out["step_loss"] = float(metrics["loss"])
        out["grad_norm"] = float(metrics["grad_norm"])
        out["params"] = [bridge.to_numpy(p)
                         for p in state.params.parameters()]
        for k in ("m", "v", "master"):
            out[k] = [bridge.to_numpy(t) for t in getattr(state.opt, k)]
        if state.residuals is not None:
            out["residuals"] = [bridge.to_numpy(t) for t in state.residuals]
    return out


def rank_main(group, cases, params_np):
    """One rank of the world: every case whose mesh has this world's
    size, each on a mesh built over the joined world."""
    out = {}
    for c in cases:
        if int(np.prod(c["shape"])) == group.size:
            rank_mesh = mesh.init_mesh(group.rank, c["shape"], device="cpu")
            out[c["name"]] = train_case(rank_mesh, c,
                                        params_np[c["arch"], c["dtype"]])
    return out


def run_port(cases, tmp_path_factory, sizes=(2,)):
    """Every case on spawned gloo ranks, one spawn per world size:
    ``{name: [each rank's result]}``."""
    params_np = {(c["arch"], c["dtype"]): np_params(c["arch"], c["dtype"])
                 for c in cases}
    out = {}
    for size in sizes:
        ranks = mesh.spawn(rank_main, size, (cases, params_np),
                           rendezvous_dir=str(tmp_path_factory.mktemp("rdv")),
                           device="cpu", timeout_s=SPAWN_TIMEOUT_S)
        for r in ranks:
            for name, res in r.items():
                out.setdefault(name, []).append(res)
    return out


def joined(runs, c, key):
    """A per-rank list (``key``) put together whole: each FSDP leaf's
    shards of the ranks of the FSDP group (the world's first pod, in rank
    order) concatenated along its axis (the optimizer state's own axes
    for m, v and the masters), then each model-axis leaf's parts of the
    model ranks along its model axis; a whole leaf from rank 0."""
    p_n, d_n, n_m = mesh.mesh_shape3(c["shape"])
    n = p_n * d_n if c["multi_pod"] else d_n
    first = runs[0]
    axes = first["opt_axes" if key in ("m", "v", "master") else "axes"]
    out = []
    for i, axis in enumerate(axes):
        m_axis = first["model_axes"][i]
        cols = []
        for m in range(1 if m_axis is None else n_m):
            if axis is None:
                cols.append(runs[m][key][i])
            else:
                cols.append(np.concatenate(
                    [runs[f * n_m + m][key][i] for f in range(n)],
                    axis=axis))
        out.append(cols[0] if m_axis is None
                   else np.concatenate(cols, axis=m_axis))
    return out


def as_tree(arch, dtype, tensors, prefix):
    """Whole tensors (aligned with the port model's parameters) as the
    reference's flat ``{prefix/path: array}``."""
    cfg = dataclasses.replace(treg.smoke(arch), dtype=dtype)
    whole = bridge.params_from_jax(np_params(arch, dtype), cfg, device="cpu")
    tree = bridge.params_to_numpy(whole, cfg, [torch.from_numpy(
        np.array(t)) for t in tensors])
    return {prefix + "/" + "/".join(str(getattr(k, "key", k))
                                    for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def assert_grads_close(got, want, tol=F32_TOL):
    """Every gradient leaf within ``tol`` of the reference's, element by
    element (the one-rank tests' rule); returns the global norm."""
    gkeys = sorted(k for k in want if k.startswith("g/"))
    assert sorted(k for k in got) == gkeys
    for k in gkeys:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)
    return np.sqrt(sum(float(np.sum(np.square(want[k]))) for k in gkeys))


def assert_step_close(runs, c, want):
    """One AdamW step against the reference's (the module docstring)."""
    arch, dtype = c["arch"], c["dtype"]
    got = {}
    for key, prefix in (("params", "p"), ("m", "m"), ("v", "v"),
                        ("master", "master"), ("grads", "g")):
        got.update(as_tree(arch, dtype, joined(runs, c, key), prefix))
    gnorm = np.sqrt(sum(float(np.sum(np.square(v))) for k, v in want.items()
                        if k.startswith("g/")))
    np.testing.assert_allclose(runs[0]["grad_norm"], want["grad_norm"],
                               rtol=3e-5)
    np.testing.assert_allclose(runs[0]["step_loss"], want["step_loss"],
                               **F32_TOL)
    one_step = 0.0
    if c["int8_ef"]:
        one_step = max(np.abs(v).max() for k, v in want.items()
                       if k.startswith("g/")) / 127.0
    clear = 3e-5 * gnorm + one_step

    def g_err(k):
        """The bound on each element of leaf ``k``'s gradient: the
        gradients' rule, and one int8 step with error feedback."""
        g = np.abs(want["g/" + k])
        return F32_TOL["atol"] + F32_TOL["rtol"] * g + one_step, g
    n_moved = 0
    p0 = as_tree(arch, dtype, [bridge.to_numpy(p) for p in
                               bridge.params_from_jax(
                                   np_params(arch, dtype), dataclasses.replace(
                                       treg.smoke(arch), dtype=dtype),
                                   device="cpu").parameters()], "master")
    for k in (k for k in want if k.startswith("master/")):
        np.testing.assert_allclose(got[k], want[k], atol=2 * LR, rtol=0,
                                   err_msg=k)
        g = got["g/" + k[len("master/"):]]
        sure = np.abs(g) > clear
        moved = np.abs(np.abs(got[k] - p0[k])[sure] - LR)
        assert moved.max(initial=0.0) <= LR / 2, k
        n_moved += int(sure.sum())
    assert n_moved > 0
    for k in (k for k in want if k.startswith("p/")):
        np.testing.assert_allclose(got[k], want[k], atol=2 * LR, rtol=0,
                                   err_msg=k)
    b1, b2 = tadamw.AdamWConfig.b1, tadamw.AdamWConfig.b2
    for k in (k for k in want if k.startswith("m/")):
        # m = (1 - b1) g, element by element
        err, _ = g_err(k[2:])
        assert np.all(np.abs(got[k] - want[k]) <= (1 - b1) * err
                      + 1e-6 * np.abs(want[k])), k
    for k in (k for k in want if k.startswith("v/")):
        # v = (1 - b2) g^2, element by element
        err, g = g_err(k[2:])
        assert np.all(np.abs(got[k] - want[k]) <= (1 - b2) * err * (
            2 * g + err) + 1e-6 * np.abs(want[k])), k


# ------------------------------------------------------------------ cases

F32_CASES = [case(f"{arch}-f32", arch) for arch in FAMILIES]
# the HOST tier in host memory at (2, 1): weights, m, v and master (the
# reference's HOST is POOL on the CPU: its POOL case's values)
HOST_CASE = case("qwen3-1.7b-host-f32", "qwen3-1.7b", tier="host",
                 host_memory=True, same_as="qwen3-1.7b-f32")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = F32_CASES + [HOST_CASE]
    out_dir = str(tmp_path_factory.mktemp("dp_train"))
    result = run_reference(cases, out_dir)
    port = run_port(cases, tmp_path_factory)
    return port, result()


@pytest.mark.parametrize("arch", FAMILIES)
def test_dp_loss_and_grads_match_reference_f32(runs, arch):
    """At (2, 1) in f32: the global loss on every rank, and every
    gradient after the deterministic store (each rank's shard, put
    together) against the reference's at the same mesh."""
    port, ref = runs
    c = next(c for c in F32_CASES if c["arch"] == arch)
    got, want = port[c["name"]], ref[c["name"]]
    for r in got:
        np.testing.assert_allclose(r["loss"], want["loss"], **F32_TOL)
    assert_grads_close(as_tree(arch, "float32", joined(got, c, "grads"),
                               "g"), want)


@pytest.mark.parametrize("arch", FAMILIES)
def test_dp_adamw_step_matches_reference_f32(runs, arch):
    """One whole train step at (2, 1) in f32: params, m, v and masters
    (each rank's shards put together) against the reference's."""
    port, ref = runs
    c = next(c for c in F32_CASES if c["arch"] == arch)
    assert_step_close(port[c["name"]], c, ref[c["name"]])


def test_dp_host_tier_matches_reference_and_pool(runs):
    """(host, host) at (2, 1), each rank's shards of the weights, m, v and
    master in host arenas: the loss, the gradients and the AdamW step
    against the reference's at ``tier="host"``, and every number bit for
    bit the POOL case's (the same shards, the same collectives)."""
    port, ref = runs
    c = HOST_CASE
    got, want = port[c["name"]], ref[c["name"]]
    for r in got:
        assert all(r["on_host"])
        np.testing.assert_allclose(r["loss"], want["loss"], **F32_TOL)
    assert_grads_close(as_tree(c["arch"], "float32", joined(got, c, "grads"),
                               "g"), want)
    assert_step_close(got, c, want)
    pool = port["qwen3-1.7b-f32"]
    for r, q in zip(got, pool):
        assert not any(q["on_host"])
        assert r["loss"] == q["loss"] and r["step_loss"] == q["step_loss"]
        assert r["collectives"] == q["collectives"]
        for key in ("grads", "params", "m", "v", "master"):
            for a, b in zip(r[key], q[key]):
                np.testing.assert_array_equal(a, b, err_msg=key)
