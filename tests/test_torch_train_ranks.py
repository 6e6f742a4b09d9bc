"""``launch.train.train_ranks`` and the refusals of training over a rank
mesh, on the CPU.

``train_ranks`` at (2, 1) (two gloo rank processes, smoke qwen3-1.7b in
bf16, 4 sequences of 16 tokens a step): two steps equal to the first two
of an uninterrupted run, each rank's checkpoint its own shard, a resume
that replays the saved step's batch as the reference's does (ROADMAP
Queue 3) and follows the one-rank driver's resume. Training at a model
axis of 2 builds for every family (a family without training forms is
refused on any mesh); every mixed tier pair builds, on a data axis of
two and on one rank (``launch.train`` at (2, 2) is
``test_torch_tp_train.py``'s). The
deterministic store's placements (``ds_grad_specs``) equal the
reference's, on and off, with and without ``multi_pod``, and so do the
training state's (``steps.state_specs``) on both tiers.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import MeshConfig as JMeshConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import SHAPES as JSHAPES
from repro.core import deterministic_store as jds
from repro.launch import steps as jsteps
from repro.optim import adamw as jadamw
from repro.models import model as JM
from repro.parallel import sharding as jsh
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.core import deterministic_store as tds
from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
from repro_torch.launch import mesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as TM
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import sharding as tsh

ARCH = "qwen3-1.7b"


def _data_mesh(d):
    """Rank 0's place in a (d, 1) mesh, its groups built without a
    process group (enough to build a step; nothing runs on it)."""
    cpu = torch.device("cpu")
    one = mesh.RankGroup(0, 1, cpu, "gloo")
    data = mesh.RankGroup(0, d, cpu, "gloo", axis="data",
                          members=tuple(range(d)))
    return mesh.RankMesh((1, d, 1), 0, one, data, one,
                         dataclasses.replace(data, axis="pod,data"), data,
                         data)


def test_training_refuses_a_model_axis_and_mixed_tiers():
    """The model axis in training: every family builds its step and its
    state on it and passes ``check_trainable``, which refuses only a
    family without training forms. Every mixed tier pair builds
    on a data axis of two, with and without ``multi_pod``, and builds and
    places its state on one rank (the pairs' steps and the model axis's
    against the reference: ``test_torch_tp_train.py``)."""
    cfg = treg.smoke(ARCH)
    rc = RunConfig(model=cfg, shape=SHAPES["train_4k"], mesh=MeshConfig())
    opt = tadamw.AdamWConfig()
    model_axis = mesh.RankMesh.of_group(mesh.RankGroup(
        0, 2, torch.device("cpu"), "gloo"))
    assert model_axis.shape == (1, 1, 2)
    for arch in (ARCH, "granite-moe-1b-a400m", "musicgen-large",
                 "zamba2-2.7b", "llama-3.2-vision-11b", "xlstm-125m"):
        acfg = treg.smoke(arch)
        arc = dataclasses.replace(rc, model=acfg)
        tsteps.build_train_step(acfg, arc, opt, mesh=model_axis)
        tsteps.init_state(TM.init_model(acfg, device="cpu"), arc, opt,
                          mesh=model_axis)
        TM.check_trainable(acfg)
    with pytest.raises(NotImplementedError, match="not ported"):
        TM.check_trainable(dataclasses.replace(cfg, family="encoder"))
    data_axis = mesh.RankMesh.of_group(mesh.RankGroup(
        0, 1, torch.device("cpu"), "gloo"))
    two_rows = _data_mesh(2)
    for pair in (("pool", "device"), ("device", "pool"), ("device", "host"),
                 ("host", "device")):
        mixed = dataclasses.replace(rc, param_tier=pair[0],
                                    optimizer_tier=pair[1])
        TM.check_trainable(cfg)
        tsteps.build_train_step(cfg, mixed, opt, mesh=two_rows)
        tsteps.build_train_step(cfg, dataclasses.replace(
            mixed, mesh=MeshConfig(multi_pod=True)), opt, mesh=two_rows)
        tsteps.build_train_step(cfg, mixed, opt)
        tsteps.build_train_step(cfg, mixed, opt, mesh=data_axis)
        tsteps.init_state(TM.init_model(cfg, device="cpu"), mixed, opt)
    for pair in (("pool", "host"), ("host", "pool"), ("host", "host")):
        tsteps.build_train_step(cfg, dataclasses.replace(
            rc, param_tier=pair[0], optimizer_tier=pair[1]), opt,
            mesh=two_rows)


def test_train_ranks_checkpoints_and_resumes(tmp_path):
    """``train_ranks`` at (2, 1): two steps equal, bit for bit, to the
    first two of an uninterrupted three-step run; each rank's checkpoint
    (under ``rank_<r>``) its own final shard; a resume replays the saved
    step's batch, as the reference's does (steps 1 and 2), on every rank
    alike, and follows the one-rank driver's resume (bf16 2e-2)."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.launch import train
    kw = dict(smoke=True, seq_len=16, global_batch=4, device="cpu")
    full = train.train_ranks(ARCH, mesh_shape=(2, 1), steps=3, **kw)
    ck = str(tmp_path / "mesh")
    first = train.train_ranks(ARCH, mesh_shape=(2, 1), steps=2, ckpt_dir=ck,
                              **kw)
    for r in range(2):
        assert [h["loss"] for h in first[r]["history"]] == [
            h["loss"] for h in full[r]["history"][:2]]
        step, flat, extra = Checkpointer(os.path.join(
            ck, f"rank_{r}")).restore()
        assert step == 1 and extra == {"step": 2}
        assert sorted(flat) == sorted(first[r]["state"])
        for k, v in first[r]["state"].items():
            np.testing.assert_array_equal(flat[k].float().numpy(), v,
                                          err_msg=k)
    again = train.train_ranks(ARCH, mesh_shape=(2, 1), steps=2, ckpt_dir=ck,
                              resume=True, **kw)
    for r in range(2):
        assert [h["step"] for h in again[r]["history"]] == [1, 2]
        assert [h["loss"] for h in again[r]["history"]] == [
            h["loss"] for h in again[0]["history"]]
    one = str(tmp_path / "one")
    train.train(ARCH, steps=2, ckpt_dir=one, **kw)
    solo = train.train(ARCH, steps=2, ckpt_dir=one, resume=True, **kw)
    np.testing.assert_allclose([h["loss"] for h in again[0]["history"]],
                               [h["loss"] for h in solo["history"]],
                               atol=2e-2, rtol=2e-2)


def _one(axes):
    """A spec entry as the port writes it: a one-axis tuple as its axis."""
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


@pytest.mark.parametrize("enabled", [True, False])
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", [ARCH, "granite-moe-1b-a400m"])
def test_ds_grad_specs_match_reference(arch, multi_pod, enabled):
    """The gradients' placement: the pool specs with the store on, the
    gathered ones (no FSDP axis) with it off, leaf by leaf the
    reference's, its stacked axes aside."""
    cfg = jreg.smoke(arch)
    tree = jax.eval_shape(lambda: JM.init_model(jax.random.PRNGKey(0), cfg))
    want = jds.ds_grad_specs(jsh.param_specs(
        tree, tier="pool", multi_pod_fsdp=multi_pod), enabled)
    model = bridge.params_from_jax(
        jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                               tree), treg.smoke(arch), device="cpu")
    got = tds.ds_grad_specs(tsh.param_specs(
        model, tier="pool", multi_pod_fsdp=multi_pod), enabled)
    for name, spec in got.items():
        path, n_idx = tsh.ref_path(name)
        ref = want
        for part in path.split("/"):
            ref = ref[part]
        assert spec == tuple(_one(a) for a in tuple(ref)[n_idx:]), name
    assert any(tds.has_fsdp(s) for s in got.values()) == enabled


@pytest.mark.parametrize("tier", ["pool", "device"])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_state_specs_match_reference(multi_pod, tier):
    """``steps.state_specs``: the parameters', m's, v's, the masters' and
    the residuals' specs leaf by leaf the reference's ``state_specs``
    (its stacked axes aside)."""
    arch = "zamba2-2.7b"
    cfg = jreg.smoke(arch)
    over = dict(param_tier=tier, optimizer_tier=tier,
                grad_compression="int8_ef")
    rc = JRunConfig(model=cfg, shape=JSHAPES["train_4k"],
                    mesh=JMeshConfig(multi_pod=multi_pod), **over)
    opt_cfg = jadamw.AdamWConfig()
    want = jsteps.state_specs(cfg, rc, jsteps.state_shapes(cfg, rc,
                                                           opt_cfg))
    tree = jax.eval_shape(lambda: JM.init_model(jax.random.PRNGKey(0), cfg))
    model = bridge.params_from_jax(
        jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                               tree), treg.smoke(arch), device="cpu")
    trc = RunConfig(model=treg.smoke(arch), shape=SHAPES["train_4k"],
                    mesh=MeshConfig(multi_pod=multi_pod), **over)
    state = tsteps.init_state(model, trc, tadamw.AdamWConfig())
    got = tsteps.state_specs(model, trc, state)
    names = [n for n, _ in model.named_parameters()]
    for port, ref in ((got.params, want.params), (got.opt.m, want.opt.m),
                      (got.opt.v, want.opt.v),
                      (got.opt.master, want.opt.master),
                      (got.residuals, want.residuals)):
        for name, spec in zip(names, port):
            path, n_idx = tsh.ref_path(name)
            leaf = ref
            for part in path.split("/"):
                leaf = leaf[part]
            assert spec == tuple(_one(a) for a in tuple(leaf)[n_idx:]), name
