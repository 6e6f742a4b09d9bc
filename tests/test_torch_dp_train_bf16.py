"""Training over the data axis in bf16, every family, against the
reference at the same mesh, on the CPU.

The machinery of ``tests/test_torch_dp_train.py`` (the reference's
``build_train_step`` pieces at (2, 1) in one subprocess of forced host
devices; the port's two gloo ranks on their shards), in bf16 (smoke
sizes, batch 4 x 32 from ``np.random.default_rng(0)``): the loss within
2e-2 on every rank, every gradient after the deterministic store (the
ranks' shards put together) within 2e-2 and by the bf16 leaf rule
(``tests/test_torch_train.py``): leaf by leaf no farther from the port's
f32 gradient of the same bf16 weights (one rank, the whole batch) than
2e-2 of the leaf's norm plus three times the reference's own distance
from it.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
from repro_torch.launch import steps as tsteps

from test_torch_dp_train import (BF16_TOL, FAMILIES, as_tree, case, joined,
                                 np_batch, np_params, run_port,
                                 run_reference)

BF16_CASES = [case(f"{arch}-bf16", arch, "bfloat16", step=False)
              for arch in FAMILIES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("dp_train_bf16"))
    result = run_reference(BF16_CASES, out_dir)
    port = run_port(BF16_CASES, tmp_path_factory)
    return port, result()


@pytest.mark.parametrize("arch", FAMILIES)
def test_dp_loss_and_grads_match_reference_bf16(runs, arch):
    """At (2, 1) in bf16: the loss within 2e-2, the gradients within 2e-2
    and, leaf by leaf, by the bf16 leaf rule against the port's f32
    gradient of the same bf16 weights (one rank, the whole batch)."""
    port, ref = runs
    c = next(c for c in BF16_CASES if c["arch"] == arch)
    got_runs, want = port[c["name"]], ref[c["name"]]
    for r in got_runs:
        np.testing.assert_allclose(r["loss"], want["loss"], **BF16_TOL)
    got = as_tree(arch, "bfloat16", joined(got_runs, c, "grads"), "g")
    for k, w in want.items():
        if k.startswith("g/"):
            np.testing.assert_allclose(got[k], w, err_msg=k, **BF16_TOL)
    cfg32 = dataclasses.replace(treg.smoke(arch), dtype="float32")
    wide = bridge.params_from_jax(jax.tree_util.tree_map(
        lambda a: bridge.to_numpy(bridge.to_tensor(a, "cpu")),
        np_params(arch, "bfloat16")), cfg32, device="cpu")
    wide.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in np_batch(arch).items()}
    _, g32 = tsteps.loss_and_grads(
        wide, cfg32, RunConfig(model=cfg32, shape=SHAPES["train_4k"],
                               mesh=MeshConfig()), batch)
    exact = as_tree(arch, "float32", [bridge.to_numpy(g) for g in g32], "g")
    for k, e in exact.items():
        norm = np.linalg.norm(e)
        port_err = np.linalg.norm(got[k] - e)
        ref_err = np.linalg.norm(want[k] - e)
        assert port_err <= 2e-2 * norm + 3 * ref_err, (
            f"{arch} bf16 grad {k}: off the exact one by {port_err}, the "
            f"reference by {ref_err}, of norm {norm}")
