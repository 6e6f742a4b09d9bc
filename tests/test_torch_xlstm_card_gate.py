"""The reference's own bf16 error at the inputs of ``chip_smoke.py``'s
bf16 gate for xlstm-125m, on the CPU.

The card has no reference, so ``chip_smoke.py`` runs PR 20's bf16 leaf
rule (each bf16 gradient leaf within 2e-2 of its norm plus three times
the reference's own bf16 error, off the f32 twin's) at inputs the
reference runs at here: xlstm-125m at full width cut to its first group
(6 layers), weights redrawn by numpy from the seed
(``chip_smoke.xlstm_gate_model``), a batch of 2 x 256 tokens. Held: the
weights hash to ``XLSTM_GATE_SHA`` (the card checks the same hash); the
reference's bf16 gradients, leaf by leaf, are off its f32 ones by the
shares ``XLSTM_GATE_REF_ERR`` records (1e-2 of each); the port on the
CPU passes the rule the card applies. ``python tests/
test_torch_xlstm_card_gate.py`` prints the hash and the shares to
record.
"""
import dataclasses
import importlib.util
import json
import os
import sys

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
from repro_torch.configs.base import MeshConfig as TMeshConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.launch import steps as tsteps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _shares(names, a, b):
    return CS.bf16_shares(names, a, b)


def measure(host_mesh):
    """(sha, the reference's shares, the port's shares, losses) at the
    gate's inputs."""
    cfg, params, batch = CS.xlstm_gate_model(torch.device("cpu"))
    names = [n for n, _ in params.named_parameters()]
    np_tree = bridge.params_to_numpy(params, cfg)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    grads = {}
    for name in ("bfloat16", "float32"):
        jcfg = dataclasses.replace(jreg.get(cfg.arch_id),
                                   n_layers=cfg.n_layers, dtype=name)
        rc = RunConfig(model=jcfg, shape=SHAPES["train_4k"],
                       mesh=MeshConfig())
        with jax.set_mesh(host_mesh):
            shapes = jax.eval_shape(
                lambda: JM.init_model(jax.random.PRNGKey(0), jcfg))
            specs = shlib.param_specs(shapes)
            p = jax.tree_util.tree_map(
                lambda a, s: jnp.asarray(a, s.dtype), np_tree, shapes)
            loss, g = jax.jit(jax.value_and_grad(
                lambda p, b: JM.loss_fn(p, jcfg, rc, b, specs)))(
                    p, {k: jnp.asarray(v) for k, v in batch.items()})
        g = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), g)
        grads[name] = (float(loss), list(bridge.params_from_jax(
            g, cfg32, device="cpu").parameters()))
    ref = _shares(names, grads["bfloat16"][1], grads["float32"][1])
    rc = TRunConfig(model=cfg, shape=TSHAPES["train_4k"],
                    mesh=TMeshConfig())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    wide = bridge.params_from_jax(np_tree, cfg32, device="cpu")
    wide.requires_grad_(True)
    params.requires_grad_(True)
    l16, g16 = tsteps.loss_and_grads(params, cfg, rc, tb)
    l32, g32 = tsteps.loss_and_grads(
        wide, cfg32, dataclasses.replace(rc, model=cfg32), tb)
    port = _shares(names, g16, g32)
    losses = {"ref": (grads["bfloat16"][0], grads["float32"][0]),
              "port": (float(l16), float(l32))}
    return CS.weights_sha(params), ref, port, losses


@pytest.fixture(scope="module")
def measured(host_mesh):
    return measure(host_mesh)


def test_gate_weights_hash_to_the_recorded_sha(measured):
    assert measured[0] == CS.XLSTM_GATE_SHA


def test_reference_bf16_error_is_the_recorded_one(measured):
    _, ref, _, losses = measured
    assert sorted(ref) == sorted(CS.XLSTM_GATE_REF_ERR)
    for k, x in ref.items():
        np.testing.assert_allclose(x, CS.XLSTM_GATE_REF_ERR[k], rtol=1e-2,
                                   err_msg=k)
    assert abs(losses["ref"][0] - losses["ref"][1]) < 2e-2


def test_port_passes_the_card_gate_on_the_cpu(measured):
    _, _, port, losses = measured
    over = {k: (x, CS.bf16_limit(k)) for k, x in port.items()
            if x > CS.bf16_limit(k)}
    assert not over
    np.testing.assert_allclose(losses["port"][1], losses["ref"][1],
                               rtol=3e-5)
    np.testing.assert_allclose(losses["port"][0], losses["port"][1],
                               atol=2e-2, rtol=2e-2)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro.launch.mesh import make_host_mesh
    sha, ref, port, losses = measure(make_host_mesh())
    print(json.dumps({"sha": sha, "ref": {k: float(f"{v:.4g}") for k, v
                                          in ref.items()},
                      "port_cpu": port, "losses": losses}, indent=1))
