"""Guards of the port's boundaries.

* No file of ``src/repro_torch``, ``chip_smoke.py`` or
  ``benchmarks/torch_profile.py`` imports ``jax`` or the JAX package
  ``repro`` (the machine with the card has no JAX).
* Importing the port's serving engine, or its training driver, pulls in
  no JAX.
* Entry points default to the card and raise without one; they never fall
  back to the CPU unless asked.
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "benchmarks" /
                                          "torch_profile.py"]
    assert len(files) > 20
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = [(str(p.relative_to(ROOT)), root) for p in _port_files()
           for root in _imported_roots(p) if root in FORBIDDEN]
    assert bad == []


def test_engine_import_pulls_in_no_jax():
    code = ("import sys; import repro_torch.serving.engine, "
            "repro_torch.launch.serve, repro_torch.bridge, "
            "repro_torch.models.kv_quant, "
            "repro_torch.kernels.hdm_stream.ops; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); assert not bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_training_import_pulls_in_no_jax():
    code = ("import sys; import repro_torch.launch.train, "
            "repro_torch.launch.steps, repro_torch.core.speculative_read, "
            "repro_torch.core.hdm, repro_torch.optim.compression, "
            "repro_torch.checkpoint.checkpointer; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); assert not bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _default_device_calls():
    from repro_torch import bridge
    from repro_torch.configs import registry
    from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
    from repro_torch.device import resolve_device
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.launch import serve, train
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServingEngine

    cfg = registry.smoke("qwen3-1.7b")
    rc = RunConfig(model=cfg, shape=SHAPES["decode_32k"], mesh=MeshConfig())
    cpu_params = M.init_model(cfg, device="cpu")
    hcfg = registry.smoke("zamba2-2.7b")
    hrc = RunConfig(model=hcfg, shape=SHAPES["decode_32k"],
                    mesh=MeshConfig())
    return {
        "resolve_device": lambda: resolve_device(),
        "init_model": lambda: M.init_model(cfg),
        "cache_init": lambda: M.cache_init(cfg, rc, 2, 32),
        "params_from_jax": lambda: bridge.params_from_jax({}, cfg),
        "cache_from_jax": lambda: bridge.cache_from_jax({}),
        "ServingEngine": lambda: ServingEngine(cpu_params, cfg, rc),
        "serve": lambda: serve.serve("qwen3-1.7b", smoke=True),
        "cli": lambda: serve.main(["--arch", "qwen3-1.7b", "--smoke"]),
        "hybrid_init_model": lambda: M.init_model(hcfg),
        "hybrid_cache_init": lambda: M.cache_init(hcfg, hrc, 2, 32),
        "hybrid_params_from_jax": lambda: bridge.params_from_jax({}, hcfg),
        "hybrid_ServingEngine": lambda: ServingEngine(
            M.init_model(hcfg, device="cpu"), hcfg, hrc),
        "hybrid_serve": lambda: serve.serve("zamba2-2.7b", smoke=True),
        "hybrid_cli": lambda: serve.main(["--arch", "zamba2-2.7b",
                                          "--smoke"]),
        "int8_cache_init": lambda: M.cache_init(
            cfg, dataclasses.replace(rc, kv_quant="int8"), 2, 32),
        "int8_ServingEngine": lambda: ServingEngine(cpu_params, cfg, rc,
                                                    kv_quant="int8"),
        "int8_cli": lambda: serve.main(["--arch", "qwen3-1.7b", "--smoke",
                                        "--kv-quant", "int8"]),
        "train": lambda: train.train("qwen3-1.7b", smoke=True, steps=1),
        "train_cli": lambda: train.main(["--arch", "qwen3-1.7b", "--smoke",
                                         "--steps", "1"]),
        "Pipeline": lambda: Pipeline(DataConfig(vocab_size=16,
                                                global_batch=2, seq_len=4)),
        "adamw_state_from_jax": lambda: bridge.adamw_state_from_jax(
            None, cfg),
    }


@pytest.mark.parametrize("entry", ["resolve_device", "init_model",
                                   "cache_init", "params_from_jax",
                                   "cache_from_jax", "ServingEngine",
                                   "serve", "cli", "hybrid_init_model",
                                   "hybrid_cache_init",
                                   "hybrid_params_from_jax",
                                   "hybrid_ServingEngine", "hybrid_serve",
                                   "hybrid_cli", "int8_cache_init",
                                   "int8_ServingEngine", "int8_cli",
                                   "train", "train_cli", "Pipeline",
                                   "adamw_state_from_jax"])
def test_default_device_entry_points_raise_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        _default_device_calls()[entry]()
