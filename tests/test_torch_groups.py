"""The port's engine at query-head groups above 8 against the JAX engine.

glm4-9b has 32 query heads over 2 kv heads (G 16) and starcoder2-15b 48
over 4 (G 12); their smoke configs keep G 2 and G 1, so here the smoke
configs get those head layouts back (head_dim 16). The paged decode splits
such a group over CTAs on the card (``kernels/decode_attention/ops.py``
``plan``); on the CPU the same wrappers run their plain versions. Smoke
weights carried over from the reference, a 2-port CXL tier, chunked
prefill over several pages, then resubmitted prompts restored from the
tier, with bf16 pages (a bf16 model) and with int8 pages (an f32 model,
as ``tests/test_torch_kv_quant.py``'s engine gates: in bf16 the two
engines' int8 prefills round apart and flip a near-tie): greedy tokens,
the stats (but wall time) and the tier's op trace must equal the JAX
engine's (``got == want``).
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.configs.base import MeshConfig, RunConfig, SHAPES
from repro.models import model as JM
from repro.serving.config import ServeConfig as JServeConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MeshConfig as TMeshConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.launch.serve import serve_waves
from repro_torch.serving.config import ServeConfig as TServeConfig

PAGE = 16
KNOBS = dict(n_slots=4, max_seq=64, prefill_chunk=8,
             tier_topology=("dram", "ssd-fast"))
# (arch, query heads, kv heads): the published configs' head layouts
GROUPS = {"glm4-9b": (32, 2), "starcoder2-15b": (48, 4)}


CASES = [(arch, kvq) for arch in GROUPS for kvq in ("none", "int8")]
IDS = [f"{arch}-{'bf16' if kvq == 'none' else kvq}" for arch, kvq in CASES]


def _waves():
    rng = np.random.default_rng(13)
    first = [(rid, rng.integers(1, 256, int(n)).tolist(), 6)
             for rid, n in enumerate(rng.integers(5, 40, 6))]
    again = [(100 + rid, prompt, 5) for rid, prompt, _ in first[:3]]
    return [first, again]


def _heads(cfg, arch, kv_quant):
    h, hkv = GROUPS[arch]
    dtype = "bfloat16" if kv_quant == "none" else "float32"
    return dataclasses.replace(cfg, n_heads=h, n_kv_heads=hkv, dtype=dtype)


def _jax_run(cfg, rc, params, kv_quant):
    eng = JEngine(params, cfg, rc,
                  config=JServeConfig(kv_quant=kv_quant, **KNOBS))
    for wave in _waves():
        for rid, prompt, n in wave:
            eng.submit(JRequest(rid=rid, prompt=list(prompt),
                                max_new_tokens=n))
        eng.run(max_ticks=600)
    return ({r.rid: [int(t) for t in r.generated] for r in eng.finished},
            eng.stats.as_dict(), eng.tier.ops, eng.tier.op_ns)


@pytest.fixture(scope="module")
def runs(host_mesh):
    """{(arch, kv_quant): (JAX run, the port's run)}."""
    out = {}
    for arch, kv_quant in CASES:
        cfg = _heads(jreg.smoke(arch), arch, kv_quant)
        rc = dataclasses.replace(RunConfig(model=cfg,
                                           shape=SHAPES["decode_32k"],
                                           mesh=MeshConfig()),
                                 kv_page_size=PAGE)
        with jax.set_mesh(host_mesh):
            params = JM.init_model(jax.random.PRNGKey(0), cfg)
        tcfg = _heads(treg.smoke(arch), arch, kv_quant)
        trc = dataclasses.replace(TRunConfig(model=tcfg,
                                             shape=TSHAPES["decode_32k"],
                                             mesh=TMeshConfig()),
                                  kv_page_size=PAGE)
        tparams = bridge.params_from_jax(
            jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
        with jax.set_mesh(host_mesh):
            want = _jax_run(cfg, rc, params, kv_quant)
        got = serve_waves(None, tparams, tcfg, trc,
                          TServeConfig(kv_quant=kv_quant, **KNOBS),
                          _waves(), "cpu")
        out[arch, kv_quant] = want, got
    return out


@pytest.mark.parametrize("arch,kv_quant", CASES, ids=IDS)
def test_group_engine_matches_reference(arch, kv_quant, runs):
    (tokens, stats, ops, op_ns), got = runs[arch, kv_quant]
    h, hkv = GROUPS[arch]
    assert h // hkv in (12, 16)
    assert got["tokens"] == tokens
    assert got["restored"] == [100, 101, 102]
    for run_stats in (stats, got["stats"]):
        run_stats.pop("prefill_time_s")
    assert got["stats"] == stats
    assert stats["prefix_hits"] == 3 and stats["restore_stall_ns"] > 0
    assert got["tier"]["ops"] == ops
    assert got["tier"]["op_ns"] == op_ns
