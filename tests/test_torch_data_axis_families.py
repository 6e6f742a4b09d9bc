"""The audio, hybrid, VLM, xLSTM and MoE families served by the port over
the data axis against the reference's sharded engine on the same mesh, on
the CPU.

Smoke musicgen-large, zamba2-2.7b, llama-3.2-vision-11b and xlstm-125m
at mesh (2, 2) on four spawned gloo ranks, and granite-moe-1b-a400m at
(2, 1) on two (its decode routes the whole batch, gathered over the data
axis, as the reference's ``moe_apply`` routes it), each rank on its POOL
shard of the reference's bf16 weights, every layer gathered over the data
axis by the speculative read; the reference's ``ServingEngine`` on the
same meshes in one subprocess with four forced host devices
(``tests/test_torch_data_axis.py``'s runner). Held against it: greedy
tokens (musicgen's against its own (2, 2) run: its (1, 2) tokens part
from them at near ties), every stat but wall time, the tier traces and
snapshot, and every greedy step's logits row within bf16's 2e-2; every
rank alike. The VLM's split cross layer also runs through direct prefill
chunks and ticks with vision K/V written and its cross gates away from 0,
two rows split over the data axis, against the reference's steps under a
(2, 2) mesh (f32 3e-5, bf16 2e-2). granite at (2, 2) raises in the port
as the reference's ``moe_apply_ep`` does there.
"""
import dataclasses
import os

import numpy as np
import pytest

from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
from repro_torch.launch import mesh
from repro_torch.models import model as TM
from repro_torch.serving.config import ServeConfig
from test_torch_data_axis import (BF16_TOL, PAGE, _active, _as_json,
                                  _stats, merged_steps, run_reference,
                                  serve_case)
from test_torch_sharded_families import (B, CHUNK, GATES, PROMPT, TICKS,
                                         _direct_tokens, _jax_params,
                                         _vision, _waves)

MUSICGEN, ZAMBA, VLM, XLSTM, GRANITE = (
    "musicgen-large", "zamba2-2.7b", "llama-3.2-vision-11b", "xlstm-125m",
    "granite-moe-1b-a400m")
# arch: mesh shape
MESHES = {MUSICGEN: (2, 2), ZAMBA: (2, 2), VLM: (2, 2), XLSTM: (2, 2),
          GRANITE: (2, 1)}
KNOBS = dict(n_slots=4, max_seq=64, prefill_chunk=8,
             tier_topology=("dram", "ssd-fast"))
SPAWN_TIMEOUT_S = 300.0
F32_TOL = dict(atol=3e-5, rtol=3e-5)
DTYPES = ("float32", "bfloat16")


def _config(arch):
    return ServeConfig(mesh_shape=MESHES[arch], **KNOBS)


def _direct(rank_mesh, dtype, np_params, vision, toks, ticks):
    """The VLM's prefill chunks and ticks on this rank of (2, 2): its
    POOL shard of the gated weights, its data row of the two rows and
    its model rank's pages, the vision K/V written: its row's logits of
    every step."""
    import torch
    from repro_torch.parallel import sharding
    cfg = dataclasses.replace(treg.smoke(VLM), dtype=dtype)
    rc = RunConfig(model=cfg, shape=SHAPES["decode_32k"], mesh=MeshConfig(),
                   kv_page_size=PAGE)
    params = bridge.params_from_jax(np_params, cfg, device="cpu",
                                    rank=rank_mesh.rank, mesh_shape=(2, 2))
    _, d, m = rank_mesh.coords
    cache = TM.cache_init(cfg, rc, B, KNOBS["max_seq"], device="cpu")
    for name in ("k", "v"):
        cache["cross_" + name].copy_(torch.from_numpy(vision[name]))
    cache = sharding.shard_cache(cache, m, 2, rows=(d, 2))
    ranks = TM.Ranks(model=rank_mesh.model, pages=rank_mesh.model,
                     fsdp=rank_mesh.data, batch=rank_mesh.data)
    toks = torch.tensor(toks, dtype=torch.int32)[d:d + 1]
    out = []
    for s in range(0, PROMPT, CHUNK):
        lg, _ = TM.prefill_step_cached(params, cfg, rc, toks[:, s:s + CHUNK],
                                       cache, ranks=ranks)
        out.append(bridge.to_numpy(lg))
    if d == 1:
        cache["pos"][0] += 5
    for nt in ticks:
        lg, _ = TM.decode_step(params, cfg, rc,
                               torch.tensor(nt, dtype=torch.int32)[d:d + 1],
                               cache, ranks=ranks)
        out.append(bridge.to_numpy(lg))
    return out


def _rank(group, served, direct):
    """One rank of the world: each family whose mesh has this world's
    size, then (four ranks) the VLM's direct steps."""
    out = {}
    for arch, np_params in served.items():
        if int(np.prod(MESHES[arch])) == group.size:
            out[arch] = serve_case(group.rank, arch, np_params,
                                   _config(arch), _waves(arch))
    if group.size == 4:
        rank_mesh = mesh.init_mesh(group.rank, (2, 2), device="cpu")
        for dtype, args in direct.items():
            out["direct_" + dtype] = _direct(rank_mesh, dtype, *args)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs (a subprocess) and the port's: the (2, 2)
    families and the VLM's direct steps in one spawn of four ranks,
    granite in one of two."""
    out_dir = str(tmp_path_factory.mktemp("data_axis_families"))
    prompt, ticks = _direct_tokens(treg.smoke(VLM).vocab_size)
    direct = {}
    for dtype in DTYPES:
        vision = _vision(dtype)
        np.savez(os.path.join(out_dir, f"vision_{dtype}.npz"), **vision)
        direct[dtype] = (_jax_params(VLM, dtype, gates=True), vision, prompt,
                         ticks)
    knobs = dict(KNOBS, tier_topology=list(KNOBS["tier_topology"]))
    jobs = [(arch, arch, "bfloat16", dict(knobs, mesh_shape=list(shape)),
             False, _waves(arch))
            for arch, shape in MESHES.items()]
    setup = [VLM, [2, 2], GATES, B, KNOBS["max_seq"], CHUNK, prompt, ticks]
    result = run_reference(jobs, [], out_dir,
                           {"setup": setup, "dtypes": list(DTYPES)})
    served = {arch: _jax_params(arch) for arch in MESHES}
    ranks = {size: mesh.spawn(
        _rank, size, (served, direct),
        rendezvous_dir=str(tmp_path_factory.mktemp("rdv")), device="cpu",
        timeout_s=SPAWN_TIMEOUT_S) for size in (4, 2)}
    return ranks, result()


def _arch_runs(runs, arch):
    ranks, want = runs
    return [r[arch] for r in ranks[int(np.prod(MESHES[arch]))]], want[arch]


@pytest.mark.parametrize("arch", list(MESHES))
def test_engine_matches_jax_on_the_mesh(runs, arch):
    """Every rank against the reference's engine on the same mesh:
    tokens, every stat but wall time, the tier's traces and snapshot, the
    restored rids; every rank alike."""
    port, ref = _arch_runs(runs, arch)
    for run in port:
        assert _as_json(run["tokens"]) == ref["tokens"]
        assert _as_json(_stats(run["stats"])) == _stats(ref["stats"])
        assert _as_json(run["tier"]) == ref["tier"]
        assert run["restored"] == ref["restored"]
        assert run["param_bytes"] == run["resident"]
    if arch == MUSICGEN:
        assert ref["restored"] == [100, 101]


@pytest.mark.parametrize("arch", list(MESHES))
def test_engine_logits_match_jax_on_the_mesh(runs, arch):
    """Every greedy step's logits row of every served request within
    bf16's 2e-2 of the reference's on the same mesh, in dispatch order."""
    port, ref = _arch_runs(runs, arch)
    steps = merged_steps(port, MESHES[arch], KNOBS["n_slots"])
    assert len(steps) == len(ref["rows"])
    got = _active(steps)
    want = _active([(r, who) for r, (_, who) in zip(ref["rows"], steps)])
    assert len(got) == sum(len(t) - (rid in port[0]["restored"])
                           for rid, t in port[0]["tokens"].items())
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **BF16_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_vlm_direct_steps_match_jax_on_the_mesh(runs, dtype):
    """With vision K/V from random embeddings and both cross gates away
    from 0, the port's prefill chunks and decode ticks at (2, 2) -- each
    data row one of the two rows -- against the reference's steps under a
    (2, 2) mesh."""
    ranks, want = runs
    ref = want[f"direct_{dtype}"]["rows"]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for m in range(2):
        rows = [ranks[4][d * 2 + m][f"direct_{dtype}"] for d in range(2)]
        assert len(rows[0]) == len(ref) == PROMPT // CHUNK + TICKS
        for i, b in enumerate(ref):
            a = np.concatenate([r[i] for r in rows])
            np.testing.assert_allclose(a, b, **tol)


def test_moe_on_data_and_model_axes_raises():
    """granite at (2, 2): the reference's ``moe_apply_ep`` cannot split
    the one-slot prefill batch over the data axis; the port refuses the
    mesh with a ``NotImplementedError`` that names that limit."""
    from repro_torch.serving.engine import ServingEngine
    cfg = treg.smoke(GRANITE)
    rc = RunConfig(model=cfg, shape=SHAPES["decode_32k"], mesh=MeshConfig(),
                   kv_page_size=PAGE)
    params = TM.init_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="moe_apply_ep"):
        ServingEngine(params, cfg, rc, device="cpu",
                      config=ServeConfig(mesh_shape=(2, 2), **KNOBS))
    with pytest.raises(NotImplementedError, match="moe_apply_ep"):
        ServingEngine(params, cfg, dataclasses.replace(
            rc, mesh=MeshConfig(multi_pod=True)), device="cpu",
            config=ServeConfig(mesh_shape=(2, 1, 2), **KNOBS))
