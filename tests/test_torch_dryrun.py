"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's and against real runs, on the CPU.

The reference compiles each cell on forced host devices and reads XLA's
``memory_analysis``; its cases run in one subprocess with eight forced
host devices (smoke qwen3-1.7b at (1, 1) and (2, 4), smoke
granite-moe-1b-a400m at (1, 2); train and prefill of 4 x 64 tokens,
decode against a cache of 1024, and the one-page cache of 64 tokens that
a model axis of 4 cannot split), beside each argument's and output's
per-device bytes from its shardings. The port counts one rank of the
same mesh on meta tensors. Held:

* the argument bytes leaf for leaf and in total
  (``argument_size_in_bytes``); the outputs and aliases leaf for leaf but
  the named differences: the prefill and decode logits (the reference
  replicates them to every device, a port rank keeps its rows), the
  AdamW step counter (the reference donates it, the port makes a new
  one), XLA's output tuple (8 bytes a leaf);
* the collectives, call for call in kind, axis and bytes, against a real
  spawned gloo run of the same steps through the same counting
  (``launch.mesh.RECORD``): train and decode at (2, 2) (dense) and (1,
  2) (MoE, expert-parallel), the MoE's prefill and decode at (2, 2)
  and its prefill at (2, 2, 2) with ``multi_pod`` (its tokens over
  (data, model), as the reference's forms take them);
* the HOST tier: its leaves' bytes move from the card's arguments to the
  host's;
* the flops: a one-rank step's count on meta equals ``FlopCounterMode``
  of the same step on the CPU; each kernel's ``cost`` a hand count at
  two shapes; the MoE's forms on meta the closed form of their experts
  at capacity;
* the reference's arithmetic: ``corrected`` equals ``module`` at short
  shapes, a fit's next point is exact (the hybrid's quadratic, xLSTM's
  affine law over whole 256-token chunks), ``_combine`` and
  ``_polyfit_cost`` equal the reference's, and ``model_flops``,
  ``n_stacked`` and the cell list with its skip reasons equal the
  reference's for every arch;
* each kernel wrapper's branches: cpu to its plain version, meta to its
  closed form, cuda only to its kernel, any other device refused.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import registry as treg
from repro_torch.configs.base import (MeshConfig, RunConfig, SHAPES,
                                      ShapeConfig, shape_applicable)
from repro_torch.kernels import meta as kmeta
from repro_torch.launch import dryrun
from repro_torch.launch import mesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as TM
from repro_torch.parallel import sharding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QWEN, GRANITE = "qwen3-1.7b", "granite-moe-1b-a400m"
ZAMBA, XLSTM = "zamba2-2.7b", "xlstm-125m"
# (name, arch, kind, tokens, global batch, mesh)
CASES = [(f"{tag}_{kind}", arch, kind, 1024 if kind == "decode" else 64, 4,
          shp)
         for tag, arch, shp in (("q11", QWEN, (1, 1)), ("q24", QWEN, (2, 4)),
                                ("g12", GRANITE, (1, 2)))
         for kind in ("train", "prefill", "decode")]
ONE_PAGE = ("q24_one_page", QWEN, "decode", 64, 4, (2, 4))
# XLA's output of more than one leaf is a tuple: a table of 8-byte
# buffer pointers beside the leaves
TUPLE_ENTRY = 8

_JAX = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    import repro  # installs the jax < 0.5 compat shims
    import jax, numpy as np
    from repro.configs import registry
    from repro.configs.base import (MeshConfig, RunConfig, SHAPES,
                                    ShapeConfig, shape_applicable)
    from repro.launch import steps
    from repro.launch.mesh import make_production_mesh
    from repro.models import model as M

    def path_name(path):
        out = []
        for k in path:
            for attr in ("key", "name", "idx"):
                if hasattr(k, attr):
                    out.append(str(getattr(k, attr)))
                    break
        return "/".join(out)

    def leaf_bytes(tree, shardings, prefix, into):
        leaves = jax.tree_util.tree_leaves_with_path(tree)
        shs = jax.tree_util.tree_leaves(shardings)
        assert len(leaves) == len(shs), prefix
        for (path, leaf), sh in zip(leaves, shs):
            n = (int(np.prod(sh.shard_shape(leaf.shape)))
                 * np.dtype(leaf.dtype).itemsize)
            key = prefix + path_name(path)
            into[key] = into.get(key, 0) + n

    cases, fit_in = json.loads(sys.stdin.read())
    out = {"cells": {}}
    for name, arch, kind, seq, batch, shp in cases:
        cfg = registry.smoke(arch)
        shape = ShapeConfig(kind, seq, batch, kind)
        rc = RunConfig(model=cfg, shape=shape, mesh=MeshConfig())
        mesh = make_production_mesh(shape=tuple(shp))
        try:
            cell = steps.assemble(cfg, shape, rc, mesh)
            with jax.set_mesh(mesh):
                compiled = cell.jitted.lower(*cell.args).compile()
                oshape = jax.eval_shape(cell.jitted, *cell.args)
        except Exception as e:
            out["cells"][name] = {"error": f"{type(e).__name__}: {e}"}
            continue
        mem = compiled.memory_analysis()
        args, outs = {}, {}
        pre = {"train": ("state/", "batch/"),
               "prefill": ("params/", "batch/"),
               "decode": ("params/", "cache/", "batch/tokens")}[kind]
        for a, sh, p in zip(cell.args, compiled.input_shardings[0], pre):
            leaf_bytes(a, sh, p, args)
        leaf_bytes(oshape, compiled.output_shardings, "out/", outs)
        out["cells"][name] = {"mem": {k: getattr(mem, k) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes")}, "args": args, "outs": outs}
    # the dry run's own arithmetic and per-arch figures, after the backend
    # is up (importing the dry run sets XLA_FLAGS for its 512 devices)
    from repro.launch import dryrun
    out["combine"] = dryrun._combine(*fit_in["combine"])
    out["polyfit"] = [dryrun._polyfit_cost(
        {int(s): v for s, v in pts.items()}, t) for pts, t in fit_in["fit"]]
    out["archs"] = {}
    for arch in sorted(registry.ARCHS):
        cfg = registry.get(arch)
        row = {"n_stacked": M.n_stacked(cfg),
               "depth": [dryrun.reduced_depth_cfg(cfg, k).n_layers
                         for k in (2, 3)], "shapes": {}}
        for s, shape in SHAPES.items():
            ok, why = shape_applicable(cfg, shape)
            tokens = shape.global_batch * (shape.seq_len
                                           if shape.kind != "decode" else 1)
            row["shapes"][s] = {"ok": ok, "reason": why, "model_flops":
                                (6 if shape.kind == "train" else 2)
                                * cfg.n_active_params() * tokens}
        out["archs"][arch] = row
    print("JAX_DRYRUN " + json.dumps(out))
""")

# the reference's _combine and _polyfit_cost on these inputs
_COLL = {"all-gather": 10.0, "all-reduce": 4.0, "count": 3.0}
FIT_IN = {
    "combine": [{"flops": 120.0, "bytes_accessed": 70.0,
                 "collective_bytes": _COLL},
                {"flops": 170.0, "bytes_accessed": 95.0,
                 "collective_bytes": {"all-gather": 14.0, "all-reduce": 4.0,
                                      "count": 5.0}}, 28],
    "fit": [[{"256": {"flops": 3.0e9, "bytes_accessed": 2.0e9,
                      "collective_bytes": _COLL},
              "512": {"flops": 5.5e9, "bytes_accessed": 3.5e9,
                      "collective_bytes": dict(_COLL, count=5.0)}}, 4096],
            [{"512": {"flops": 1.0e9, "bytes_accessed": 1.0e9,
                      "collective_bytes": _COLL},
              "1024": {"flops": 3.0e9, "bytes_accessed": 2.5e9,
                       "collective_bytes": _COLL},
              "2048": {"flops": 9.5e9, "bytes_accessed": 6.0e9,
                       "collective_bytes": dict(_COLL, count=7.0)}},
             32768]],
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This process's counts and one-rank steps on one intra-op thread,
    as the spawned ranks run: the smoke model's ops are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def ref_proc(tmp_path_factory):
    """The reference's cases, started in a subprocess with the first test
    of the file; the fixture ``ref`` waits for them (the tests that need
    it come last)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    log = tmp_path_factory.mktemp("dryrun_ref") / "jax.log"
    err = open(log, "w")
    proc = subprocess.Popen([sys.executable, "-c", _JAX],
                            stdin=subprocess.PIPE, stdout=err,
                            stderr=subprocess.STDOUT, text=True, env=env)
    proc.stdin.write(json.dumps([CASES + [ONE_PAGE], FIT_IN]))
    proc.stdin.close()
    yield proc, log
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    err.close()


@pytest.fixture(scope="module")
def ref(ref_proc):
    proc, log = ref_proc
    proc.wait(timeout=600)
    text = log.read_text()
    line = next((ln for ln in text.splitlines()
                 if ln.startswith("JAX_DRYRUN ")), None)
    assert line is not None, text[-3000:]
    return json.loads(line[len("JAX_DRYRUN "):])


def _case(name, arch, kind, seq, batch, shp, rank=0):
    """A smoke cell on rank ``rank`` of a dry-run mesh of ``shp`` (a
    (pod, data, model) shape is multi-pod)."""
    cfg = treg.smoke(arch)
    shape = ShapeConfig(kind, seq, batch, kind)
    rc = RunConfig(model=cfg, shape=shape,
                   mesh=MeshConfig(multi_pod=len(shp) == 3))
    return cfg, shape, rc, mesh.make_production_mesh(shape=shp, rank=rank)


def _nb(t):
    return t.numel() * t.element_size()


def _named_params(params, prefix, into, tensors=None):
    """Bytes by the reference's leaf path of each parameter (or of the
    aligned ``tensors``), summed over the port's layers."""
    for (name, p), t in zip(params.named_parameters(),
                            tensors or [None] * 10 ** 6):
        key = prefix + sharding.ref_path(name)[0]
        into[key] = into.get(key, 0) + _nb(p if t is None else t)


def _state_leaves(state, prefix, into):
    params = state.params
    _named_params(params, prefix + "params/", into)
    opt = state.opt
    into[prefix + "opt/step"] = _nb(opt.step)
    for name in ("m", "v", "master"):
        if getattr(opt, name) is not None:
            _named_params(params, f"{prefix}opt/{name}/", into,
                          getattr(opt, name))


def _cache_leaves(cache, prefix, into):
    for name, a in cache.items():
        if name == "kv":
            for n, t in a.items():
                into[f"{prefix}kv/{n}"] = _nb(t)
        else:
            into[prefix + name] = _nb(a)


def port_leaves(cell, out):
    """(argument bytes, output bytes) of a port cell by the reference's
    leaf names (the subprocess's ``leaf_bytes``)."""
    args, outs = {}, {}
    if cell.kind == "train":
        state, batch = cell.args
        _state_leaves(state, "state/", args)
        for k, t in batch.items():
            args["batch/" + k] = _nb(t)
        new_state, metrics = out
        _state_leaves(new_state, "out/0/", outs)
        for k, t in metrics.items():
            outs["out/1/" + k] = _nb(t)
        return args, outs
    params = cell.args[0]
    _named_params(params, "params/", args)
    if cell.kind == "prefill":
        for k, t in cell.args[1].items():
            args["batch/" + k] = _nb(t)
        outs["out/"] = _nb(out)
        return args, outs
    _cache_leaves(cell.args[1], "cache/", args)
    args["batch/tokens"] = _nb(cell.args[2])
    outs["out/0"] = _nb(out[0])
    _cache_leaves(out[1], "out/1/", outs)
    return args, outs


# ------------------------------------------------------- collectives

# (name, arch, mesh, kinds): the MoE at (2, 2) is the expert-parallel
# prefill and decode over (data, model), which the serving engine refuses
COLL_CASES = [("dense22", QWEN, (2, 2), ("train", "decode")),
              ("moe12", GRANITE, (1, 2), ("train", "decode")),
              ("moe22", GRANITE, (2, 2), ("prefill", "decode")),
              ("moe222", GRANITE, (2, 2, 2), ("prefill",))]
SEQ = {"train": 64, "prefill": 64, "decode": 1024}


def collective_rank(rank_mesh, arch, kinds):
    """One real rank (gloo, the CPU): the ``kinds`` steps of ``arch``'s
    smoke config on its shard, every collective recorded."""
    out = {}
    for kind in kinds:
        seq = SEQ[kind]
        cfg = treg.smoke(arch)
        shape = ShapeConfig(kind, seq, 4, kind)
        rc = RunConfig(model=cfg, shape=shape,
                       mesh=MeshConfig(multi_pod=rank_mesh.shape[0] > 1))
        cell = tsteps.assemble(cfg, shape, rc, rank_mesh, device="cpu")
        mesh.RECORD = []
        try:
            cell.step(*cell.args)
            out[kind] = mesh.RECORD
        finally:
            mesh.RECORD = None
    return out


@pytest.mark.parametrize("name,arch,shp,steps", COLL_CASES)
def test_collectives_equal_a_real_run(name, arch, shp, steps, tmp_path):
    """The dry run's collectives of every rank equal, call for call in
    kind, axis and payload bytes, what real gloo ranks of the same mesh
    record running the same steps."""
    size = int(np.prod(shp))
    real = mesh.spawn(collective_rank, size, (arch, steps),
                      rendezvous_dir=str(tmp_path), device="cpu",
                      timeout_s=300.0, mesh_shape=shp)
    kinds = set()
    for rank in range(size):
        for kind in steps:
            cfg, shape, rc, m = _case(name, arch, kind, SEQ[kind], 4, shp,
                                      rank)
            got = dryrun.count_step(tsteps.assemble(cfg, shape, rc, m))
            assert [tuple(r) for r in got["collectives"]] == \
                [tuple(r) for r in real[rank][kind]], (rank, kind)
            kinds |= {r[0] for r in got["collectives"]}
    assert "all-gather" in kinds and "all-reduce" in kinds
    if name.startswith("moe"):
        assert "all-to-all" in kinds          # the expert-parallel forms
    else:
        assert "reduce-scatter" in kinds      # the deterministic store


# ------------------------------------------------------------- flops

@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_meta_flops_equal_cpu_flops(kind):
    """One rank's smoke step: the count on meta equals FlopCounterMode
    of the same step run on the CPU."""
    cfg = treg.smoke(QWEN)
    shape = ShapeConfig(kind, 64, 2, kind)
    rc = RunConfig(model=cfg, shape=shape, mesh=MeshConfig())
    got = dryrun.count_step(tsteps.assemble(cfg, shape, rc, None))
    cell = tsteps.assemble(cfg, shape, rc, None, device="cpu")
    with FlopCounterMode(display=False) as fc:
        cell.step(*cell.args)
    assert got["module"]["flops"] == fc.get_total_flops() > 0
    assert got["kernels"] == {}


def test_kernel_costs_are_hand_counts():
    """Each wrapper's ``cost`` at two shapes, counted by hand."""
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as pre
    from repro_torch.kernels.hdm_stream import ops as mm
    from repro_torch.kernels.mamba2_scan import ops as ssd
    # decode: 8 slots, 16 heads over 8 kv heads, D 128, 2048 tokens each,
    # bf16: QK and PV 2 flops a multiply-add; K and V, q, out, lengths
    assert dec.cost(8, 16, 8, 128, 8 * 2048, kv_bytes=2, q_bytes=2) == (
        4 * 8 * 2048 * 16 * 128,
        2 * 8 * 2048 * 8 * 128 * 2 + 2 * 8 * 16 * 128 * 2 + 8 * 4)
    # the int8 mode, 3 slots of 100 tokens in pages of 64 (2 read each),
    # f32 output
    assert dec.cost(3, 4, 1, 64, 300, kv_bytes=1, q_bytes=2, out_bytes=4,
                    pages_read=6, int8=True) == (
        4 * 300 * 4 * 64,
        2 * 300 * 64 + 3 * 4 * 64 * 2 + 3 * 4 * 64 * 4 + 3 * 4
        + 2 * 6 * 4 + 2 * 3 * 64 * 2)
    # prefill: one 256-token chunk at 300 (556 keys), H 16, Hkv 8, D 128
    assert pre.cost(1, 256, 16, 8, 128, 256 * 300 + 256 * 257 // 2, 556,
                    2) == (4 * (256 * 300 + 32896) * 16 * 128,
                           2 * 556 * 8 * 128 * 2 + 2 * 256 * 16 * 128 * 2 + 4)
    assert pre.cost(2, 64, 4, 4, 64, 2 * 2080, 128, 4) == (
        4 * 4160 * 4 * 64, 2 * 128 * 4 * 64 * 4 + 2 * 2 * 64 * 4 * 64 * 4
        + 8)
    # ssd: B 1, S 256, H 80, P = N = 64, from a start state; then without
    assert ssd.cost(1, 256, 80, 64, 64) == (
        4 * 256 * 80 * 64 * 64,
        4 * (2 * 256 * 80 * 64 + 2 * 256 * 64 + 256 * 80 + 2 * 80 * 64 * 64))
    assert ssd.cost(2, 10, 3, 4, 5, h0=False) == (
        4 * 2 * 10 * 3 * 4 * 5,
        4 * (2 * 2 * 10 * 3 * 4 + 2 * 2 * 10 * 5 + 2 * 10 * 3 + 2 * 3 * 4 * 5))
    # paged_matmul: [8, 2048] x [2048, 6144] in bf16 over 32 pages; f32
    assert mm.cost(8, 2048, 6144, 32, 2) == (
        2 * 8 * 2048 * 6144, 2 * (8 * 2048 + 2048 * 6144 + 8 * 6144) + 128)
    assert mm.cost(256, 64, 32, 2, 4) == (
        2 * 256 * 64 * 32, 4 * (256 * 64 + 64 * 32 + 256 * 32) + 8)


class _Charges:
    def __init__(self):
        self.rows = []

    def kernel(self, *row):
        self.rows.append(row)


def test_meta_branches_charge_their_cost():
    """On meta each wrapper returns its outputs' shapes and charges its
    ``cost`` once to the open count, the whole cache for the decode."""
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as pre
    from repro_torch.kernels.hdm_stream import ops as mm
    from repro_torch.kernels.mamba2_scan import ops as ssd
    m = dict(device="meta")
    bf = dict(m, dtype=torch.bfloat16)
    f32 = dict(m, dtype=torch.float32)
    i32 = dict(m, dtype=torch.int32)
    c = _Charges()
    kmeta.COUNTS.append(c)
    try:
        q, kp = torch.empty(2, 1, 8, 64, **bf), torch.empty(2, 4, 16, 2, 64,
                                                            **bf)
        o = dec.paged_decode(q, kp, kp, torch.empty(2, **i32))
        o8 = dec.paged_decode(
            q, torch.empty(2, 4, 16, 2, 64, device="meta", dtype=torch.int8),
            torch.empty(2, 4, 16, 2, 64, device="meta", dtype=torch.int8),
            k_scale=torch.empty(2, 4, 2, **f32),
            v_scale=torch.empty(2, 4, 2, **f32),
            new_k=torch.empty(2, 1, 2, 64, **bf),
            new_v=torch.empty(2, 1, 2, 64, **bf), pos=torch.empty(2, **i32),
            return_ml=True)
        qp, kc = torch.empty(1, 32, 8, 64, **bf), torch.empty(1, 128, 2, 64,
                                                              **bf)
        op = pre.flash_prefill(qp, kc, kc, torch.empty(1, **i32))
        y, h = ssd.ssd(torch.empty(1, 40, 3, 16, **f32),
                       torch.empty(1, 40, 8, **f32),
                       torch.empty(1, 40, 8, **f32),
                       torch.empty(1, 40, 3, **f32))
        ym = mm.stream_matmul(torch.empty(5, 64, **bf),
                              torch.empty(4, 32, 48, **bf),
                              torch.empty(2, **i32))
    finally:
        kmeta.COUNTS.remove(c)
    assert o.shape == q.shape and o.device.type == "meta"
    assert [t.shape for t in o8] == [q.shape, (2, 8), (2, 8)]
    assert op.shape == qp.shape and ym.shape == (5, 48)
    assert y.shape == (1, 40, 3, 16) and h.shape == (1, 3, 16, 8)
    assert c.rows == [
        ("paged_decode", *dec.cost(2, 8, 2, 64, 128, kv_bytes=2,
                                   q_bytes=2)),
        ("paged_decode_int8", *dec.cost(2, 8, 2, 64, 128, kv_bytes=1,
                                        q_bytes=2, out_bytes=4,
                                        pages_read=8, int8=True)),
        ("flash_prefill", *pre.cost(1, 32, 8, 2, 64, 32 * 33 // 2, 32, 2)),
        ("ssd_scan", *ssd.cost(1, 40, 3, 16, 8, h0=False)),
        ("paged_matmul", *mm.cost(5, 64, 48, 2, 2))]


def test_moe_on_meta_is_its_experts_at_capacity():
    """The MoE forms run every expert at its capacity, static shapes, on
    meta too: the count is the router's product and the experts' three
    products at capacity, whatever the routing would have kept."""
    from repro_torch.models import moe as tmoe
    cfg = treg.smoke(GRANITE)
    d, ff, e, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k
    layer = TM.init_model(cfg, device="meta").blocks[0].moe
    for t in (8, 37):
        x = torch.empty(1, t, d, device="meta", dtype=torch.bfloat16)
        cap = min(tmoe._capacity(cfg.capacity_factor, t, k, e), t)
        with FlopCounterMode(display=False) as fc:
            tmoe.moe_apply(layer, cfg, x)
        assert fc.get_total_flops() == 2 * t * d * e + 3 * 2 * e * cap * d * ff
    # the expert-parallel decode on a model axis of 2: a rank's experts at
    # t k rows each (nothing drops), over a dry-run group
    grp = mesh.make_production_mesh(shape=(1, 2)).model
    x = torch.empty(4, 1, d, device="meta", dtype=torch.bfloat16)
    with FlopCounterMode(display=False) as fc:
        y = tmoe.moe_apply_ep_decode(layer, cfg, x, group=grp)
    assert y.shape == x.shape
    assert fc.get_total_flops() == 2 * 4 * d * e + 3 * 2 * (e // 2) * (
        4 * k) * d * ff


# ---------------------------------------------- the reference's arithmetic

@pytest.mark.parametrize("arch,kind,shp", [(QWEN, "train", (2, 2)),
                                           (QWEN, "decode", (1, 2)),
                                           (GRANITE, "train", (1, 2)),
                                           (ZAMBA, "prefill", (1, 2))])
def test_corrected_equals_module(arch, kind, shp):
    """Eager mode counts every layer: the reference's depth-2 / depth-3
    combination gives back the whole-depth count exactly."""
    cfg, shape, rc, m = _case("", arch, kind, 1024 if kind == "decode"
                              else 64, 4, shp)
    module = dryrun._extract(dryrun.count_step(
        tsteps.assemble(cfg, shape, rc, m)))
    assert dryrun.corrected_cost(cfg, shape, rc, m)["corrected"] == module


@pytest.mark.parametrize("arch,seqs", [(ZAMBA, (32, 64, 96, 128)),
                                       (XLSTM, (256, 512, 768))])
def test_fit_predicts_its_next_point(arch, seqs):
    """The hybrid's quadratic law through three lengths and xLSTM's
    affine law through two (whole 256-token chunks of its mLSTM) give
    the count at the next length exactly (prefill, one row; xLSTM at one
    group, its sLSTM a step a token)."""
    cfg = treg.smoke(arch)
    if arch == XLSTM:
        cfg = dryrun.reduced_depth_cfg(cfg, 1)
    pts = {}
    for s in seqs:
        shape = ShapeConfig("prefill", s, 1, "prefill")
        rc = RunConfig(model=cfg, shape=shape, mesh=MeshConfig())
        pts[s] = dryrun._extract(dryrun.count_step(
            tsteps.assemble(cfg, shape, rc, None)))
    fit = dryrun._polyfit_cost({s: pts[s] for s in seqs[:-1]}, seqs[-1])
    assert fit == pts[seqs[-1]]
    assert dryrun.fit_seqs(treg.get(arch), SHAPES["train_4k"]) is not None


def test_cli_writes_every_cell(tmp_path):
    """``main`` over both meshes: a cell per mesh, ok or skipped, none
    failed; the production mesh's size and a rank's argument bytes."""
    assert dryrun.main(["--arch", XLSTM, "--shape", "decode_32k",
                        "--both-meshes", "--out", str(tmp_path)]) == 0
    assert dryrun.main(["--arch", QWEN, "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    cells = {p.name: json.loads(p.read_text())
             for p in tmp_path.glob("*.json")}
    assert sorted(cells) == [f"{QWEN}__long_500k__sp.json",
                             f"{XLSTM}__decode_32k__mp.json",
                             f"{XLSTM}__decode_32k__sp.json"]
    assert cells[f"{QWEN}__long_500k__sp.json"]["status"] == "skipped"
    sp, mp = (cells[f"{XLSTM}__decode_32k__{t}.json"] for t in ("sp", "mp"))
    assert (sp["status"], mp["status"]) == ("ok", "ok")
    assert (sp["n_devices"], mp["n_devices"]) == (256, 512)
    for c in (sp, mp):
        mem = c["memory_analysis"]
        assert mem["argument_size_in_bytes"] > 0
        assert c["module"]["flops"] > 0 and c["kernels"] == {}
    # the multi-pod mesh splits the 128 rows over 32 (pod, data) ranks
    assert mp["memory_analysis"]["argument_size_in_bytes"] < \
        sp["memory_analysis"]["argument_size_in_bytes"]


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_host_tier_leaves_count_as_host_bytes(kind):
    """With the weights (and the optimizer state) on the HOST tier the
    same bytes move from the card's arguments to the host's: the card
    keeps the rows, the cache and the AdamW step counter."""
    seq = 1024 if kind == "decode" else 64
    over = dict(param_tier="host", optimizer_tier="host",
                enable_host_tier=True)
    cells = {}
    for name, rc_over in (("pool", {}), ("host", over)):
        cfg, shape, rc, m = _case(name, QWEN, kind, seq, 4, (2, 2))
        rc = dataclasses.replace(rc, **rc_over)
        cells[name] = dryrun.count_step(tsteps.assemble(
            cfg, shape, rc, m))["memory_analysis"]
    pool, host = cells["pool"], cells["host"]
    assert pool["host_argument_size_in_bytes"] == 0
    assert host["host_argument_size_in_bytes"] > 0
    assert (host["argument_size_in_bytes"]
            + host["host_argument_size_in_bytes"]
            == pool["argument_size_in_bytes"])
    if kind == "train":      # the rows of tokens and labels, the counter
        assert host["argument_size_in_bytes"] == 2 * 2 * 64 * 4 + 4


def test_production_mesh_groups():
    """``make_production_mesh``'s groups are ``init_mesh``'s (the same
    members, ranks and axes) and run no collective: each returns a meta
    tensor of the real result's shape and is recorded with its bytes."""
    m = mesh.make_production_mesh(multi_pod=True, rank=300)
    assert m.shape == (2, 16, 16) and m.coords == mesh.coords(300, m.shape)
    assert (m.model.size, m.data.size, m.pod.size, m.pod_data.size,
            m.plane.size, m.world.size) == (16, 16, 2, 32, 256, 512)
    assert m.model.members == tuple(range(288, 304))
    assert m.data.members == tuple(256 + 16 * d + 12 for d in range(16))
    assert m.model.rank == 12 and m.data.rank == 2 and m.pod.rank == 1
    assert isinstance(m.model, mesh.DryRunGroup) and \
        m.device == torch.device("meta")
    t = torch.empty(4, 6, device="meta", dtype=torch.bfloat16)
    mesh.RECORD, saved = [], mesh.RECORD
    try:
        shapes = [m.model.all_reduce(t, "sum").shape,
                  m.model.all_gather(t).shape, m.data.all_to_all(
                      torch.empty(16, 3, device="meta")).shape,
                  m.pod.reduce_scatter(t, dim=0).shape,
                  m.model.sum_ranked(t).dtype, m.data.broadcast(t, 0).shape]
        rec = mesh.RECORD
    finally:
        mesh.RECORD = saved
    assert shapes == [(4, 6), (16, 4, 6), (16, 3), (2, 6), torch.float32,
                      (4, 6)]
    assert rec == [("all-reduce", "model", 48),
                   ("all-gather", "model", 16 * 48),
                   ("all-to-all", "data", 16 * 3 * 4),
                   ("reduce-scatter", "pod", 24),
                   ("all-gather", "model", 16 * 96),
                   ("broadcast", "data", 48)]


# ------------------------------------------------ the wrappers' branches

def _wrapper_calls():
    """Each wrapper's call on inputs of ``device`` (``make(shape, dtype)``
    makes one), the plain version's module attribute, and the C entry."""
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as pre
    from repro_torch.kernels.hdm_stream import ops as mm
    from repro_torch.kernels.mamba2_scan import ops as ssd
    bf, f32, i32, i8 = (torch.bfloat16, torch.float32, torch.int32,
                        torch.int8)

    def decode(make):
        return dec.paged_decode(make((2, 1, 8, 64), bf),
                                make((2, 4, 16, 2, 64), bf),
                                make((2, 4, 16, 2, 64), bf),
                                make((2,), i32))

    def decode8(make):
        return dec.paged_decode(
            make((2, 1, 8, 64), bf), make((2, 4, 16, 2, 64), i8),
            make((2, 4, 16, 2, 64), i8), k_scale=make((2, 4, 2), f32),
            v_scale=make((2, 4, 2), f32), new_k=make((2, 1, 2, 64), bf),
            new_v=make((2, 1, 2, 64), bf), kv_len=make((2,), i32),
            fresh=make((2,), i32))

    def prefill(make):
        return pre.flash_prefill(make((1, 32, 8, 64), bf),
                                 make((1, 128, 2, 64), bf),
                                 make((1, 128, 2, 64), bf), make((1,), i32))

    def scan(make):
        return ssd.ssd(make((1, 40, 3, 64), f32), make((1, 40, 64), f32),
                       make((1, 40, 64), f32), make((1, 40, 3), f32))

    def matmul(make):
        return mm.stream_matmul(make((5, 128), bf), make((4, 64, 48), bf),
                                make((2,), i32))

    return [(decode, dec, "paged_decode_ref", "repro_paged_decode"),
            (decode8, dec, "paged_decode_int8_ref",
             "repro_paged_decode_int8"),
            (prefill, pre, "flash_prefill_ref", "repro_flash_prefill"),
            (scan, ssd, "ssd_chunked_ref", "repro_ssd_scan"),
            (matmul, mm, "paged_matmul_ref", "repro_paged_matmul")]


class _FakeLibrary:
    """The kernels' C entries, recording their calls and returning 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            return 0
        return entry


@pytest.mark.filterwarnings("ignore:Accessing the data pointer of FakeTensor")
@pytest.mark.parametrize("i", range(5))
def test_wrapper_branches(i, monkeypatch):
    """cpu runs the plain version and launches nothing; meta charges the
    closed form and neither runs the plain version nor launches; a cuda
    tensor (a fake one, on this CPU) reaches only the C entry -- the
    plain version and the closed form are not called; any other device
    is refused. No meta branch is a way round the kernel on the card."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import build
    call, ops, ref_name, entry = _wrapper_calls()[i]
    plain = []
    real_ref = getattr(ops, ref_name)

    def counted(*a, **kw):
        plain.append(ref_name)
        return real_ref(*a, **kw)
    monkeypatch.setattr(ops, ref_name, counted)
    lib = _FakeLibrary()
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda device: 0)
    charges = _Charges()
    monkeypatch.setattr(kmeta, "COUNTS", [charges])

    gen = torch.Generator().manual_seed(0)

    def cpu(shape, dtype):
        if dtype.is_floating_point:
            return torch.randn(shape, generator=gen).to(dtype)
        if dtype == torch.int8:
            return torch.randint(-127, 128, shape, generator=gen,
                                 dtype=dtype)
        return torch.full(shape, 1, dtype=dtype)
    call(cpu)
    assert (plain, lib.calls, charges.rows) == ([ref_name], [], [])

    del plain[:]
    call(lambda shape, dtype: torch.empty(shape, dtype=dtype,
                                          device="meta"))
    assert (plain, lib.calls, len(charges.rows)) == ([], [], 1)

    launches = {k: v for k, v in vars(ops).items()
                if k.endswith("launches")}
    for k, v in launches.items():
        monkeypatch.setattr(ops, k, v if isinstance(v, int) else dict(v))
    with FakeTensorMode(allow_non_fake_inputs=True):
        call(lambda shape, dtype: torch.empty(shape, dtype=dtype,
                                              device="cuda"))
        assert (plain, lib.calls, len(charges.rows)) == ([], [entry], 1)
        with pytest.raises(ValueError, match="unsupported device"):
            call(lambda shape, dtype: torch.empty(shape, dtype=dtype,
                                                  device="xpu"))
    assert lib.calls == [entry] and plain == []


# ------------------------------------- against the reference's analyses

@pytest.fixture(scope="module")
def port_cells(ref_proc):
    """Each case's port cell on meta: its per-leaf bytes and the dry
    run's count of it."""
    out = {}
    for c in CASES:
        cfg, shape, rc, m = _case(*c)
        cell = tsteps.assemble(cfg, shape, rc, m)
        got = dryrun.count_step(cell)
        args, outs = port_leaves(cell, got["outputs"])
        out[c[0]] = {"count": got, "args": args, "outs": outs}
    return out


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_argument_bytes_equal_reference(port_cells, ref, name):
    """A rank's state, rows and cache: leaf for leaf and in total the
    reference's per-device argument bytes."""
    want, got = ref["cells"][name], port_cells[name]
    assert got["args"] == want["args"]
    mem = got["count"]["memory_analysis"]
    assert mem["argument_size_in_bytes"] == sum(got["args"].values())
    assert mem["argument_size_in_bytes"] == \
        want["mem"]["argument_size_in_bytes"]
    assert mem["host_argument_size_in_bytes"] == 0
    assert mem["generated_code_size_in_bytes"] is None


# (case kind, data ranks) -> the output leaves that differ by design
def _differences(kind, data_ranks):
    if kind == "train":
        return {}
    key = "out/" if kind == "prefill" else "out/0"
    return {key: lambda want: want // data_ranks}     # the rank's rows


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_output_and_alias_bytes(ref, port_cells, name):
    """The outputs leaf for leaf, but the logits: the reference's
    replicated whole on every device, a port rank's rows only. The
    aliases are the donated train state (less the AdamW step counter,
    which the port replaces) or the decode cache; XLA's output total
    adds its tuple table."""
    c = next(c for c in CASES if c[0] == name)
    kind, data_ranks = c[2], c[5][0]
    want, got = ref["cells"][name], port_cells[name]
    diff = _differences(kind, data_ranks)
    assert set(got["outs"]) == set(want["outs"])
    for leaf, n in want["outs"].items():
        expect = diff[leaf](n) if leaf in diff else n
        assert got["outs"][leaf] == expect, leaf
    mem = got["count"]["memory_analysis"]
    assert mem["output_size_in_bytes"] == sum(got["outs"].values())
    n_leaves = len(want["outs"])
    table = TUPLE_ENTRY * n_leaves if n_leaves > 1 else 0
    assert want["mem"]["output_size_in_bytes"] == \
        sum(want["outs"].values()) + table
    step = got["args"].get("state/opt/step", 0)
    assert mem["alias_size_in_bytes"] == \
        want["mem"]["alias_size_in_bytes"] - step
    if kind == "train":
        assert step == 4 and mem["alias_size_in_bytes"] == sum(
            n for leaf, n in got["args"].items()
            if leaf.startswith("state/") and leaf != "state/opt/step")
    elif kind == "decode":
        assert mem["alias_size_in_bytes"] == sum(
            n for leaf, n in got["args"].items() if leaf.startswith("cache/"))
    else:
        assert mem["alias_size_in_bytes"] == 0


def test_one_page_cache_is_refused_alike(ref):
    """A 64-token cache is one page, which a model axis of 4 cannot
    split: both refuse the cell."""
    err = ref["cells"][ONE_PAGE[0]].get("error", "")
    assert "divisible by 4" in err
    cfg, shape, rc, m = _case(*ONE_PAGE)
    with pytest.raises(ValueError, match="page axis divisible"):
        tsteps.assemble(cfg, shape, rc, m)


def test_combine_and_polyfit_equal_reference(ref):
    assert dryrun._combine(*FIT_IN["combine"]) == ref["combine"]
    for (pts, target), want in zip(FIT_IN["fit"], ref["polyfit"]):
        got = dryrun._polyfit_cost({int(s): v for s, v in pts.items()},
                                   target)
        coll = got.pop("collective_bytes")
        assert coll == pytest.approx(want.pop("collective_bytes"),
                                     rel=1e-12)
        assert got == pytest.approx(want, rel=1e-12)


def test_cells_and_model_flops_equal_reference(ref):
    """For every arch: ``n_stacked``, the reduced depths, and for every
    shape whether the cell runs (else the reference's skip reason) and
    its ``model_flops``."""
    assert sorted(treg.ARCHS) == sorted(ref["archs"])
    for arch, want in ref["archs"].items():
        cfg = treg.get(arch)
        assert TM.n_stacked(cfg) == want["n_stacked"]
        assert [dryrun.reduced_depth_cfg(cfg, k).n_layers
                for k in (2, 3)] == want["depth"]
        for s, w in want["shapes"].items():
            ok, why = shape_applicable(cfg, SHAPES[s])
            assert (ok, why) == (w["ok"], w["reason"])
            assert dryrun.model_flops(cfg, SHAPES[s]) == w["model_flops"]
            if not ok:
                res = dryrun.run_cell(arch, s, multi_pod=False,
                                      verbose=False)
                assert res == {"arch": arch, "shape": s,
                               "status": "skipped", "reason": w["reason"]}
