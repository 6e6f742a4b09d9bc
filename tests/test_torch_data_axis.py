"""Serving over the data and pod mesh axes (the dense family) against the
reference's sharded engine, on the CPU.

The reference's ``ServingEngine(mesh_shape=(D, N))`` places the weights
on the POOL tier (FSDP-sharded over the data axis), splits the slots over
the batch axes and the pages over the model axis (over both at one slot),
and streams each step's layers through the speculative read, which
gathers layer i + 1 while layer i computes. The port runs it as D N (or
P D N) rank processes (``launch.mesh.spawn``: gloo, a ``file://``
rendezvous under the test's temporary directory, a timeout on every
spawn), each on its shard of the reference's weights
(``bridge.params_from_jax(rank=, mesh_shape=)``). The reference runs
every case in one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (its greedy
steps' logits captured with ``jax.debug.callback`` on
``M.sample_tokens``), on the same weights (``PRNGKey(0)``; bf16 leaves
cross to the ranks as 2-byte voids) and traffic: six prompts, then three
of them again under new rids, in reverse order, so that restores land on
another row of slots than the one that retired them.

Cases (smoke qwen3-1.7b, bf16 weights): (2, 2) with bf16 and int8 pages,
(2, 1), (4, 1), (2, 1, 2) (no ``multi_pod``: the pod ranks are replicas)
(2, 1, 2) with ``multi_pod`` (FSDP and slots over pod and data) and
(2, 2) with one slot (the pages over all four ranks). Held: tokens,
every stat but wall time, every rank's tier trace and snapshot equal to
the reference's; every rank alike; the logits row of every greedy step
within bf16's 2e-2 of the reference's; each rank's parameter bytes its
share by the specs over both axes; the reference's SR depth; a restore
across rows where the slots are split. Unit checks: ``gather_fsdp`` of
a shard is the model-axis shard (the whole model at one model rank) bit
for bit, for every ported family; ``param_specs`` with
``multi_pod_fsdp`` equals the reference's for every arch;
``stream_layers(mode="infer")`` at depth 0, 1 and 2 (and granularity 2)
gives the one-rank decode's logits bit for bit on two gloo ranks, with
its gathers counted; the port's rank numbering is ``jax.make_mesh``'s
device order.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.models import model as JM
from repro.parallel import sharding as jsh
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
from repro_torch.launch import mesh
from repro_torch.launch.serve import serve_waves
from repro_torch.parallel import sharding as tsh
from repro_torch.serving.config import ServeConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3-1.7b"
PAGE = 16                      # 4 pages a slot
KNOBS = dict(n_slots=4, max_seq=64, prefill_chunk=8,
             tier_topology=("dram", "ssd-fast"))
# name: (mesh_shape, knobs over KNOBS, rc.mesh.multi_pod)
CASES = {"bf16-2x2": ((2, 2), {}, False),
         "int8-2x2": ((2, 2), {"kv_quant": "int8"}, False),
         "2x1": ((2, 1), {}, False),
         "4x1": ((4, 1), {}, False),
         "2x1x2": ((2, 1, 2), {}, False),
         "2x1x2-multipod": ((2, 1, 2), {}, True),
         "slot1-2x2": ((2, 2), {"n_slots": 1}, False)}
SPAWN_TIMEOUT_S = 300.0
WALL_STATS = ("prefill_time_s",)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
FAMILIES = ("qwen3-1.7b", "granite-moe-1b-a400m", "musicgen-large",
            "zamba2-2.7b", "llama-3.2-vision-11b", "xlstm-125m")
ORDERS = ((2, 2), (4, 1), (2, 1, 2), (1, 4), (2, 1))


def _waves():
    """Six prompts over several prefill chunks and pages, then three of
    them again under new rids, last first: restores into other slots."""
    rng = np.random.default_rng(11)
    first = [(rid, rng.integers(1, 256, int(n)).tolist(), 6)
             for rid, n in enumerate(rng.integers(5, 40, 6))]
    again = [(100 + rid, prompt, 5) for rid, prompt, _ in first[2::-1]]
    return [first, again]


def _knobs(name):
    shape, extra, _ = CASES[name]
    return dict(KNOBS, mesh_shape=shape, **extra)


def _np_params(arch=ARCH, dtype="bfloat16"):
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
    import dataclasses, functools, json, sys
    import repro  # installs the jax < 0.5 compat shims
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import registry
    from repro.configs.base import MeshConfig, RunConfig, SHAPES
    from repro.launch.mesh import make_production_mesh
    from repro.models import model as M
    from repro.parallel import sharding as shlib
    from repro.serving.config import ServeConfig
    from repro.serving.engine import Request, ServingEngine

    jobs, orders, page, out_dir, direct = json.loads(sys.stdin.read())
    rows = []
    sample = M.sample_tokens

    def capturing(row, key, temperature):
        # every greedy step's logits row, in dispatch order
        jax.debug.callback(lambda r: rows.append(np.asarray(r, np.float32)),
                           row)
        return sample(row, key, temperature)
    M.sample_tokens = capturing

    out = {"order": {}}
    for shape in orders:
        m = make_production_mesh(shape=tuple(shape))
        out["order"][str(shape)] = [int(d.id) for d in
                                    np.asarray(m.devices).reshape(-1)]
    params = {}
    for name, arch, dtype, knobs, multi_pod, waves in jobs:
        cfg = dataclasses.replace(registry.smoke(arch), dtype=dtype)
        rc = dataclasses.replace(RunConfig(
            model=cfg, shape=SHAPES["decode_32k"],
            mesh=MeshConfig(multi_pod=multi_pod)), kv_page_size=page)
        if (arch, dtype) not in params:
            params[arch, dtype] = M.init_model(jax.random.PRNGKey(0), cfg)
        knobs = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in knobs.items()}
        rows.clear()
        eng = ServingEngine(params[arch, dtype], cfg, rc,
                            config=ServeConfig(**knobs))
        for wave in waves:
            for rid, prompt, n in wave:
                eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
            eng.run(max_ticks=600)
        jax.effects_barrier()
        np.savez(os.path.join(out_dir, name + ".npz"), *rows)
        t = eng.tier
        if hasattr(t, "ranks"):
            tier = {"ranks": [(r.ops, r.op_ns) for r in t.ranks],
                    "peer": list(zip(t.peer_ops, t.peer_op_ns)),
                    "shard_counters": dict(t.shard_counters)}
        else:
            tier = {"ops": t.ops, "op_ns": t.op_ns}
        tier["snapshot"] = t.snapshot()
        out[name] = {
            "tokens": {r.rid: [int(x) for x in r.generated]
                       for r in eng.finished},
            "restored": sorted(r.rid for r in eng.finished if r.restored),
            "stats": eng.stats.as_dict(), "tier": tier,
            "depth": eng._hot_rc.sr_prefetch_depth}

    # direct prefill chunks and decode ticks of one model under a mesh,
    # its cross gates set and vision K/V written (the VLM)
    for dtype in (direct or {}).get("dtypes", ()):
        arch, shape, gates, batch, max_seq, chunk, prompt, ticks = \
            direct["setup"]
        pmesh = make_production_mesh(shape=tuple(shape))
        cfg = dataclasses.replace(registry.smoke(arch), dtype=dtype)
        rc = dataclasses.replace(RunConfig(
            model=cfg, shape=SHAPES["decode_32k"], mesh=MeshConfig()),
            kv_page_size=page)
        params = M.init_model(jax.random.PRNGKey(0), cfg)
        for g, v in gates.items():
            params["groups"]["cross"][g] = jnp.full(
                jnp.shape(params["groups"]["cross"][g]), v, dtype)
        pspecs = shlib.param_specs(jax.eval_shape(lambda: params),
                                   tier=rc.param_tier, multi_pod_fsdp=False)
        vis = np.load(os.path.join(out_dir, f"vision_{dtype}.npz"))
        logits = []
        with jax.set_mesh(pmesh):
            p = jax.device_put(params, shlib.shardings_from_specs(pmesh,
                                                                  pspecs))
            cache = M.cache_init(cfg, rc, batch, max_seq=max_seq)
            cache["cross_k"] = jnp.asarray(vis["k"]).astype(dtype)
            cache["cross_v"] = jnp.asarray(vis["v"]).astype(dtype)
            cache = jax.device_put(cache, shlib.shardings_from_specs(
                pmesh, M.cache_specs(cfg, rc, batch)))
            prefill = jax.jit(functools.partial(
                M.prefill_step_cached, cfg=cfg, rc=rc, param_specs=pspecs))
            decode = jax.jit(functools.partial(
                M.decode_step, cfg=cfg, rc=rc, param_specs=pspecs))
            toks = np.asarray(prompt, np.int32)
            for s in range(0, toks.shape[1], chunk):
                lg, cache = prefill(p, tokens=jnp.asarray(
                    toks[:, s:s + chunk]), cache=cache)
                logits.append(np.asarray(lg, np.float32))
            cache["pos"] = cache["pos"].at[1].add(5)
            for nt in ticks:
                lg, cache = decode(p, tokens=jnp.asarray(nt, jnp.int32),
                                   cache=cache)
                logits.append(np.asarray(lg, np.float32))
        np.savez(os.path.join(out_dir, f"direct_{dtype}.npz"), *logits)
    print("JAX_DP " + json.dumps(out))
""")


def run_reference(jobs, orders, out_dir, direct=None):
    """Start the reference's runs in a subprocess (four forced host
    devices): the engines of ``jobs`` ((name, arch, dtype, knobs,
    multi_pod, waves)), the device order of each mesh shape of
    ``orders`` and, with ``direct``, one model's direct steps under a
    mesh. Returns a function that waits for it and gives back its
    results, each engine's with its logits ``rows``, and the direct
    steps' logits under ``"direct_<dtype>"``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    log = os.path.join(out_dir, "jax.log")
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", _JAX], stdin=subprocess.PIPE,
            stdout=err, stderr=subprocess.STDOUT, text=True, env=env)
    proc.stdin.write(json.dumps([jobs, orders, PAGE, out_dir, direct]))
    proc.stdin.close()

    def result():
        try:
            proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        with open(log) as err:
            text = err.read()
        line = [ln for ln in text.splitlines() if ln.startswith("JAX_DP ")]
        assert line, text[-3000:]
        want = json.loads(line[0][len("JAX_DP "):])
        names = [job[0] for job in jobs] + [
            f"direct_{d}" for d in (direct or {}).get("dtypes", ())]
        for name in names:
            with np.load(os.path.join(out_dir, name + ".npz")) as z:
                want.setdefault(name, {})["rows"] = [
                    z[f"arr_{i}"] for i in range(len(z.files))]
        return want
    return result


@contextlib.contextmanager
def recording():
    """Per rank, every greedy step in dispatch order -- a prefill (its
    rid; its logits row on the row of slots that ran it) or a tick (this
    rank's rows of slots and whose they are) -- and the slots each
    request retired from and was restored into."""
    from repro_torch.serving.engine import ServingEngine as E
    saved = {n: getattr(E, n) for n in ("_prefill_slot", "_sample",
                                        "_retire", "_apply_restore")}
    rec = {"steps": [], "retired_at": {}, "restored_at": {}}
    admitting = []

    def _prefill_slot(self, req, slot, tokens=None):
        rec["steps"].append({"rid": req.rid, "rows": None})
        admitting.append(req.rid)
        try:
            return saved["_prefill_slot"](self, req, slot, tokens)
        finally:
            admitting.pop()

    def _sample(self, row, *args):
        rows = bridge.to_numpy(row.float())
        if admitting:
            rec["steps"][-1]["rows"] = rows
        else:
            per = row.shape[0]
            first = self._rows[0] * per
            rec["steps"].append({"rows": rows, "who": [
                None if r is None else r.rid
                for r in self.slots[first:first + per]]})
        return saved["_sample"](self, row, *args)

    def _retire(self, slot):
        rec["retired_at"][self.slots[slot].rid] = slot
        return saved["_retire"](self, slot)

    def _apply_restore(self, req, slot, entry):
        rec["restored_at"][req.rid] = (slot, entry["prompt"])
        return saved["_apply_restore"](self, req, slot, entry)
    for n, f in (("_prefill_slot", _prefill_slot), ("_sample", _sample),
                 ("_retire", _retire), ("_apply_restore", _apply_restore)):
        setattr(E, n, f)
    try:
        yield rec
    finally:
        for n, f in saved.items():
            setattr(E, n, f)


def serve_case(world_rank, arch, np_params, config, waves, multi_pod=False,
               dtype="bfloat16"):
    """One rank's run of ``config``'s mesh (built on the joined world) on
    its shard of ``np_params``: ``serve_waves``' record, the steps
    (``recording``), the rank's resident bytes by ``HDMStore``, the SR
    depth and the rank's coordinates."""
    from repro_torch.core import hdm
    shape = config.resolved_mesh_shape
    rank_mesh = mesh.init_mesh(world_rank, shape, device="cpu")
    cfg = dataclasses.replace(treg.smoke(arch), dtype=dtype)
    rc = RunConfig(model=cfg, shape=SHAPES["decode_32k"],
                   mesh=MeshConfig(multi_pod=multi_pod), kv_page_size=PAGE)
    params = bridge.params_from_jax(np_params, cfg, device="cpu",
                                    rank=world_rank, mesh_shape=shape,
                                    multi_pod_fsdp=multi_pod)
    whole = bridge.params_from_jax(np_params, cfg, device="cpu")
    with recording() as rec:
        out = serve_waves(rank_mesh, params, cfg, rc, config, waves, "cpu")
    out.update(rec)
    out["resident"] = hdm.bytes_per_device(
        whole, hdm.HDMStore(rank_mesh, multi_pod_fsdp=multi_pod))
    out["coords"] = rank_mesh.coords
    return out


def merged_steps(runs, shape, n_slots, multi_pod=False):
    """Every step's logits rows and owners across the ranks of model
    column 0 (of pod 0 unless ``multi_pod``), one per row of slots: a
    prefill's row from the rank that ran it, a tick's rows put together
    in slot order."""
    p_n, d_n, n = mesh.mesh_shape3(shape)
    n_rows = (p_n * d_n if multi_pod else d_n) if n_slots > 1 else 1
    rows_of = [runs[r * n] for r in range(n_rows)]
    out = []
    for steps in zip(*[r["steps"] for r in rows_of]):
        if "who" not in steps[0]:
            got = [s["rows"] for s in steps if s["rows"] is not None]
            assert len(got) == 1
            out.append((got[0], [steps[0]["rid"]]))
        else:
            out.append((np.concatenate([s["rows"] for s in steps]),
                        sum((s["who"] for s in steps), [])))
    return out


def _rank(group, np_params, names):
    """One rank of the world: each case of ``names`` whose mesh has this
    world's size, then (two ranks) the stream depths, (four) the FSDP
    gathers."""
    out = {}
    for name in names:
        shape, _, multi_pod = CASES[name]
        if int(np.prod(shape)) == group.size:
            out[name] = serve_case(group.rank, ARCH, np_params,
                                   ServeConfig(**_knobs(name)), _waves(),
                                   multi_pod)
    if group.size == 2:
        out["stream"] = _stream_depths(group, np_params)
    else:
        out["gathers"] = _fsdp_gathers(group)
    return out


def _stream_depths(group, np_params):
    """``decode_step`` on a (2, 1) mesh's FSDP shard, the whole batch on
    each rank, at SR depths 0, 1 and 2 and granularity 1 and 2: the
    logits (bit for bit those of the whole weights on one rank) and the
    data axis's gathers of each."""
    import torch
    from repro_torch.models import model as TM
    cfg = dataclasses.replace(treg.smoke(ARCH), dtype="bfloat16")
    rank_mesh = mesh.init_mesh(group.rank, (2, 1), device="cpu")
    shard = bridge.params_from_jax(np_params, cfg, device="cpu",
                                   rank=group.rank, mesh_shape=(2, 1))
    whole = bridge.params_from_jax(np_params, cfg, device="cpu")
    tokens = torch.tensor([[5], [77], [130]], dtype=torch.int32)
    out = {}
    for depth, gran in ((0, 1), (1, 1), (2, 1), (1, 2)):
        rc = RunConfig(model=cfg, shape=SHAPES["decode_32k"],
                       mesh=MeshConfig(), kv_page_size=PAGE,
                       sr_prefetch_depth=depth, sr_granularity=gran)
        logits = {}
        for who, params, ranks in (
                ("one", whole, None),
                ("fsdp", shard, TM.Ranks(fsdp=rank_mesh.data))):
            cache = TM.cache_init(cfg, rc, 3, 64, device="cpu")
            cache["pos"] += torch.tensor([0, 9, 30], dtype=torch.int32)
            mesh.COLLECTIVES.clear()
            lg = [TM.decode_step(params, cfg, rc, tokens, cache,
                                 ranks=ranks)[0] for _ in range(2)]
            logits[who] = torch.cat(lg).float().numpy()
        out[depth, gran] = (logits, dict(mesh.COLLECTIVES))
    return out


def _fsdp_gathers(group):
    """For each family: ``gather_fsdp`` of this rank's (2, 2) shard over
    the data axis against its model-axis shard, and of its (4, 1) shard
    against the whole model -- (leaves, FSDP leaves, leaves not equal bit
    for bit) each."""
    import torch
    from repro_torch.models import model as TM
    out = {}
    for arch in FAMILIES:
        cfg = treg.smoke(arch)
        whole = TM.init_model(cfg, seed=1, device="cpu")
        specs = tsh.param_specs(whole)
        for shape in ((2, 2), (4, 1)):
            rank_mesh = mesh.init_mesh(group.rank, shape, device="cpu")
            _, d, m = rank_mesh.coords
            n = shape[-1]
            shard = tsh.shard_params(whole, m, n, specs, fsdp=(d, shape[0]))
            got = dict(tsh.gather_fsdp(shard, rank_mesh.data)
                       .named_parameters())
            want = dict((tsh.shard_params(whole, m, n, specs) if n > 1
                         else whole).named_parameters())
            cut = sum(1 for mod in shard.modules()
                      for _ in mod.__dict__.get(tsh.FSDP_ATTR, {}))
            bad = [k for k, p in want.items()
                   if not torch.equal(got[k], p)]
            out[arch, shape] = (len(want), cut, bad, sorted(got) ==
                                sorted(want))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs (a subprocess) and the port's: the four-rank
    cases in one spawn of four ranks, the two-rank ones in one of two."""
    out_dir = str(tmp_path_factory.mktemp("data_axis"))
    jobs = [(name, ARCH, "bfloat16",
             dict(_knobs(name), tier_topology=list(KNOBS["tier_topology"])),
             CASES[name][2], _waves()) for name in CASES]
    result = run_reference(jobs, [list(s) for s in ORDERS], out_dir)
    np_params = _np_params()
    names = list(CASES)
    ranks = {}
    for size in (4, 2):
        ranks[size] = mesh.spawn(
            _rank, size, (np_params, names),
            rendezvous_dir=str(tmp_path_factory.mktemp("rdv")),
            device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    return ranks, result()


def _case_runs(runs, name):
    ranks, want = runs
    shape = CASES[name][0]
    return [r[name] for r in ranks[int(np.prod(shape))]], want[name]


def _stats(stats):
    return {k: v for k, v in stats.items() if k not in WALL_STATS}


def _as_json(x):
    return json.loads(json.dumps(x))


def _active(steps):
    """The rows of slots that hold a request, in dispatch order."""
    return [row[i] for row, who in steps for i, rid in enumerate(who)
            if rid is not None]


@pytest.mark.parametrize("name", list(CASES))
def test_data_axis_engine_matches_jax(runs, name):
    """Every rank against the reference's engine on the same mesh:
    tokens, every stat but wall time, the tier's traces (every model
    rank's and peer lane's, or the one ``CxlTier``'s) and snapshot, the
    restored rids and the SR depth."""
    port, ref = _case_runs(runs, name)
    assert ref["restored"] == [100, 101, 102]
    for run in port:
        assert _as_json(run["tokens"]) == ref["tokens"]
        assert _as_json(_stats(run["stats"])) == _stats(ref["stats"])
        assert _as_json(run["tier"]) == ref["tier"]
        assert run["restored"] == ref["restored"]


@pytest.mark.parametrize("name", list(CASES))
def test_data_axis_logits_match_jax(runs, name):
    """Every greedy step's logits row of every served request within
    bf16's 2e-2 of the reference's, in dispatch order, the rows of a tick
    put together from the rows of slots."""
    port, ref = _case_runs(runs, name)
    knobs = _knobs(name)
    steps = merged_steps(port, knobs["mesh_shape"], knobs["n_slots"],
                         CASES[name][2])
    assert len(steps) == len(ref["rows"])
    got = _active(steps)
    want = _active([(r, who) for r, (_, who) in zip(ref["rows"], steps)])
    assert len(got) == sum(len(t) - (rid in port[0]["restored"])
                           for rid, t in port[0]["tokens"].items())
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **BF16_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_data_axis_ranks_agree_and_hold_their_shard(runs, name):
    """Every rank serves alike (stats, traces, tokens) on its shard of
    the weights: its bytes are the whole model's split by every leaf's
    spec over the model axis and the FSDP axes (data, or pod and data
    with ``multi_pod``; ``HDMStore``), which split most of the bytes; the
    SR keeps its depth (the reference's: 1) since the data and pod axes
    have more than one rank."""
    port, ref = _case_runs(runs, name)
    shape, _, multi_pod = CASES[name]
    p_n, d_n, n = mesh.mesh_shape3(shape)
    f_n = p_n * d_n if multi_pod else d_n
    cfg = dataclasses.replace(treg.smoke(ARCH), dtype="bfloat16")
    whole = bridge.params_from_jax(_np_params(), cfg, device="cpu")
    specs = tsh.param_specs(whole, multi_pod_fsdp=multi_pod)
    nbytes = {k: p.numel() * p.element_size()
              for k, p in whole.named_parameters()}
    fsdp = {k for k in nbytes if tsh._fsdp_axis(specs[k]) is not None}
    want = sum(b // (n if "model" in specs[k] else 1)
               // (f_n if k in fsdp else 1) for k, b in nbytes.items())
    assert sum(nbytes[k] for k in fsdp) > 0.9 * sum(nbytes.values())
    assert ref["depth"] == 1
    for run in port:
        assert run["param_bytes"] == run["resident"] == want
        assert _stats(run["stats"]) == _stats(port[0]["stats"])
        assert run["tier"] == port[0]["tier"]
        assert run["tokens"] == port[0]["tokens"]


@pytest.mark.parametrize("name", ["bf16-2x2", "int8-2x2", "2x1", "4x1",
                                  "2x1x2-multipod"])
def test_data_axis_restores_cross_rows(runs, name):
    """Where the slots are split over rows (of the data axis, or of pod
    and data with ``multi_pod``), a retired entry was restored into a
    slot of another row than the one it retired from."""
    port, _ = _case_runs(runs, name)
    knobs = _knobs(name)
    p_n, d_n, _ = mesh.mesh_shape3(knobs["mesh_shape"])
    per = knobs["n_slots"] // (p_n * d_n if CASES[name][2] else d_n)
    first = {tuple(p): rid for rid, p, _ in _waves()[0]}
    for run in port:
        crossed = [rid for rid, (slot, prompt) in run["restored_at"].items()
                   if run["retired_at"][first[tuple(prompt)]] // per
                   != slot // per]
        assert crossed, run["restored_at"]


def test_rank_numbering_is_make_mesh_order(runs):
    """World rank (p D + d) N + m sits where ``jax.make_mesh`` puts
    device (p D + d) N + m, and ``launch.mesh.coords`` inverts it."""
    _, want = runs
    for shape in ORDERS:
        order = want["order"][str(list(shape))]
        assert order == list(range(int(np.prod(shape))))
        p_n, d_n, n = mesh.mesh_shape3(shape)
        for p in range(p_n):
            for d in range(d_n):
                for m in range(n):
                    r = (p * d_n + d) * n + m
                    assert mesh.coords(r, shape) == (p, d, m)
    for r, run in enumerate(runs[0][4]):
        assert run["bf16-2x2"]["coords"] == mesh.coords(r, (2, 2))


@pytest.mark.parametrize("arch", FAMILIES)
def test_gather_fsdp_restores_the_shard(runs, arch):
    """``gather_fsdp`` of every rank's POOL shard puts back, bit for bit,
    its model-axis shard at (2, 2) and the whole model at (4, 1); every
    family has FSDP leaves."""
    ranks, _ = runs
    for run in ranks[4]:
        for shape in ((2, 2), (4, 1)):
            n_leaves, cut, bad, same_names = run["gathers"][arch, shape]
            assert same_names and not bad, bad
            assert 0 < cut <= n_leaves


@pytest.mark.parametrize("depth,gran", [(0, 1), (1, 1), (2, 1), (1, 2)])
def test_stream_depths_agree(runs, depth, gran):
    """The SR stream over a (2, 1) mesh's FSDP shard gives the one-rank
    decode's logits bit for bit at every depth; it gathers each of the
    four layers and the embedding once a step (the reads past the last
    layer left out), granularity times over."""
    ranks, _ = runs
    for run in ranks[2]:
        logits, coll = run["stream"][depth, gran]
        np.testing.assert_array_equal(logits["fsdp"], logits["one"])
        assert coll == {"data:all_gather": 2 * gran * (4 + 1)}


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", sorted(treg.ARCHS))
def test_pool_specs_match_reference(arch, multi_pod):
    """``param_specs`` at ``tier="pool"``, with and without
    ``multi_pod_fsdp``, equals the reference's leaf by leaf at smoke
    size, the reference's stacked axes aside."""
    cfg = jreg.smoke(arch)
    tree = jax.eval_shape(lambda: JM.init_model(jax.random.PRNGKey(0), cfg))
    want = jsh.param_specs(tree, tier="pool", multi_pod_fsdp=multi_pod)
    model = bridge.params_from_jax(
        jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                               tree), treg.smoke(arch), device="cpu")
    got = tsh.param_specs(model, tier="pool", multi_pod_fsdp=multi_pod)
    fsdp = ("pod", "data") if multi_pod else "data"
    for name in got:
        path, n_idx = tsh.ref_path(name)
        spec = want
        for part in path.split("/"):
            spec = spec[part]
        assert got[name] == tuple(spec)[n_idx:], name
    assert any(fsdp in s for s in got.values())
