"""The audio, VLM and xLSTM families served by the port at tp 2 against
the reference's sharded engine, on the CPU.

Smoke musicgen-large, llama-3.2-vision-11b and xlstm-125m (bf16 weights
and pages), each served by the port on two spawned gloo ranks
(``launch.mesh.spawn``), every rank on its shard of the weights
(``bridge.params_from_jax(rank=, n_ranks=)``, cut by
``parallel.sharding``) with its half of every slot's pages and whole
per-slot states, and by the reference's ``ServingEngine(tp=2)`` in a
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=2``
on the same weights (both draw them from ``PRNGKey(0)``) and traffic.
Held: greedy tokens, every stat but wall time, every rank's and peer
lane's tier trace and the shard counters equal; the two ranks agree; the
logits row of every greedy step within bf16's 2e-2 of the reference's
(xLSTM's tokens are degenerate -- three of the four requests repeat one
id -- and smoke musicgen's can be: the logits are the finer gate); each
rank's parameter bytes are the whole model's less the other rank's half
of its split leaves. The served VLM never writes vision K/V,
so its cross layers add 0 there: a direct ``prefill_step_cached`` /
``decode_step`` gate with vision K/V written from random embeddings and
both cross gates away from 0 holds the port at tp 2 to the reference's
steps under a (1, 2) mesh (f32 3e-5, bf16 2e-2).
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
from repro_torch.launch import mesh
from repro_torch.launch.serve import serve_waves
from repro_torch.models import model as TM
from repro_torch.parallel import sharding
from repro_torch.serving.config import ServeConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MUSICGEN, VLM, XLSTM = ("musicgen-large", "llama-3.2-vision-11b",
                        "xlstm-125m")
ARCHS = (MUSICGEN, VLM, XLSTM)
PAGE, TP = 16, 2
KNOBS = dict(n_slots=4, max_seq=64, prefill_chunk=8,
             tier_topology=("dram", "ssd-fast"))
SPAWN_TIMEOUT_S = 300.0
WALL_STATS = ("prefill_time_s",)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
F32_TOL = dict(atol=3e-5, rtol=3e-5)
# the direct VLM gate: 2 rows, a 12-token prompt in chunks of 4, 4 ticks
# (row 1 five positions on), cross gates away from 0
B, PROMPT, CHUNK, TICKS = 2, 12, 4, 4
GATES = {"attn_gate": 0.7, "mlp_gate": -0.4}
DTYPES = ("float32", "bfloat16")


def _waves(arch):
    """Four prompts of 5-39 tokens (chunks of 8), 5 new tokens each; for
    musicgen (restorable) two of them again under new rids."""
    vocab = treg.smoke(arch).vocab_size
    rng = np.random.default_rng(7)
    first = [(rid, rng.integers(1, vocab, int(n)).tolist(), 5)
             for rid, n in enumerate(rng.integers(5, 40, 4))]
    if arch != MUSICGEN:
        return [first]
    return [first, [(100 + rid, prompt, 5) for rid, prompt, _ in first[:2]]]


def _jax_params(arch, dtype="bfloat16", gates=False):
    """The reference's weights for smoke ``arch`` (``PRNGKey(0)``, as the
    subprocess draws them), numpy leaves (bf16 as 2-byte voids, which
    pickle without ml_dtypes); with ``gates``, the VLM's cross gates set
    to ``GATES``."""
    cfg = dataclasses.replace(jreg.smoke(arch), dtype=dtype)
    params = JM.init_model(jax.random.PRNGKey(0), cfg)
    if gates:
        params["groups"]["cross"] = _gated(params["groups"]["cross"], dtype)

    def leaf(a):
        a = np.asarray(a)
        return a.view(np.dtype("V2")) if a.dtype.name == "bfloat16" else a
    return jax.tree_util.tree_map(leaf, params)


def _gated(cross, dtype):
    out = dict(cross)
    for name, g in GATES.items():
        out[name] = jnp.full(jnp.shape(cross[name]), g, dtype)
    return out


def _vision(dtype):
    """Every cross layer's vision K/V from random embeddings, as the
    reference's ``vision_kv`` writes them: {"k", "v"}: f32 arrays of the
    ``dtype`` values [g, B, Nv, Hkv, D]."""
    cfg = dataclasses.replace(jreg.smoke(VLM), dtype=dtype)
    params = JM.init_model(jax.random.PRNGKey(0), cfg)
    cross = _gated(params["groups"]["cross"], dtype)
    emb = jnp.asarray(np.random.default_rng(5).standard_normal(
        (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    ).astype(dtype)
    g = cfg.n_layers // cfg.cross_attn_period
    kvs = [JT.vision_kv(jax.tree_util.tree_map(lambda a: a[gi], cross),
                        cfg, emb) for gi in range(g)]
    return {name: np.asarray(jnp.stack([kv[i] for kv in kvs]), np.float32)
            for i, name in enumerate(("k", "v"))}


def _direct_tokens(vocab):
    rng = np.random.default_rng(9)
    return (rng.integers(1, vocab, (B, PROMPT)).tolist(),
            [rng.integers(1, vocab, (B, 1)).tolist() for _ in range(TICKS)])


_JAX = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
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

    jobs, direct, knobs, page, out_dir = json.loads(sys.stdin.read())
    rows = []
    sample = M.sample_tokens

    def capturing(row, key, temperature):
        # every greedy step's logits row, in dispatch order
        jax.debug.callback(lambda r: rows.append(np.asarray(r, np.float32)),
                           row)
        return sample(row, key, temperature)
    M.sample_tokens = capturing

    def setup(arch, dtype):
        cfg = dataclasses.replace(registry.smoke(arch), dtype=dtype)
        rc = dataclasses.replace(RunConfig(
            model=cfg, shape=SHAPES["decode_32k"], mesh=MeshConfig()),
            kv_page_size=page)
        return cfg, rc, M.init_model(jax.random.PRNGKey(0), cfg)

    out = {}
    for name, arch, dtype, waves in jobs:
        cfg, rc, params = setup(arch, dtype)
        rows.clear()
        eng = ServingEngine(params, cfg, rc, config=ServeConfig(tp=2,
                                                                **knobs))
        for wave in waves:
            for rid, prompt, n in wave:
                eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
            eng.run(max_ticks=600)
        jax.effects_barrier()
        np.savez(os.path.join(out_dir, name + ".npz"), *rows)
        t = eng.tier
        out[name] = {
            "tokens": {r.rid: [int(x) for x in r.generated]
                       for r in eng.finished},
            "restored": sorted(r.rid for r in eng.finished if r.restored),
            "stats": eng.stats.as_dict(),
            "tier": {"ranks": [(r.ops, r.op_ns) for r in t.ranks],
                     "peer": list(zip(t.peer_ops, t.peer_op_ns)),
                     "shard_counters": dict(t.shard_counters),
                     "snapshot": t.snapshot()}}

    arch, gates, batch, max_seq, chunk, prompt, ticks = direct["setup"]
    pmesh = make_production_mesh(shape=(1, 2))
    for dtype in direct["dtypes"]:
        cfg, rc, params = setup(arch, dtype)
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
                lg, cache = prefill(p, tokens=jnp.asarray(toks[:, s:s + chunk]),
                                    cache=cache)
                logits.append(np.asarray(lg, np.float32))
            cache["pos"] = cache["pos"].at[1].add(5)
            for nt in ticks:
                lg, cache = decode(p, tokens=jnp.asarray(nt, jnp.int32),
                                   cache=cache)
                logits.append(np.asarray(lg, np.float32))
        np.savez(os.path.join(out_dir, f"direct_{dtype}.npz"), *logits)
    print("JAX_TP2 " + json.dumps(out))
""")


def _jobs():
    return [(arch, arch, "bfloat16", _waves(arch)) for arch in ARCHS]


def _config(arch, dtype="bfloat16"):
    cfg = dataclasses.replace(treg.smoke(arch), dtype=dtype)
    return (RunConfig(model=cfg, shape=SHAPES["decode_32k"],
                      mesh=MeshConfig(), kv_page_size=PAGE),
            ServeConfig(tp=TP, **KNOBS))


@contextlib.contextmanager
def capturing_rows():
    """Every greedy step's logits row (f32 numpy, in dispatch order) and
    whose it is: a prefill's one row (its rid), a tick's row per slot
    (the slot's rid, or None for an idle slot)."""
    from repro_torch.serving.engine import ServingEngine
    prefill, sample = ServingEngine._prefill_slot, ServingEngine._sample
    rec, admitting = {"rows": [], "who": []}, []

    def _prefill_slot(self, req, slot, tokens=None):
        admitting.append(req.rid)
        try:
            return prefill(self, req, slot, tokens)
        finally:
            admitting.pop()

    def _sample(self, row):
        rec["rows"].append(bridge.to_numpy(row.float()))
        rec["who"].append([admitting[-1]] if admitting else
                          [None if r is None else r.rid for r in self.slots])
        return sample(self, row)
    ServingEngine._prefill_slot, ServingEngine._sample = (_prefill_slot,
                                                          _sample)
    try:
        yield rec
    finally:
        ServingEngine._prefill_slot, ServingEngine._sample = prefill, sample


def _direct(group, dtype, np_params, vision, toks, ticks):
    """The VLM's prefill chunks and ticks on this rank (its shard of the
    gated weights, its pages of a 2-row cache whose vision K/V are
    ``vision``): every step's logits."""
    import torch
    rc, _ = _config(VLM, dtype)
    cfg = rc.model
    params = bridge.params_from_jax(np_params, cfg, device="cpu",
                                    rank=group.rank, n_ranks=group.size)
    cache = TM.cache_init(cfg, rc, B, KNOBS["max_seq"], device="cpu")
    for name in ("k", "v"):
        cache["cross_" + name].copy_(torch.from_numpy(vision[name]))
    cache = sharding.shard_cache(cache, group.rank, group.size)
    toks = torch.tensor(toks, dtype=torch.int32)
    out = []
    for s in range(0, PROMPT, CHUNK):
        lg, _ = TM.prefill_step_cached(params, cfg, rc, toks[:, s:s + CHUNK],
                                       cache, group=group)
        out.append(bridge.to_numpy(lg))
    cache["pos"][1] += 5
    for nt in ticks:
        lg, _ = TM.decode_step(params, cfg, rc,
                               torch.tensor(nt, dtype=torch.int32), cache,
                               group=group)
        out.append(bridge.to_numpy(lg))
    return out


def _rank(group, served, direct):
    """One rank: each family's traffic on its shard (tokens, stats, tier
    traces, parameter bytes, logits rows), then the direct VLM steps."""
    out = {}
    for arch, np_params in served.items():
        rc, config = _config(arch)
        params = bridge.params_from_jax(np_params, rc.model, device="cpu",
                                        rank=group.rank, n_ranks=group.size)
        with capturing_rows() as rec:
            out[arch] = serve_waves(group, params, rc.model, rc, config,
                                    _waves(arch), "cpu")
        out[arch].update(rec)
    for dtype, args in direct.items():
        out["direct_" + dtype] = _direct(group, dtype, *args)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's sharded runs (a subprocess) and the port's two
    ranks (spawned meanwhile), on the same weights and traffic."""
    out_dir = str(tmp_path_factory.mktemp("families"))
    vocab = treg.smoke(VLM).vocab_size
    prompt, ticks = _direct_tokens(vocab)
    direct = {}
    for dtype in DTYPES:
        vision = _vision(dtype)
        np.savez(os.path.join(out_dir, f"vision_{dtype}.npz"), **vision)
        direct[dtype] = (_jax_params(VLM, dtype, gates=True), vision, prompt,
                         ticks)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    knobs = dict(KNOBS, tier_topology=list(KNOBS["tier_topology"]))
    setup = [VLM, GATES, B, KNOBS["max_seq"], CHUNK, prompt, ticks]
    log = os.path.join(out_dir, "jax.log")
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", _JAX], stdin=subprocess.PIPE,
            stdout=err, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        proc.stdin.write(json.dumps(
            [_jobs(), {"setup": setup, "dtypes": list(DTYPES)}, knobs, PAGE,
             out_dir]))
        proc.stdin.close()
        served = {arch: _jax_params(arch) for arch in ARCHS}
        ranks = mesh.spawn(_rank, TP, (served, direct),
                           rendezvous_dir=str(tmp_path_factory.mktemp("rdv")),
                           device="cpu", timeout_s=SPAWN_TIMEOUT_S)
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(log) as err:
        text = err.read()
    line = [ln for ln in text.splitlines() if ln.startswith("JAX_TP2 ")]
    assert line, text[-3000:]
    want = json.loads(line[0][len("JAX_TP2 "):])
    for name in list(want) + [f"direct_{d}" for d in DTYPES]:
        with np.load(os.path.join(out_dir, name + ".npz")) as z:
            rows = [z[f"arr_{i}"] for i in range(len(z.files))]
        want.setdefault(name, {})["rows"] = rows
    return ranks, want


def _stats(stats):
    return {k: v for k, v in stats.items() if k not in WALL_STATS}


def _as_json(x):
    return json.loads(json.dumps(x))


def _active_rows(rows, who):
    """The rows of slots that hold a request, in dispatch order."""
    out = []
    for row, rids in zip(rows, who):
        out.extend(row[i] for i, rid in enumerate(rids) if rid is not None)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_sharded(runs, arch):
    """Rank 0 against the reference's sharded engine: tokens, every stat
    but wall time, every rank's and peer lane's trace, the counters."""
    ranks, want = runs
    run, ref = ranks[0][arch], want[arch]
    assert _as_json(run["tokens"]) == ref["tokens"]
    assert _as_json(_stats(run["stats"])) == _stats(ref["stats"])
    assert _as_json(run["tier"]) == ref["tier"]
    assert run["restored"] == ref["restored"]
    if arch == MUSICGEN:
        assert run["restored"] == [100, 101]
        assert ref["stats"]["tier_peer_fetches"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_logits_match_jax_sharded(runs, arch):
    """Every greedy step's logits row of every served request within
    bf16's 2e-2 of the reference's sharded engine's, in dispatch order."""
    ranks, want = runs
    run = ranks[0][arch]
    ref_rows = want[arch]["rows"]
    assert len(ref_rows) == len(run["rows"])
    got = _active_rows(run["rows"], run["who"])
    ref = _active_rows(ref_rows, run["who"])
    assert len(got) == sum(len(t) - (rid in run["restored"])
                           for rid, t in run["tokens"].items())
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, **BF16_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_ranks_agree(runs, arch):
    """Both ranks serve alike: tokens, stats but wall time, tier traces
    and the logits rows bit for bit."""
    ranks, _ = runs
    first = ranks[0][arch]
    for run in ranks[1:]:
        run = run[arch]
        assert run["tokens"] == first["tokens"]
        assert _stats(run["stats"]) == _stats(first["stats"])
        assert run["tier"] == first["tier"]
        for a, b in zip(run["rows"], first["rows"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_holds_its_shard(runs, arch):
    """A rank's parameter bytes: the whole model's less the other rank's
    half of every leaf its spec splits, which are most of the bytes."""
    ranks, _ = runs
    rc, _ = _config(arch)
    whole = bridge.params_from_jax(_jax_params(arch), rc.model,
                                   device="cpu")
    specs = sharding.param_specs(whole)
    nbytes = {n: p.numel() * p.element_size()
              for n, p in whole.named_parameters()}
    total = sum(nbytes.values())
    split = sum(b for n, b in nbytes.items() if "model" in specs[n])
    assert split > total // 2
    for run in ranks:
        assert run[arch]["param_bytes"] == total - split + split // TP


@pytest.mark.parametrize("dtype", DTYPES)
def test_vlm_direct_steps_match_jax_sharded(runs, dtype):
    """With vision K/V from random embeddings and both cross gates away
    from 0, the port's prefill chunks and decode ticks at tp 2 (both
    ranks) against the reference's steps under a (1, 2) mesh."""
    ranks, want = runs
    ref = want[f"direct_{dtype}"]["rows"]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for run in ranks:
        got = run[f"direct_{dtype}"]
        assert len(got) == len(ref) == PROMPT // CHUNK + TICKS
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, **tol)
