"""The hybrid family (smoke zamba2-2.7b) served by the port at tp 2
against the reference's sharded engine, on the CPU.

The port runs two spawned gloo ranks (``launch.mesh.spawn``), each on its
shard of the reference's weights (``in_proj``'s columns, split at the end
of z; ``conv_w``'s channels, split inside x; ``out_proj``'s rows; the
shared block's attention and MLP) with its half of every slot's pages and
the Mamba2 states whole; the reference's ``ServingEngine`` runs in a
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=2``,
at tp 2 and, in bf16, at tp 1 too. Both draw the weights from
``PRNGKey(0)``.

 * f32 weights: greedy tokens, every stat but wall time, the tier traces
   and the counters equal the reference's at tp 2.
 * bf16 weights: the reference's own tp 1 and tp 2 part (its bf16
   sums split differently), so token equality with another split is no
   fair gate. The stats and tier traces equal the reference's at tp 2;
   every greedy step's logits lie within ``NOISE_X`` times the
   reference's own tp 1 / tp 2 distance (plus bf16's 2e-2) of its tp 2
   logits, and where tokens part -- the reference's two splits, or the
   port and the reference -- the logits of the two tokens are within that
   bound of each other: a near tie.

Both: the two ranks agree bit for bit, and each holds the whole model's
parameter bytes less the other rank's half of its split leaves.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
from repro_torch.launch import mesh
from repro_torch.launch.serve import serve_waves
from repro_torch.parallel import sharding
from repro_torch.serving.config import ServeConfig
from test_torch_sharded_families import (_as_json, _jax_params, _stats,
                                         capturing_rows)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "zamba2-2.7b"
PAGE, TP = 16, 2
KNOBS = dict(n_slots=4, max_seq=64, prefill_chunk=8,
             tier_topology=("dram", "ssd-fast"))
SPAWN_TIMEOUT_S = 300.0
DTYPES = ("float32", "bfloat16")
# the bf16 bound: this many times the reference's own tp 1 / tp 2
# distance, plus bf16's atol (chip_smoke.py's TP_NOISE_X form)
NOISE_X, ATOL = 3.0, 2e-2


def _waves():
    """Four prompts of 5-39 tokens (chunks of 8), 5 new tokens each."""
    rng = np.random.default_rng(7)
    return [[(rid, rng.integers(1, 256, int(n)).tolist(), 5)
             for rid, n in enumerate(rng.integers(5, 40, 4))]]


_JAX = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import contextlib, dataclasses, json, sys
    import repro  # installs the jax < 0.5 compat shims
    import jax, numpy as np
    from repro.configs import registry
    from repro.configs.base import MeshConfig, RunConfig, SHAPES
    from repro.launch.mesh import make_host_mesh
    from repro.models import model as M
    from repro.serving.config import ServeConfig
    from repro.serving.engine import Request, ServingEngine

    jobs, waves, knobs, page, out_dir = json.loads(sys.stdin.read())
    rows = []
    sample = M.sample_tokens

    def capturing(row, key, temperature):
        # every greedy step's logits row, in dispatch order
        jax.debug.callback(lambda r: rows.append(np.asarray(r, np.float32)),
                           row)
        return sample(row, key, temperature)
    M.sample_tokens = capturing

    out = {}
    for dtype, tp in jobs:
        cfg = dataclasses.replace(registry.smoke("zamba2-2.7b"), dtype=dtype)
        rc = dataclasses.replace(RunConfig(
            model=cfg, shape=SHAPES["decode_32k"], mesh=MeshConfig()),
            kv_page_size=page)
        params = M.init_model(jax.random.PRNGKey(0), cfg)
        rows.clear()
        scope = (jax.set_mesh(make_host_mesh()) if tp == 1
                 else contextlib.nullcontext())
        with scope:
            eng = ServingEngine(params, cfg, rc,
                                config=ServeConfig(tp=tp, **knobs))
            for wave in waves:
                for rid, prompt, n in wave:
                    eng.submit(Request(rid=rid, prompt=prompt,
                                       max_new_tokens=n))
                eng.run(max_ticks=600)
        jax.effects_barrier()
        name = f"{dtype}_tp{tp}"
        np.savez(os.path.join(out_dir, name + ".npz"), *rows)
        t = eng.tier
        out[name] = {
            "tokens": {r.rid: [int(x) for x in r.generated]
                       for r in eng.finished},
            "stats": eng.stats.as_dict()}
        if tp > 1:
            out[name]["tier"] = {
                "ranks": [(r.ops, r.op_ns) for r in t.ranks],
                "peer": list(zip(t.peer_ops, t.peer_op_ns)),
                "shard_counters": dict(t.shard_counters),
                "snapshot": t.snapshot()}
    print("JAX_TP " + json.dumps(out))
""")
_JOBS = [("float32", 2), ("bfloat16", 2), ("bfloat16", 1)]


def _config(dtype):
    cfg = dataclasses.replace(treg.smoke(ARCH), dtype=dtype)
    return (RunConfig(model=cfg, shape=SHAPES["decode_32k"],
                      mesh=MeshConfig(), kv_page_size=PAGE),
            ServeConfig(tp=TP, **KNOBS))


def _rank(group, weights):
    """One rank: the traffic on its shard, in each dtype."""
    out = {}
    for dtype, np_params in weights.items():
        rc, config = _config(dtype)
        params = bridge.params_from_jax(np_params, rc.model, device="cpu",
                                        rank=group.rank, n_ranks=group.size)
        with capturing_rows() as rec:
            out[dtype] = serve_waves(group, params, rc.model, rc, config,
                                     _waves(), "cpu")
        out[dtype].update(rec)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs (a subprocess) and the port's two ranks
    (spawned meanwhile), on the same weights and traffic."""
    out_dir = str(tmp_path_factory.mktemp("hybrid"))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    knobs = dict(KNOBS, tier_topology=list(KNOBS["tier_topology"]))
    log = os.path.join(out_dir, "jax.log")
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", _JAX], stdin=subprocess.PIPE,
            stdout=err, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        proc.stdin.write(json.dumps([_JOBS, _waves(), knobs, PAGE, out_dir]))
        proc.stdin.close()
        weights = {d: _jax_params(ARCH, d) for d in DTYPES}
        ranks = mesh.spawn(_rank, TP, (weights,),
                           rendezvous_dir=str(tmp_path_factory.mktemp("rdv")),
                           device="cpu", timeout_s=SPAWN_TIMEOUT_S)
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(log) as err:
        text = err.read()
    line = [ln for ln in text.splitlines() if ln.startswith("JAX_TP ")]
    assert line, text[-3000:]
    want = json.loads(line[0][len("JAX_TP "):])
    for name, run in want.items():
        with np.load(os.path.join(out_dir, name + ".npz")) as z:
            run["rows"] = [z[f"arr_{i}"] for i in range(len(z.files))]
    return ranks, want


def _steps(rows, who):
    """``{rid: [logits row of each greedy step]}``, in order."""
    out = {}
    for row, rids in zip(rows, who):
        for i, rid in enumerate(rids):
            if rid is not None:
                out.setdefault(rid, []).append(row[i])
    return out


def _comparable(a_rows, b_rows):
    """The steps up to and including the first whose argmaxes part."""
    n = 0
    for a, b in zip(a_rows, b_rows):
        n += 1
        if int(a.argmax()) != int(b.argmax()):
            break
    return n


def _parting(want_rows, got_rows):
    """The first step whose argmaxes part, the two tokens and the gap of
    their logits in ``want_rows``; None where none does."""
    for j, (a, b) in enumerate(zip(want_rows, got_rows)):
        top, theirs = int(a.argmax()), int(b.argmax())
        if top != theirs:
            return j, top, theirs, float(a[top] - a[theirs])
    return None


def _bound(want, who):
    """``NOISE_X`` times the reference's own tp 1 / tp 2 distance over
    their comparable steps, plus ``ATOL``."""
    one = _steps(want["bfloat16_tp1"]["rows"], who)
    two = _steps(want["bfloat16_tp2"]["rows"], who)
    noise = max(float(np.abs(a - b).max())
                for rid in one
                for a, b in list(zip(one[rid], two[rid]))[
                    :_comparable(one[rid], two[rid])])
    return NOISE_X * noise + ATOL


@pytest.mark.parametrize("dtype", DTYPES)
def test_hybrid_schedule_matches_jax_sharded(runs, dtype):
    """Rank 0's stats but wall time, tier traces and counters equal the
    reference's at tp 2, in both dtypes."""
    ranks, want = runs
    run, ref = ranks[0][dtype], want[f"{dtype}_tp2"]
    assert _as_json(_stats(run["stats"])) == _stats(ref["stats"])
    assert _as_json(run["tier"]) == ref["tier"]
    assert len(run["rows"]) == len(ref["rows"])


def test_hybrid_f32_tokens_match_jax_sharded(runs):
    """In f32, every greedy token equals the reference's at tp 2."""
    ranks, want = runs
    assert _as_json(ranks[0]["float32"]["tokens"]) == \
        want["float32_tp2"]["tokens"]


def test_hybrid_bf16_logits_within_the_references_own_split_noise(runs):
    """In bf16, every greedy step's logits within the bound of the
    reference's tp 2 logits until the tokens part, and a parting only at
    a near tie; the tokens equal up to it."""
    ranks, want = runs
    run = ranks[0]["bfloat16"]
    bound = _bound(want, run["who"])
    got = _steps(run["rows"], run["who"])
    ref = _steps(want["bfloat16_tp2"]["rows"], run["who"])
    tokens = want["bfloat16_tp2"]["tokens"]
    for rid, rows in ref.items():
        n = _comparable(rows, got[rid])
        for a, b in zip(rows[:n], got[rid][:n]):
            assert float(np.abs(a - b).max()) <= bound, (rid, bound)
        part = _parting(rows, got[rid])
        mine = run["tokens"][rid]
        if part is None:
            assert mine == tokens[str(rid)]
        else:
            assert part[3] <= bound, (rid, part, bound)
            assert mine[:part[0]] == tokens[str(rid)][:part[0]]


def test_hybrid_references_own_splits_part_at_a_near_tie(runs):
    """The reference's bf16 tp 1 and tp 2 logits differ (the noise the
    bound is measured on is not 0), and their tokens part only where tp
    1's logits of the two tokens are within the bound of each other."""
    ranks, want = runs
    who = ranks[0]["bfloat16"]["who"]
    bound = _bound(want, who)
    assert bound > ATOL
    one = _steps(want["bfloat16_tp1"]["rows"], who)
    two = _steps(want["bfloat16_tp2"]["rows"], who)
    for rid in one:
        part = _parting(one[rid], two[rid])
        if part is not None:
            assert part[3] <= bound, (rid, part, bound)


@pytest.mark.parametrize("dtype", DTYPES)
def test_hybrid_ranks_agree(runs, dtype):
    """Both ranks serve alike: tokens, stats but wall time, tier traces,
    the logits rows bit for bit."""
    ranks, _ = runs
    first = ranks[0][dtype]
    for run in ranks[1:]:
        run = run[dtype]
        assert run["tokens"] == first["tokens"]
        assert _stats(run["stats"]) == _stats(first["stats"])
        assert run["tier"] == first["tier"]
        for a, b in zip(run["rows"], first["rows"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_hybrid_rank_holds_its_shard(runs, dtype):
    """A rank's parameter bytes: the whole model's less the other rank's
    half of every leaf its spec splits (in_proj, conv_w, out_proj, the
    shared block's projections, the vocabulary), most of the bytes."""
    ranks, _ = runs
    rc, _ = _config(dtype)
    whole = bridge.params_from_jax(_jax_params(ARCH, dtype), rc.model,
                                   device="cpu")
    specs = sharding.param_specs(whole)
    split_names = {n.split(".")[-1] for n, sp in specs.items()
                   if "model" in sp}
    assert {"in_proj", "conv_w", "out_proj", "wq", "w_down",
            "embedding"} <= split_names
    nbytes = {n: p.numel() * p.element_size()
              for n, p in whole.named_parameters()}
    total = sum(nbytes.values())
    split = sum(b for n, b in nbytes.items() if "model" in specs[n])
    assert split > total // 2
    for run in ranks:
        assert run[dtype]["param_bytes"] == total - split + split // TP
