"""Expert-parallel MoE serving of the port at tp 2 against the reference's
sharded engine, on the CPU.

Smoke granite-moe-1b-a400m (8 experts, top-2; bf16 weights and pages, as
``tests/test_torch_moe.py``'s engine gates) served by the port on two
spawned gloo ranks (``launch.mesh.spawn``), each holding its shard of the
weights (``parallel.sharding``) and its half of every slot's pages, and by
the reference's ``ServingEngine(tp=2)`` in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=2`` on the same weights
(the subprocess draws them and hands them over) and traffic. Held: equal
greedy tokens, every stat but wall time, every rank's and peer lane's tier
trace and the shard counters; the two ranks agree; the resubmits were
restored. The traffic takes the expert-parallel prefill (even chunks),
its one-device fallback (odd final chunks) and drops pairs at prefill
(asserted, counted on each rank by ``moe_apply_ep_ref`` on the inputs the
layers saw); the decode ticks drop none at tp 2.
"""
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
from repro_torch.models import moe
from repro_torch.serving.config import ServeConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "granite-moe-1b-a400m"
PAGE, TP = 16, 2
KNOBS = dict(n_slots=4, max_seq=64, prefill_chunk=8,
             tier_topology=("dram", "ssd-fast"))
SPAWN_TIMEOUT_S = 240.0
WALL_STATS = ("prefill_time_s",)


def _waves():
    """Six prompts of 5-39 tokens (chunks of 8, odd last chunks among
    them), then three of them again under new rids: restores."""
    rng = np.random.default_rng(7)
    first = [(rid, rng.integers(1, 256, int(n)).tolist(), 6)
             for rid, n in enumerate(rng.integers(5, 40, 6))]
    again = [(100 + rid, prompt, 5) for rid, prompt, _ in first[:3]]
    return [first, again]


def _config():
    return (RunConfig(model=treg.smoke(ARCH), shape=SHAPES["decode_32k"],
                      mesh=MeshConfig(), kv_page_size=PAGE),
            ServeConfig(tp=TP, **KNOBS))


_JAX_TP2 = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import dataclasses, json, sys
    import repro  # installs the jax < 0.5 compat shims
    import jax, numpy as np
    from repro.configs import registry
    from repro.configs.base import MeshConfig, RunConfig, SHAPES
    from repro.models import model as M
    from repro.parallel.sharding import _path_str
    from repro.serving.config import ServeConfig
    from repro.serving.engine import Request, ServingEngine

    waves, knobs, page, path = json.loads(sys.stdin.read())
    cfg = registry.smoke("granite-moe-1b-a400m")
    rc = dataclasses.replace(RunConfig(model=cfg, shape=SHAPES["decode_32k"],
                                       mesh=MeshConfig()), kv_page_size=page)
    params = M.init_model(jax.random.PRNGKey(0), cfg)
    np.savez(path, **{_path_str(p): np.asarray(a) for p, a in
                      jax.tree_util.tree_flatten_with_path(params)[0]})
    eng = ServingEngine(params, cfg, rc, config=ServeConfig(tp=2, **knobs))
    for wave in waves:
        for rid, prompt, n in wave:
            eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
        eng.run(max_ticks=600)
    t = eng.tier
    print("JAX_TP2 " + json.dumps({
        "tokens": {r.rid: [int(x) for x in r.generated]
                   for r in eng.finished},
        "stats": eng.stats.as_dict(),
        "tier": {"ranks": [(r.ops, r.op_ns) for r in t.ranks],
                 "peer": list(zip(t.peer_ops, t.peer_op_ns)),
                 "shard_counters": dict(t.shard_counters),
                 "snapshot": t.snapshot()}}))
""")


def _tree(flat):
    """The reference's pytree from its flattened ``"a/b/c"`` paths."""
    out = {}
    for path, a in flat.items():
        node = out
        *head, last = path.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = a
    return out


@pytest.fixture(scope="module")
def jax_tp2(tmp_path_factory):
    """The reference's sharded run and its weights (numpy leaves)."""
    path = str(tmp_path_factory.mktemp("granite") / "params.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    knobs = dict(KNOBS, tier_topology=list(KNOBS["tier_topology"]))
    res = subprocess.run([sys.executable, "-c", _JAX_TP2],
                         input=json.dumps([_waves(), knobs, PAGE, path]),
                         capture_output=True, text=True, env=env,
                         timeout=600)
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("JAX_TP2 ")]
    assert line, res.stderr[-3000:]
    with np.load(path) as flat:
        params = _tree(dict(flat))
    return json.loads(line[0][len("JAX_TP2 "):]), params


def _serve_rank(group, np_params, waves):
    """One rank: its shard of the reference's weights, the traffic served
    with every prefill MoE's input routed a second time by
    ``moe_apply_ep_ref`` to count the pairs it drops."""
    rc, config = _config()
    cfg = rc.model
    params = bridge.params_from_jax(np_params, cfg, device="cpu",
                                    rank=group.rank, n_ranks=group.size)
    seen = {"chunks": 0, "odd_chunks": 0, "dispatch": 0, "expert": 0}
    inner = moe.moe_apply_ep

    def counted(m, cfg, x, **kw):
        _, dropped = moe.moe_apply_ep_ref(m, cfg, x, group.size)
        seen["chunks"] += 1
        seen["odd_chunks"] += x.shape[1] % group.size
        for stage, n in dropped.items():
            seen[stage] += n
        return inner(m, cfg, x, **kw)
    moe.moe_apply_ep = counted
    try:
        out = serve_waves(group, params, cfg, rc, config, waves, "cpu")
    finally:
        moe.moe_apply_ep = inner
    out["prefill_moe"] = seen
    out["param_bytes"] = sum(p.numel() * p.element_size()
                             for p in params.parameters())
    return out


@pytest.fixture(scope="module")
def ranks(jax_tp2, tmp_path_factory):
    _, np_params = jax_tp2
    return mesh.spawn(_serve_rank, TP, (np_params, _waves()),
                      rendezvous_dir=str(tmp_path_factory.mktemp("rdv")),
                      device="cpu", timeout_s=SPAWN_TIMEOUT_S)


def _stats(stats):
    return {k: v for k, v in stats.items() if k not in WALL_STATS}


def _as_json(x):
    return json.loads(json.dumps(x))


def test_moe_engine_matches_jax_sharded(ranks, jax_tp2):
    """Rank 0 against the reference's sharded engine: tokens, every stat
    but wall time, every rank's and peer lane's trace, the counters."""
    want, _ = jax_tp2
    run = ranks[0]
    assert _as_json(run["tokens"]) == want["tokens"]
    assert _as_json(_stats(run["stats"])) == _stats(want["stats"])
    assert _as_json(run["tier"]) == want["tier"]
    assert run["restored"] == [100, 101, 102]
    assert want["stats"]["tier_peer_fetches"] > 0


def test_moe_engine_ranks_agree(ranks):
    """Both ranks serve alike (tokens, stats but wall time, tier traces)
    and each holds half of the split weights."""
    for run in ranks[1:]:
        assert run["tokens"] == ranks[0]["tokens"]
        assert _stats(run["stats"]) == _stats(ranks[0]["stats"])
        assert run["tier"] == ranks[0]["tier"]
        assert run["param_bytes"] == ranks[0]["param_bytes"]


def test_moe_traffic_takes_every_form(ranks):
    """The prefill ran even chunks (the expert-parallel form) and odd ones
    (the fallback), and dropped pairs; the stats count the chunks."""
    for run in ranks:
        seen = run["prefill_moe"]
        n_layers = treg.smoke(ARCH).n_layers
        assert seen["chunks"] == n_layers * run["stats"]["prefill_dispatches"]
        assert 0 < seen["odd_chunks"] < seen["chunks"]
        assert seen["dispatch"] + seen["expert"] > 0
