"""Page-sharded multi-rank serving of the port against the reference, on
the CPU.

The port runs one process per rank (``repro_torch.launch.mesh``: gloo, a
``file://`` rendezvous under the test's temporary directory, never a fixed
TCP port, and a timeout on every spawn). Held here:

 * the copied ``ShardedTier`` against the reference's on one op sequence
   (writes, cross-rank restores tagged with the requesting rank, async
   handles, a hot-removed port): return values, every rank's op trace,
   every peer lane's, the counters and the snapshot equal (``got ==
   want``);
 * the port's engine at tp 2 (bf16 and int8 pages) and tp 4 (bf16) on
   smoke qwen3-1.7b, weights carried over from the reference's: greedy
   tokens equal to the port's one-rank engine's and to the JAX one-rank
   engine's, every rank's stats and tier traces equal, and the ranks'
   pages put together equal to the one-rank cache (bf16, 2e-2);
 * the same traffic through the JAX sharded engine at tp 2, in a
   subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=2``
   (as ``tests/test_system.py`` runs the reference's sharded decode):
   tokens, tier stats and the per-rank and peer-lane traces equal.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import MeshConfig, RunConfig, SHAPES
from repro.core.sharded_tier import ShardedTier as JShardedTier
from repro.core.tier import TierConfig as JTierConfig
from repro.models import model as JM
from repro.serving.config import ServeConfig as JServeConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.sim import engine as jsim
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MeshConfig as TMeshConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.core.sharded_tier import ShardedTier as TShardedTier
from repro_torch.core.tier import TierConfig as TTierConfig
from repro_torch.launch import mesh
from repro_torch.launch.serve import serve_waves
from repro_torch.serving.config import ServeConfig as TServeConfig
from repro_torch.sim import engine as tsim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3-1.7b"
PAGE = 16                      # 4 pages a slot: 2 or 1 per rank
KNOBS = dict(n_slots=4, max_seq=64, prefill_chunk=8,
             tier_topology=("dram", "ssd-fast"))
BF16_TOL = dict(atol=2e-2, rtol=2e-2)   # tests/test_kernel_parity.py
SPAWN_TIMEOUT_S = 240.0
# wall-clock stats, the only ones that may differ between engines and ranks
WALL_STATS = ("prefill_time_s",)


def _waves():
    """Six prompts over several prefill chunks and pages, then three of
    them again under new rids: restores from the (sharded) tier."""
    rng = np.random.default_rng(11)
    first = [(rid, rng.integers(1, 256, int(n)).tolist(), 6)
             for rid, n in enumerate(rng.integers(5, 40, 6))]
    again = [(100 + rid, prompt, 5) for rid, prompt, _ in first[:3]]
    return [first, again]


# ------------------------------------------------- the copied ShardedTier

def _nbytes(key):
    return 40_000 + 8192 * key


def _sharded_ops(tier_cls, cfg_cls, sim, n_ranks, placement, faults):
    fs = (sim.FaultSchedule((sim.hot_remove(2.5e5, 1),), seed=3)
          if faults else None)
    tier = tier_cls(n_ranks, cfg_cls(topology=("dram", "ssd-fast"),
                                     placement=placement), faults=fs)
    out = []
    for key in range(6):
        out.append(tier.write_entry(key, _nbytes(key)))
        tier.advance(50_000.0)
    for key, rank in ((1, 0), (3, 1), (1, 1), (1, 0), (4, 1), (1, 1),
                      (5, 0), (1, 0)):
        tier.speculative_read(key, _nbytes(key))
        tier.advance(20_000.0)
        out.append(tier.read_entry(key, _nbytes(key), req_rank=rank))
        out.append(tier.last_entry_failed)
    h = tier.read_entry_async(2, _nbytes(2), req_rank=1)
    out += [h.issue_wait_ns, h.in_flight_ns]
    w = tier.write_entry_async(("swap", 9), 65_536)
    out.append(w.issue_wait_ns)
    tier.write_entry(1, _nbytes(1))                   # a re-flush
    tier.advance(1e6)
    out += [tier.poll(h), tier.poll(w), tier.admit_store(),
            tier.inflight_ops(), tier.free_entry(0), tier.has_entry(3),
            tier.take_lost_keys(), tier.sr_hit_rate(),
            tier.store_occupancy(), tier.topo.now, tier.topo.ports_down()]
    return (out, tier.snapshot(), tier.counters, tier.port_stats(),
            [(t.ops, t.op_ns) for t in tier.ranks], tier.peer_ops,
            tier.peer_op_ns)


@pytest.mark.parametrize("n_ranks,placement,faults", [
    (2, "striped", False), (4, "hotness", False), (2, "learned", False),
    (2, "striped", True)], ids=["2-striped", "4-hotness", "2-learned",
                                "2-hot-remove"])
def test_sharded_tier_copy_matches_reference(n_ranks, placement, faults):
    want = _sharded_ops(JShardedTier, JTierConfig, jsim, n_ranks, placement,
                        faults)
    got = _sharded_ops(TShardedTier, TTierConfig, tsim, n_ranks, placement,
                       faults)
    assert got == want
    assert any(want[6])                    # the peer lanes carried shards


# -------------------------------------------------------- the engines

@pytest.fixture(scope="module")
def models(host_mesh):
    cfg = jreg.smoke(ARCH)
    rc = dataclasses.replace(RunConfig(model=cfg, shape=SHAPES["decode_32k"],
                                       mesh=MeshConfig()), kv_page_size=PAGE)
    with jax.set_mesh(host_mesh):
        params = JM.init_model(jax.random.PRNGKey(0), cfg)
    tcfg = treg.smoke(ARCH)
    trc = dataclasses.replace(TRunConfig(model=tcfg,
                                         shape=TSHAPES["decode_32k"],
                                         mesh=TMeshConfig()),
                              kv_page_size=PAGE)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    return cfg, rc, params, tcfg, trc, tparams


def _jax_tokens(cfg, rc, params, kv_quant):
    eng = JEngine(params, cfg, rc,
                  config=JServeConfig(kv_quant=kv_quant, **KNOBS))
    for wave in _waves():
        for rid, prompt, n in wave:
            eng.submit(JRequest(rid=rid, prompt=list(prompt),
                                max_new_tokens=n))
        eng.run(max_ticks=600)
    return {r.rid: [int(t) for t in r.generated] for r in eng.finished}


@pytest.fixture(scope="module")
def one_rank(models, host_mesh):
    """{kv_quant: (JAX one-rank tokens, the port's one-rank run)}."""
    cfg, rc, params, tcfg, trc, tparams = models
    out = {}
    for kv_quant in ("none", "int8"):
        with jax.set_mesh(host_mesh):
            jtoks = _jax_tokens(cfg, rc, params, kv_quant)
        out[kv_quant] = (jtoks, serve_waves(
            None, tparams, tcfg, trc, TServeConfig(kv_quant=kv_quant,
                                                   **KNOBS),
            _waves(), "cpu", keep_cache=True))
    return out


@pytest.fixture(scope="module")
def ranks(models, tmp_path_factory):
    """Each (tp, kv_quant) case spawned once: every rank's run."""
    _, _, _, tcfg, trc, tparams = models
    runs = {}

    def run(tp, kv_quant):
        if (tp, kv_quant) not in runs:
            config = TServeConfig(tp=tp, kv_quant=kv_quant, **KNOBS)
            runs[tp, kv_quant] = mesh.spawn(
                serve_waves, tp, (tparams, tcfg, trc, config, _waves(),
                                  "cpu", True),
                rendezvous_dir=str(tmp_path_factory.mktemp("rendezvous")),
                device="cpu", timeout_s=SPAWN_TIMEOUT_S)
        return runs[tp, kv_quant]
    return run


CASES = [(2, "none"), (2, "int8"), (4, "none")]
CASE_IDS = ["tp2-bf16", "tp2-int8", "tp4-bf16"]


@pytest.mark.parametrize("tp,kv_quant", CASES, ids=CASE_IDS)
def test_sharded_engine_tokens_match_one_rank(tp, kv_quant, ranks,
                                              one_rank):
    """Greedy tokens on every rank equal the port's one-rank engine's and
    the JAX one-rank engine's; the resubmits were restored."""
    jtoks, one = one_rank[kv_quant]
    assert one["tokens"] == jtoks
    for run in ranks(tp, kv_quant):
        assert run["tokens"] == jtoks
        assert run["restored"] == one["restored"] == [100, 101, 102]
        assert run["stats"]["mesh_ranks"] == tp


@pytest.mark.parametrize("tp,kv_quant", CASES, ids=CASE_IDS)
def test_sharded_engine_ranks_agree(tp, kv_quant, ranks):
    """Every rank schedules alike: equal stats (but wall time), and
    replicas of the tier charged alike (equal traces and counters)."""
    runs = ranks(tp, kv_quant)
    for run in runs[1:]:
        assert _stats(run) == _stats(runs[0])
        assert run["tier"] == runs[0]["tier"]
    assert runs[0]["stats"]["tier_peer_fetches"] > 0


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_engine_pages_match_one_rank(tp, ranks, one_rank):
    """Each rank holds its own page range of every slot; put together they
    are the one-rank engine's cache (bf16 pages, 2e-2: the decode's
    cross-rank combine rounds in another order)."""
    _, one = one_rank["none"]
    runs = ranks(tp, "none")
    for name, want in one["cache"].items():
        parts = [run["cache"][name] for run in runs]
        assert all(p.shape[2] == want.shape[2] // tp for p in parts)
        got = torch.cat(parts, dim=2)
        assert float(want.float().abs().max()) > 0.1
        torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


def _stats(run):
    return {k: v for k, v in run["stats"].items() if k not in WALL_STATS}


# ------------------------------------------ the JAX sharded engine at tp 2

_JAX_TP2 = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import dataclasses, json, sys
    import repro  # installs the jax < 0.5 compat shims
    import jax, numpy as np
    from repro.configs import registry
    from repro.configs.base import MeshConfig, RunConfig, SHAPES
    from repro.models import model as M
    from repro.serving.config import ServeConfig
    from repro.serving.engine import Request, ServingEngine

    waves, knobs, page = json.loads(sys.stdin.read())
    cfg = registry.smoke("qwen3-1.7b")
    rc = dataclasses.replace(RunConfig(model=cfg, shape=SHAPES["decode_32k"],
                                       mesh=MeshConfig()), kv_page_size=page)
    params = M.init_model(jax.random.PRNGKey(0), cfg)
    out = {}
    for kv_quant in ("none", "int8"):
        eng = ServingEngine(params, cfg, rc, config=ServeConfig(
            tp=2, kv_quant=kv_quant, **knobs))
        for wave in waves:
            for rid, prompt, n in wave:
                eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
            eng.run(max_ticks=600)
        t = eng.tier
        out[kv_quant] = {
            "tokens": {r.rid: [int(x) for x in r.generated]
                       for r in eng.finished},
            "stats": eng.stats.as_dict(),
            "tier": {"ranks": [(r.ops, r.op_ns) for r in t.ranks],
                     "peer": list(zip(t.peer_ops, t.peer_op_ns)),
                     "shard_counters": dict(t.shard_counters),
                     "snapshot": t.snapshot()}}
    print("JAX_TP2 " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_tp2():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env.pop("XLA_FLAGS", None)
    knobs = dict(KNOBS, tier_topology=list(KNOBS["tier_topology"]))
    res = subprocess.run([sys.executable, "-c", _JAX_TP2],
                         input=json.dumps([_waves(), knobs, PAGE]),
                         capture_output=True, text=True, env=env,
                         timeout=600)
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("JAX_TP2 ")]
    assert line, res.stderr[-3000:]
    return json.loads(line[0][len("JAX_TP2 "):])


def _as_json(x):
    """``x`` as the subprocess's JSON gives it back (tuples as lists,
    dict keys as strings, floats by their repr)."""
    return json.loads(json.dumps(x))


@pytest.mark.parametrize("kv_quant", ["none", "int8"], ids=["bf16", "int8"])
def test_sharded_engine_matches_jax_sharded(kv_quant, ranks, jax_tp2):
    """tp 2: the port's rank 0 against the reference's sharded engine on
    the same traffic and weights: tokens, every stat (but wall time),
    every rank's and peer lane's trace and the shard counters equal."""
    want = jax_tp2[kv_quant]
    run = ranks(2, kv_quant)[0]
    assert _as_json(run["tokens"]) == want["tokens"]
    assert _as_json(_stats(run)) == _stats(want)
    assert _as_json(run["tier"]) == want["tier"]
    assert want["stats"]["tier_peer_fetches"] > 0
