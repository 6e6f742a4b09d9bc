"""The port's four examples (``examples/*_torch.py``) against the
reference's, on the CPU.

Each example keeps its work in a function; the tests call it with the
reference's weights carried across by ``bridge.params_from_jax``:

* ``serve_kv_offload_torch``: both acts -- seven requests and two cold-tier
  restores on an SSD tier, then a two-port tier whose port 1 is removed
  mid-decode -- against the JAX engine driven as
  ``examples/serve_kv_offload.py`` drives it: every request's tokens, the
  engines' stats, store and tier snapshots equal (``got == want``);
* ``quickstart_torch``: five training steps of smoke qwen3-1.7b in f32
  on the reference's tokens, the losses at the f32 tolerance of
  ``tests/test_kernel_parity.py``, then the greedy decode's tokens;
* ``cxl_sim_explore_torch``: its table equals the reference script's at
  small ``--ops`` (both scripts run with one ``PYTHONHASHSEED``: the
  workloads' traces are seeded by ``hash(name)``);
* ``train_lm_torch``: the loss falls over 20 steps, and a resume from the
  checkpoint replays the saved step's batch and goes on from there.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import MeshConfig, RunConfig, SHAPES
from repro.launch import steps as jsteps
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.parallel import sharding as shlib
from repro.serving.config import ServeConfig as JServeConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import registry as treg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = dict(atol=3e-5, rtol=3e-5)


def _example(name):
    """``examples/<name>.py`` as a module."""
    path = os.path.join(REPO, "examples", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's smoke models on one intra-op thread: their ops are
    tiny, and a pool of threads per process spins against the other test
    workers' pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


# ------------------------------------------------------- serve_kv_offload

def _jax_serve(host_mesh):
    """The reference example's two acts, its engine kept per act."""
    cfg = jreg.smoke("gemma-2b")
    rc = RunConfig(model=cfg, shape=SHAPES["decode_32k"], mesh=MeshConfig())
    acts = {}
    for act, sc in (("offload", JServeConfig(
            n_slots=3, max_seq=64, prefill_chunk=8, tier_media="ssd-fast")),
                    ("hot_remove", JServeConfig(
            n_slots=3, max_seq=64, prefill_chunk=8, cxl_async=True,
            preempt_policy="recompute", tier_topology=("dram", "ssd-fast"),
            tier_faults=(("hot_remove", 1.0e6, 1),)))):
        with jax.set_mesh(host_mesh):
            params = JM.init_model(jax.random.PRNGKey(0), cfg)
            engine = JEngine(params, cfg, rc, config=sc)
            handles = [engine.submit(JRequest(rid=rid, prompt=[rid + 1, 5, 9],
                                              max_new_tokens=8))
                       for rid in range(7)]
            engine.run()
            for rid in (0, 3):
                handles.append(engine.submit(JRequest(
                    rid=rid, prompt=[rid + 1, 5, 9], max_new_tokens=4)))
            finished = engine.run()
        acts[act] = {"engine": engine, "handles": handles,
                     "finished": finished}
    return params, acts


@pytest.fixture(scope="module")
def served(host_mesh):
    params, want = _jax_serve(host_mesh)
    cfg = treg.smoke("gemma-2b")
    got = _example("serve_kv_offload_torch").serve_kv_offload(
        bridge.params_from_jax(_np_tree(params), cfg, device="cpu"),
        cfg=cfg, device="cpu", log=lambda *_: None)
    return got, want


def _requests(act):
    return [(r.rid, r.restored, list(r.generated)) for r in act["finished"]]


@pytest.mark.parametrize("act", ["offload", "hot_remove"])
def test_serve_kv_offload_tokens_equal_reference(served, act):
    got, want = served
    assert _requests(got[act]) == _requests(want[act])
    assert [h.result() for h in got[act]["handles"]] == \
        [h.result() for h in want[act]["handles"]]
    assert len(got[act]["finished"]) == 9
    assert all(h.done() for h in got[act]["handles"])


TIER_STATS = {"offload": ("prefill_dispatches", "decode_dispatches",
                          "decode_tokens", "flushes", "prefix_hits",
                          "restore_stall_ns", "flushes_deferred"),
              "hot_remove": ("tier_lost_entries", "tier_lost_bytes",
                             "recoveries", "tier_ports_down", "flushes",
                             "decode_tokens")}


@pytest.mark.parametrize("act", ["offload", "hot_remove"])
def test_serve_kv_offload_tier_stats_equal_reference(served, act):
    got, want = served
    g, w = got[act]["engine"], want[act]["engine"]
    assert {k: g.stats[k] for k in TIER_STATS[act]} == \
        {k: w.stats[k] for k in TIER_STATS[act]}
    assert g.tier.snapshot() == w.tier.snapshot()
    assert (g.store.bytes, g.store.evictions, g.flusher.suppressed) == \
        (w.store.bytes, w.store.evictions, w.flusher.suppressed)
    restored = [r.rid for r in got[act]["finished"] if r.restored]
    if act == "offload":
        assert restored == [0, 3] and got[act]["extra_prefills"] == 0
        assert g.stats["restore_stall_ns"] > 0
    else:
        assert g.stats["tier_lost_entries"] > 0
        assert g.stats["tier_ports_down"] == 1


# ------------------------------------------------------------- quickstart

def test_quickstart_losses_equal_reference(host_mesh):
    """The reference example's five steps (and its decode) in f32 on its
    own weights and tokens, against ``quickstart_torch`` on the same."""
    cfg = dataclasses.replace(jreg.smoke("qwen3-1.7b"), dtype="float32")
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=4,
                                seq_len=64)
    rc = RunConfig(model=cfg, shape=shape, mesh=MeshConfig(),
                   sr_prefetch_depth=1, ds_enabled=True)
    with jax.set_mesh(host_mesh):
        params = JM.init_model(jax.random.PRNGKey(0), cfg)
        np_params = _np_tree(params)
        opt_cfg = jadamw.AdamWConfig(learning_rate=1e-2, warmup_steps=0)
        step = jax.jit(jsteps.build_train_step(cfg, rc, opt_cfg))
        state = jsteps.TrainState(params, jadamw.init(params, opt_cfg), None)
        toks = jax.random.randint(jax.random.PRNGKey(1), (4, 64), 0,
                                  cfg.vocab_size)
        batch = {"tokens": toks, "labels": toks}
        want = []
        for _ in range(5):
            state, metrics = step(state, batch)
            want.append(float(metrics["loss"]))
        specs = shlib.param_specs(jax.eval_shape(lambda: params))
        cache = JM.cache_init(cfg, rc, 2, max_seq=32)
        tok = jax.numpy.array([[1], [2]], jax.numpy.int32)
        decoded = []
        for _ in range(3):
            logits, cache = JM.decode_step(state.params, cfg, rc, tok, cache,
                                           specs)
            tok = logits.argmax(-1).astype(jax.numpy.int32)
            decoded.append(np.asarray(tok).ravel().tolist())
    tcfg = dataclasses.replace(treg.smoke("qwen3-1.7b"), dtype="float32")
    got = _example("quickstart_torch").quickstart(
        bridge.params_from_jax(np_params, tcfg, device="cpu"), cfg=tcfg,
        tokens=torch.from_numpy(np.array(toks)), device="cpu",
        n_ops=500, log=lambda *_: None)
    np.testing.assert_allclose(got["losses"], want, **F32_TOL)
    assert got["losses"][-1] < got["losses"][0]
    assert got["decoded"] == decoded
    assert set(got["sim"]) == {"uvm", "cxl", "cxl-sr over cxl"}


# -------------------------------------------------------- cxl_sim_explore

def test_cxl_sim_explore_table_equals_reference():
    """Both scripts at 400 ops on bfs, one hash seed: the same table."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               PYTHONHASHSEED="0", JAX_PLATFORMS="cpu")
    outs = []
    for script in ("cxl_sim_explore.py", "cxl_sim_explore_torch.py"):
        run = subprocess.run(
            [sys.executable, os.path.join(REPO, "examples", script),
             "--workload", "bfs", "--ops", "400"], env=env,
            capture_output=True, text=True, timeout=300)
        assert run.returncode == 0, run.stderr[-2000:]
        # the last line ends with the run's own seconds
        outs.append(run.stdout.strip().splitlines()[:-1])
    assert outs[1] == outs[0]
    assert len(outs[0]) == 11 and outs[0][2].split()[0] == "config"


# ------------------------------------------------------------- train_lm

def test_train_lm_lowers_the_loss_and_resumes(tmp_path):
    """20 steps of smoke qwen3-1.7b lower the loss; a resume of 2 more
    restores the checkpoint of step 19, replays that step's batch, and
    goes on from there."""
    train_lm = _example("train_lm_torch").train_lm
    kw = dict(ckpt=str(tmp_path / "ckpt"), device="cpu", global_batch=4,
              seq_len=32, log_every=100)
    first = train_lm("qwen3-1.7b", steps=20, **kw)
    losses = [h["loss"] for h in first["history"]]
    assert losses[-1] < losses[0]
    again = train_lm("qwen3-1.7b", steps=2, resume=True, **kw)
    assert [h["step"] for h in again["history"]] == [19, 20]
    assert np.isfinite([h["loss"] for h in again["history"]]).all()
