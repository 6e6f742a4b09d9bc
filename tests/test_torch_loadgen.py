"""The port's open-loop serving path against the reference, on the CPU.

``repro_torch.serving.loadgen`` is a copy of ``repro.serving.loadgen``;
here both engines are driven by it through the modes only the open loop
reaches: async tier I/O, swap and recompute preemption, priorities,
transient faults and RECOVERING, a hot-removed port, learned placement,
closed admission, idle-time advance and int8 pages. Smoke qwen3-1.7b in
f32 (no argmax near-tie can flip), the port's weights carried over
through ``repro_torch.bridge``, the same seeded trace for both engines.
Equal exactly (``got == want``): every arrival's tokens and simulated
timings, every ``LoadMetrics`` field, the queue-depth samples, every
stat but the wall-clock ``prefill_time_s``, and the tier's snapshot,
``ops`` and ``op_ns``. Each case runs each engine once per module.

Also: the traces and ``LoadConfig``'s checks against the reference's;
preemption invisible in a request's greedy tokens (swap and recompute,
``tests/test_scheduler.py``'s gate on the port); one arrival served
continuous, closed and submitted directly alike (``tests/
test_loadgen.py``'s); the ``--load`` CLI's summary against the
reference's ``serve(load=)``.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.configs.base import MeshConfig, RunConfig, SHAPES
from repro.launch import serve as jserve
from repro.serving import loadgen as jloadgen
from repro.serving.config import ServeConfig as JServeConfig
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MeshConfig as TMeshConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.serving import loadgen as tloadgen
from repro_torch.serving import scheduler as tsched
from repro_torch.serving.config import ServeConfig as TServeConfig
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.sim.engine import (PAGE_READ_ASYNC, PAGE_WRITE_ASYNC,
                                    replay_page_trace)

ARCH = "qwen3-1.7b"
PAGE = 16                      # 4 pages a slot
BASE = dict(n_slots=4, max_seq=64, prefill_chunk=8,
            tier_topology=("dram", "ssd-fast"))
# tests/test_faults.py's trace (16 bursty arrivals, 8 shared prompts), its
# prompt ids drawn inside the smoke vocabulary
LOAD = dict(n_arrivals=16, rate_rps=8000.0, arrival="bursty", n_prompts=8,
            prompt_len_choices=(8, 16), max_new_choices=(4, 8), vocab=256,
            seed=0)
# a quarter of the arrivals interactive, over a trace long enough that
# they queue behind full slots of batch work: 3 preemptions
PREEMPT = dict(LOAD, n_arrivals=24, hi_prio_frac=0.25, seed=2)
CASES = {
    "a-poisson-sync": (dict(LOAD, arrival="poisson"), {}),
    "b-bursty-async-swap": (PREEMPT, dict(cxl_async=True,
                                          preempt_policy="swap")),
    "c-bursty-async-recompute": (PREEMPT, dict(cxl_async=True,
                                               preempt_policy="recompute")),
    "d-closed": (LOAD, dict(admit_mode="closed")),
    # tests/test_faults.py:346 and :365
    "e-transient-faults": (LOAD, dict(
        cxl_async=True, preempt_policy="recompute", fault_seed=1,
        tier_faults=(("transient", 0.0, 0, 0.97, 4.0e6),
                     ("transient", 0.0, 1, 0.97, 4.0e6)))),
    "f-hot-remove": (LOAD, dict(cxl_async=True, preempt_policy="recompute",
                                tier_faults=(("hot_remove", 1.5e6, 1),))),
    "g-learned-placement": (LOAD, dict(tier_placement="learned",
                                       cxl_async=True)),
    "h-int8-async-swap": (PREEMPT, dict(cxl_async=True,
                                        preempt_policy="swap",
                                        kv_quant="int8")),
}
ASPECTS = ("tokens", "timings", "metrics", "depths", "stats", "tier")
MAX_TICKS = 4000
# the one stat that is wall-clock time, not simulated
WALL_STATS = ("prefill_time_s",)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's smoke engine on one intra-op thread: its ops are tiny,
    and a pool of threads per process spins against the other test
    workers' pools."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The port's smoke weights from seed 0, and the same weights as the
    reference's tree (``bridge.params_to_numpy``)."""
    import jax.numpy as jnp
    cfg = dataclasses.replace(jreg.smoke(ARCH), dtype="float32")
    rc = RunConfig(model=cfg, shape=SHAPES["decode_32k"], mesh=MeshConfig(),
                   kv_page_size=PAGE)
    tcfg = dataclasses.replace(treg.smoke(ARCH), dtype="float32")
    trc = TRunConfig(model=tcfg, shape=TSHAPES["decode_32k"],
                     mesh=TMeshConfig(), kv_page_size=PAGE)
    tparams = TM.init_model(tcfg, seed=0, device="cpu")
    params = jax.tree_util.tree_map(jnp.asarray,
                                    bridge.params_to_numpy(tparams, tcfg))
    return cfg, rc, params, tcfg, trc, tparams


def _share_steps(eng, compiled):
    """Give the reference engine ``eng`` the jitted decode and prefill steps
    of an earlier case's engine whose traced functions are the same ones
    (the same model, run config, slots, sampling, specs and mesh), else
    keep its own in ``compiled``. A case changes only the scheduling and
    the tier around those steps, and each new engine would compile its
    own: the cases' seconds are mostly compilation."""
    sig = (eng.cfg, eng._hot_rc, eng.n_slots, eng.temperature, eng.pspecs,
           eng.mesh)
    for other, steps in compiled:
        if other == sig:
            eng._decode_fn, eng._prefill_fn = steps
            return
    compiled.append((sig, (eng._decode_fn, eng._prefill_fn)))


@pytest.fixture(scope="module")
def runs(models, host_mesh):
    """{case: (the port's run, the reference's)}, each run once."""
    cfg, rc, params, tcfg, trc, tparams = models
    done, compiled = {}, []

    def run(case):
        if case not in done:
            load, knobs = CASES[case]
            jload = jloadgen.LoadConfig(**load)
            with jax.set_mesh(host_mesh):
                eng = JEngine(params, cfg, rc,
                              config=JServeConfig(**BASE, **knobs))
                _share_steps(eng, compiled)
                handles, depths = jloadgen.drive_open_loop(
                    eng, jloadgen.make_trace(jload), max_ticks=MAX_TICKS)
                want = tserve.open_loop_record(
                    eng, handles, depths,
                    jloadgen.summarize(eng, handles, depths, jload))
            got = tserve.serve_open_loop(
                None, tparams, tcfg, trc, TServeConfig(**BASE, **knobs),
                tloadgen.LoadConfig(**load), "cpu", max_ticks=MAX_TICKS)
            done[case] = got, want
        return done[case]
    return run


# ------------------------------------------------------------ the traces

@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("arrival", ["poisson", "bursty"])
def test_trace_matches_reference(arrival, seed):
    kw = dict(n_arrivals=64, arrival=arrival, hi_prio_frac=0.3, seed=seed,
              n_prompts=8)
    got = tloadgen.make_trace(tloadgen.LoadConfig(**kw))
    want = jloadgen.make_trace(jloadgen.LoadConfig(**kw))
    assert [dataclasses.astuple(a) for a in got] == \
        [dataclasses.astuple(a) for a in want]
    assert any(a.priority for a in got)
    assert len({a.prompt_id for a in got}) > 1


@pytest.mark.parametrize("zipf_s", [0.5, 1.1, 2.0])
def test_zipf_probs_match_reference(zipf_s):
    kw = dict(n_prompts=17, zipf_s=zipf_s)
    got = tloadgen.zipf_probs(tloadgen.LoadConfig(**kw))
    want = jloadgen.zipf_probs(jloadgen.LoadConfig(**kw))
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("bad", [
    dict(arrival="uniform"), dict(rate_rps=0.0), dict(zipf_s=-1.0),
    dict(n_prompts=0), dict(n_arrivals=0),
    dict(arrival="bursty", burst_factor=1.0),
    dict(arrival="bursty", burst_len=0), dict(prompt_len_choices=()),
    dict(max_new_choices=())])
def test_load_config_refuses_as_reference(bad):
    with pytest.raises(ValueError) as want:
        jloadgen.LoadConfig(**bad)
    with pytest.raises(ValueError) as got:
        tloadgen.LoadConfig(**bad)
    assert str(got.value) == str(want.value)
    assert tloadgen.LoadConfig.field_names() == \
        jloadgen.LoadConfig.field_names()


# ------------------------------------- the open loop against the JAX engine

def _stats(run):
    return {k: v for k, v in run["stats"].items() if k not in WALL_STATS}


@pytest.mark.parametrize("aspect", ASPECTS)
@pytest.mark.parametrize("case", list(CASES))
def test_open_loop_matches_reference(case, aspect, runs):
    got, want = runs(case)
    if aspect == "tokens":
        assert got["done"] == want["done"]
        assert got["tokens"] == want["tokens"]
    elif aspect == "stats":
        assert _stats(got) == _stats(want)
    else:
        assert got[aspect] == want[aspect]


@pytest.mark.parametrize("case", list(CASES))
def test_open_loop_case_reaches_its_mode(case, runs):
    """Each case really took the mode it names, finished every arrival,
    and its tier's op_ns replays against the scalar oracle
    (``tests/test_faults.py``'s 1%)."""
    got, _ = runs(case)
    m, st = got["metrics"], got["stats"]
    n = CASES[case][0]["n_arrivals"]
    assert m["arrivals"] == m["completed"] == n and m["lost_requests"] == 0
    assert all(got["done"].values()) and st["prefix_hits"] >= 1
    assert len(got["depths"]) > 0
    if CASES[case][0]["arrival"] == "bursty":
        assert max(got["depths"]) >= 1     # a burst queued
    knobs = CASES[case][1]
    if knobs.get("preempt_policy") in ("swap", "recompute") \
            and "tier_faults" not in knobs:
        assert m["preemptions"] >= 1
    if knobs.get("preempt_policy") == "swap":
        assert st["swap_out_bytes"] > 0
        assert st["swap_in_bytes"] == st["swap_out_bytes"]
    if knobs.get("preempt_policy") == "recompute":
        assert st["swap_out_bytes"] == 0
    kinds = {op[-3] for op in got["tier"]["ops"]}   # (port,) kind, addr, n
    assert bool(kinds & {PAGE_READ_ASYNC, PAGE_WRITE_ASYNC}) == \
        bool(knobs.get("cxl_async"))
    if case == "e-transient-faults":
        assert st["tier_fault_ops"] > 0 and st["recoveries"] >= 1
        assert m["recoveries"] == st["recoveries"]
    if case == "f-hot-remove":
        assert st["tier_ports_down"] == 1
    if case == "g-learned-placement":
        assert got["tier"]["snapshot"]["placement"] == "learned"
    if case == "h-int8-async-swap":
        # int8 pages: the swap and flush charges see the quantized bytes
        bf16 = runs("b-bursty-async-swap")[0]["stats"]["swap_out_bytes"]
        assert st["swap_out_bytes"] < 0.3 * bf16
    tc = TServeConfig(**BASE, **knobs).make_tier().cfg
    want_ns = replay_page_trace(
        got["tier"]["ops"], media=tc.media_name, topology=tc.port_medias,
        sr=tc.sr_enabled, ds=tc.ds_enabled, req_bytes=tc.req_bytes,
        dram_cache_bytes=tc.dram_cache_bytes, max_inflight=tc.max_inflight,
        faults=tc.faults)
    np.testing.assert_allclose(np.asarray(got["tier"]["op_ns"]), want_ns,
                               rtol=0.01)


# --------------------------------------------- preemption, on the port

def _port_engine(tparams, tcfg, trc, **knobs):
    return TEngine(tparams, tcfg, trc, device="cpu",
                   config=TServeConfig(**knobs))


@pytest.mark.parametrize("policy", ["swap", "recompute"])
def test_preempted_request_tokens_identical(policy, models):
    """A preempted request, swapped out (or dropped and re-prefilled) and
    resumed, generates exactly the greedy tokens of an uninterrupted solo
    run (``tests/test_scheduler.py:141`` on the port)."""
    tcfg, trc, tparams = models[3:]
    prompt = [9, 8, 7, 6, 5]
    solo = _port_engine(tparams, tcfg, trc, n_slots=1, max_seq=32,
                        prefill_chunk=4)
    solo.submit(TRequest(rid=0, prompt=prompt, max_new_tokens=8))
    ref = solo.run(max_ticks=100)[0].generated
    eng = _port_engine(tparams, tcfg, trc, n_slots=1, max_seq=32,
                       prefill_chunk=4, tier_media="ssd-fast",
                       cxl_async=True, preempt_policy=policy)
    victim = TRequest(rid=0, prompt=prompt, max_new_tokens=8, priority=0)
    eng.submit(victim)
    eng.step()
    eng.step()                                 # the victim decodes
    eng.submit(TRequest(rid=1, prompt=[1, 2, 3], max_new_tokens=2,
                        priority=5))
    eng.step()
    assert victim.state == (tsched.SWAPPED if policy == "swap"
                            else tsched.PREEMPTED)
    outs = {r.rid: r.generated for r in eng.run(max_ticks=400)}
    assert eng.stats["preemptions"] >= 1
    assert outs[0] == ref
    assert len(outs[1]) == 2
    if policy == "swap":
        assert eng.stats["swap_out_bytes"] > 0
        assert eng.stats["swap_in_bytes"] == eng.stats["swap_out_bytes"]
    else:
        assert eng.stats["swap_out_bytes"] == 0


def test_one_arrival_continuous_closed_and_direct_alike(models):
    """One arrival served continuous, served closed and submitted directly
    gives the same tokens (``tests/test_loadgen.py:157`` on the port)."""
    tcfg, trc, tparams = models[3:]
    lc = tloadgen.LoadConfig(n_arrivals=1, prompt_len_choices=(8,),
                             max_new_choices=(6,), vocab=tcfg.vocab_size,
                             seed=11)
    trace = tloadgen.make_trace(lc)
    tokens = {}
    for mode in ("continuous", "closed"):
        eng = _port_engine(tparams, tcfg, trc, n_slots=2, max_seq=64,
                           prefill_chunk=8, admit_mode=mode)
        handles, depths = tloadgen.drive_open_loop(eng, trace)
        m = tloadgen.summarize(eng, handles, depths, lc)
        assert m.completed == m.arrivals == 1
        tokens[mode] = handles[0].result()
    assert tokens["continuous"] == tokens["closed"]
    eng = _port_engine(tparams, tcfg, trc, n_slots=2, max_seq=64,
                       prefill_chunk=8)
    a = trace[0]
    h = eng.submit(TRequest(rid=a.rid, prompt=list(a.prompt),
                            max_new_tokens=a.max_new))
    eng.run()
    assert h.result() == tokens["continuous"] and len(h.result()) == 6


def test_advance_time_charges_the_idle_gap(models):
    """An idle gap moves the engine's clock and the tier's by the gap and
    lets a background flush land, with no decode tick charged."""
    tcfg, trc, tparams = models[3:]
    eng = _port_engine(tparams, tcfg, trc, n_slots=2, max_seq=64,
                       prefill_chunk=8, tier_media="ssd-slow",
                       cxl_async=True)
    eng.submit(TRequest(rid=0, prompt=[3, 4, 5], max_new_tokens=3))
    eng.run()
    steps, clock, now = (eng.stats["steps"], eng.clock_ns,
                         eng.tier.topo.now)
    eng.advance_time(2.5e6)
    assert eng.stats["steps"] == steps
    assert eng.clock_ns == clock + 2.5e6
    assert eng.tier.topo.now >= now + 2.5e6
    assert eng.tier.inflight_ops() == 0 and eng._async_writes == []


def test_serve_ranks_carries_the_load_to_every_rank():
    """``serve_ranks(load=)`` at tp 2: both ranks play the trace and
    complete every arrival with the one-rank ``serve(load=)``'s tokens."""
    config = TServeConfig(n_slots=4, max_seq=64, prefill_chunk=8,
                          tier_topology=("dram", "ssd-fast"), cxl_async=True)
    load = tloadgen.LoadConfig(**dict(LOAD, n_arrivals=6))
    ranks = tserve.serve_ranks(ARCH, smoke=True, device="cpu",
                               config=dataclasses.replace(config, tp=2),
                               load=load, timeout_s=240.0)
    _, finished = tserve.serve(ARCH, smoke=True, device="cpu",
                               config=config, load=load, verbose=False)
    want = {r.rid: list(r.generated) for r in finished}
    assert sorted(want) == list(range(6))
    assert ranks == [want, want]


# ---------------------------------------- ids past the embedding table

@pytest.mark.parametrize("arch", [ARCH, "musicgen-large"])
def test_embedding_fills_nan_past_the_table(arch):
    """An id past the table embeds as a row of NaN, as the reference's
    ``jnp.take`` (default mode: fill) gives it; other ids as before. The
    port's table lookup raised an IndexError there, which stopped the
    ``--load`` CLI on a smoke model (LoadConfig's vocabulary 1024 past
    the smoke vocabulary 256)."""
    import jax.numpy as jnp
    import torch

    from repro.models import layers as jlayers
    from repro_torch.models import layers as tlayers
    cfg = treg.smoke(arch)
    rows = (cfg.n_codebooks if cfg.family == "audio" else 1) * \
        cfg.vocab_size
    table = np.random.default_rng(0).standard_normal(
        (rows, cfg.d_model)).astype(np.float32)
    shape = ((2, cfg.n_codebooks, 5) if cfg.family == "audio" else (2, 5))
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, shape)
    ids[0, ..., 1] = cfg.vocab_size + 3          # past its codebook's slice
    ids[1, ..., 4] = 4 * rows                    # past the whole table
    want = np.asarray(jlayers.embed_apply(
        {"embedding": jnp.asarray(table)}, jreg.smoke(arch),
        jnp.asarray(ids, jnp.int32)))
    got = tlayers.embed_apply(tlayers.Embed(torch.from_numpy(table)), cfg,
                              torch.from_numpy(ids).to(torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isnan(want[1, 4]).all() and np.isfinite(want[1, :4]).all()


# ------------------------------------------------------------- the CLI

def test_load_cli_prints_the_reference_summary(capsys, host_mesh):
    """``--load --arrivals 8`` on smoke qwen3-1.7b prints the reference's
    ``serve(load=)`` summary on the same ``LoadConfig``. The CLI's trace
    draws prompt ids from ``LoadConfig``'s default vocabulary (1024), past
    the smoke model's 256: both embeddings give those ids NaN rows."""
    with jax.set_mesh(host_mesh):
        jserve.serve(ARCH, smoke=True, load=jloadgen.LoadConfig(
            n_arrivals=8, seed=JServeConfig().seed))
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[serve]")]
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--load",
                 "--arrivals", "8"])
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("[serve]")]
    assert len(want) == 2 and "open-loop: 8/8 arrivals" in want[0]
    assert got == want
