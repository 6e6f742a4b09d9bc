"""The port's copies of the vectorized simulator and its sweeps against the
reference's, bit for bit, on the CPU.

``repro_torch.sim.vector`` and ``repro_torch.sim.sweep`` are copies of
``repro.sim.vector`` and ``repro.sim.sweep``. Held here: ``vector.run``
over every configuration x a few Table 1b workloads x DRAM and an SSD
medium (every ``RunResult`` field equal, ``got == want``);
``page_trace_closed_form`` on a tier's page trace (one port and tagged
ports, blocking and async ops); the sweep's rows, in process and over a
pool of workers. Both packages run inside one process: each trace is
seeded by ``hash(name)`` (``sim/workloads.py:102`` in both copies), and
Python draws a new string-hash seed for every new interpreter.
"""
import dataclasses

import numpy as np
import pytest

from repro.core.tier import CxlTier as JCxlTier
from repro.core.tier import TierConfig as JTierConfig
from repro.sim import sweep as jsweep
from repro.sim import vector as jvector
from repro_torch import sim as tsim
from repro_torch.core.tier import CxlTier as TCxlTier
from repro_torch.core.tier import TierConfig as TTierConfig
from repro_torch.sim import sweep as tsweep
from repro_torch.sim import vector as tvector

N_OPS = 4000
WORKLOADS = ("vadd", "bfs", "rsum")
MEDIA = ("dram", "znand")
ENTRY = 24_576


def _row(r):
    return dataclasses.astuple(r)


@pytest.mark.parametrize("media", MEDIA)
@pytest.mark.parametrize("config", jvector.ALL_CONFIGS)
def test_vector_run_matches_reference(config, media):
    assert tvector.ALL_CONFIGS == jvector.ALL_CONFIGS
    for w in WORKLOADS:
        got = tvector.run(config, w, media, n_ops=N_OPS)
        want = jvector.run(config, w, media, n_ops=N_OPS)
        assert _row(got) == _row(want), (config, w, media)
        assert got.exec_ns > 0


def test_vector_run_samples_match_reference():
    """The recorded per-op samples too, on an SSD tail bin."""
    kw = dict(n_ops=N_OPS, record_samples=True, mlp=16, store_q=4)
    got = tvector.run("cxl-ds", "rsum", "znand@2", **kw)
    want = jvector.run("cxl-ds", "rsum", "znand@2", **kw)
    assert _row(got) == _row(want)
    assert tsim.run_vectorized is tvector.run


def _tier_ops(tier_cls, cfg_cls, topology):
    """A tier's op trace: blocking and async writes and reads, speculative
    reads and idle time (the serving engine's calls)."""
    one = dict(media=topology[0]) if len(topology) == 1 else dict(
        topology=topology)
    tier = tier_cls(cfg_cls(max_inflight=2, **one))
    for i in range(5):
        tier.write_entry(i, ENTRY + 4096 * i)
        tier.speculative_read(i, ENTRY + 4096 * i)
        tier.advance(20_000.0)
    handles = [tier.write_entry_async(("swap", i), ENTRY) for i in range(4)]
    tier.advance(30_000.0)
    handles += [tier.read_entry_async(i, ENTRY + 4096 * i) for i in range(4)]
    tier.read_entry(4, ENTRY + 4 * 4096)     # blocking behind async
    tier.advance(1e6)
    assert all(tier.poll(h) for h in handles)
    return tier


@pytest.mark.parametrize("topology", [("dram",), ("dram", "dram@2"),
                                      ("dram", "dram@2", "dram@4")])
def test_page_trace_closed_form_matches_reference(topology):
    tier = _tier_ops(TCxlTier, TTierConfig, topology)
    jtier = _tier_ops(JCxlTier, JTierConfig, topology)
    assert tier.ops == jtier.ops and tier.op_ns == jtier.op_ns
    media = list(topology) if len(topology) > 1 else topology[0]
    kw = dict(ds=tier.cfg.ds_enabled, req_bytes=tier.cfg.req_bytes,
              max_inflight=tier.cfg.max_inflight)
    got = tvector.page_trace_closed_form(tier.ops, media, **kw)
    want = jvector.page_trace_closed_form(jtier.ops, media, **kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # and the closed form is the tier's own accounting on DRAM lanes
    np.testing.assert_allclose(np.asarray(tier.op_ns), got, rtol=1e-9,
                               atol=1e-6)


def test_page_trace_closed_form_refuses_as_reference():
    ops = _tier_ops(TCxlTier, TTierConfig, ("dram",)).ops
    with pytest.raises(ValueError) as want:
        jvector.page_trace_closed_form(ops, "znand")
    with pytest.raises(ValueError) as got:
        tvector.page_trace_closed_form(ops, "znand")
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def smoke_rows():
    """The smoke matrix's rows from both packages, in this process."""
    scen = tsweep.smoke_matrix(n_ops=N_OPS)
    jscen = jsweep.smoke_matrix(n_ops=N_OPS)
    assert [dataclasses.astuple(s) for s in scen] == \
        [dataclasses.astuple(s) for s in jscen]
    return scen, tsweep.run_sweep(scen, workers=0), \
        jsweep.run_sweep(jscen, workers=0)


def test_sweep_rows_match_reference(smoke_rows):
    scen, got, want = smoke_rows
    assert list(got) == list(want) == [s.key for s in scen]
    assert got == want
    assert {r["config"] for r in got.values()} == set(tvector.ALL_CONFIGS)


def test_sweep_worker_pool_matches_in_process(smoke_rows):
    """workers=2 gives the in-process rows. The pool's workers must be
    forked from this process (Linux's default start method on this
    Python): a spawned worker would draw a new string-hash seed, and so
    other traces for the same workload names."""
    import multiprocessing as mp
    assert mp.get_start_method() == "fork"
    scen, rows, _ = smoke_rows
    assert tsweep.run_sweep(scen, workers=2) == rows


@pytest.mark.parametrize("set_name", ["fig9", "matrix"])
def test_sweep_matrices_match_reference(set_name):
    if set_name == "fig9":
        got, want = tsweep.fig9_matrix(n_ops=100), jsweep.fig9_matrix(
            n_ops=100)
    else:
        kw = dict(n_ops=100, mlps=(8, 16), store_qs=(4,), seeds=(0, 1))
        got = tsweep.matrix(("cxl", "cxl-sr"), ("vadd", "bfs"),
                            ("dram", "nand"), **kw)
        want = jsweep.matrix(("cxl", "cxl-sr"), ("vadd", "bfs"),
                             ("dram", "nand"), **kw)
    assert [s.key for s in got] == [s.key for s in want]
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in want]


def test_category_means_match_reference(smoke_rows):
    _, rows, jrows = smoke_rows
    got = tsweep.category_means(rows)
    assert got == jsweep.category_means(jrows) and got


@pytest.mark.parametrize("name", list(jsweep.PAGE_TRACE_SCENARIOS))
def test_synthetic_page_traces_match_reference(name):
    """The sweep's synthetic tier traces and their closed-form prices."""
    spec = tsweep.PAGE_TRACE_SCENARIOS[name]
    assert spec == jsweep.PAGE_TRACE_SCENARIOS[name]
    ports = spec["ports"]
    ops = tsweep._synth_page_trace(ports, N_OPS, spec["async_frac"])
    assert ops == jsweep._synth_page_trace(ports, N_OPS, spec["async_frac"])
    media = list(ports) if len(ports) > 1 else ports[0]
    got = tvector.page_trace_closed_form(ops, media)
    want = jvector.page_trace_closed_form(ops, media)
    assert np.array_equal(got, want) and got.sum() > 0
