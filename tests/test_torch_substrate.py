"""The port's training substrate against the reference on the CPU.

The data pipeline (batches bit for bit with the reference's, resume from a
step), the checkpointer (round trip with bf16 / int / ``None`` leaves,
asynchronous commit, ``keep`` GC, the empty-directory raise, crash
consistency), the copy of ``runtime/fault_tolerance.py`` (its text, and the
same outputs on the same stamps), the deterministic store's staging ring
(``tests/test_core.py:87,112`` on the port) and gradient pass-through, and
the tier map's resident bytes against the reference's on a one-device
mesh.
"""
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import hdm as jhdm
from repro.data import pipeline as jpipe
from repro.runtime import fault_tolerance as jft
from repro_torch import bridge
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import registry as treg
from repro_torch.configs.base import RunConfig, SHAPES
from repro_torch.core import deterministic_store as ds
from repro_torch.core import hdm as thdm
from repro_torch.data import pipeline as tpipe
from repro_torch.models import model as TM
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import fault_tolerance as tft

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------------ data


@pytest.mark.parametrize("kind", ["dense", "audio", "vlm"])
def test_synthetic_batches_equal_reference(kind):
    extra = {"audio": dict(n_codebooks=4), "vlm": dict(vision_tokens=9,
                                                       d_model=16)}
    kw = dict(vocab_size=300, global_batch=3, seq_len=17, seed=5,
              **extra.get(kind, {}))
    ours = tpipe.SyntheticLM(tpipe.DataConfig(**kw))
    ref = jpipe.SyntheticLM(jpipe.DataConfig(**kw))
    for step in (0, 1, 7, 1000):
        a, b = ours.batch(step), ref.batch(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])


def test_file_batches_equal_reference(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(0).integers(0, 1000, 5000).astype(
        np.int32).tofile(path)
    kw = dict(vocab_size=1000, global_batch=4, seq_len=31, seed=2,
              token_file=path)
    ours = tpipe.FileLM(tpipe.DataConfig(**kw))
    ref = jpipe.FileLM(jpipe.DataConfig(**kw))
    for step in (0, 3, 11):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(ours.batch(step)[k],
                                          ref.batch(step)[k])


def test_pipeline_deterministic_and_resumable():
    """The stream resumed from step 2 is the first run's from step 2, and
    equals the reference's pipeline there."""
    cfg = tpipe.DataConfig(vocab_size=100, global_batch=4, seq_len=16,
                           seed=1)
    p1 = tpipe.Pipeline(cfg, start_step=0, device="cpu")
    steps1 = [next(p1) for _ in range(4)]
    p1.close()
    assert [s for s, _ in steps1] == [0, 1, 2, 3]
    assert p1.state() == {"step": 4}
    p2 = tpipe.Pipeline(cfg, start_step=2, device="cpu")
    s2, b2 = next(p2)
    p2.close()
    assert s2 == 2
    assert b2["tokens"].dtype == torch.int32
    torch.testing.assert_close(steps1[2][1]["tokens"], b2["tokens"])
    ref = jpipe.Pipeline(jpipe.DataConfig(vocab_size=100, global_batch=4,
                                          seq_len=16, seed=1), start_step=2)
    rs, rb = next(ref)
    ref.close()
    assert rs == 2
    np.testing.assert_array_equal(b2["labels"].numpy(),
                                  np.asarray(rb["labels"]))


def test_labels_shifted():
    b = tpipe.SyntheticLM(tpipe.DataConfig(vocab_size=50, global_batch=2,
                                           seq_len=8, seed=0)).batch(5)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


# ------------------------------------------------------------ checkpoint


def _state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((8, 16), generator=gen),
            "b": np.arange(16, dtype=np.float32),
            "nested/m": torch.randn((4,), generator=gen).bfloat16(),
            "step": torch.tensor(7, dtype=torch.int32),
            "skip": None}


def _assert_state_equal(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        if v is None:
            assert got[k] is None
            continue
        v = torch.as_tensor(v)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


def test_checkpoint_round_trip(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=3)
    state = _state()
    ckpt.save(7, state, extra={"lr": 0.1}, blocking=True)
    step, restored, extra = ckpt.restore()
    assert step == 7 and extra == {"lr": 0.1}
    _assert_state_equal(restored, state)


def test_checkpoint_async_commit_and_latest(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=3)
    ckpt.save(1, _state(1))          # async: returns before the write
    ckpt.wait()
    assert ckpt.latest_step() == 1
    assert os.path.exists(os.path.join(str(tmp_path), "step_1",
                                       "manifest.json"))
    assert not [d for d in os.listdir(str(tmp_path)) if d.startswith(".tmp")]


def test_checkpoint_keep_gc_and_specific_step(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2)
    states = {s: _state(s) for s in (1, 2, 3, 4)}
    for s in (1, 2, 3, 4):
        ckpt.save(s, states[s], blocking=True)
    assert ckpt.steps() == [3, 4]                   # keep=2 pruned 1, 2
    step, restored, _ = ckpt.restore(3)
    assert step == 3
    _assert_state_equal(restored, states[3])


def test_checkpoint_restore_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path)).restore()


def test_checkpoint_crash_consistency(tmp_path):
    """A half-written temp dir is never visible as a checkpoint."""
    ckpt = Checkpointer(str(tmp_path))
    os.makedirs(os.path.join(str(tmp_path), ".tmp_step_9"))
    assert ckpt.latest_step() is None
    ckpt.save(1, {"x": torch.tensor(1.0)}, blocking=True)
    assert ckpt.latest_step() == 1


def test_checkpoint_snapshot_is_taken_at_save(tmp_path):
    """The state is copied when ``save`` returns: a later in-place update
    (the next optimizer step) does not reach the checkpoint."""
    ckpt = Checkpointer(str(tmp_path))
    w = torch.zeros(4)
    ckpt.save(0, {"w": w})
    w.add_(1.0)
    ckpt.wait()
    assert torch.equal(ckpt.restore()[1]["w"], torch.zeros(4))


def test_train_checkpoints_and_resumes(tmp_path):
    """``launch/train.py`` saves parameters, moments, masters and the step,
    and a resumed run starts from them. As in the reference, the state
    after steps 0..2 is saved as step 2 and the resumed stream starts at
    that step, so batch 2 is seen twice."""
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch import train
    first = train.train("qwen3-1.7b", steps=3, seq_len=16, device="cpu",
                        ckpt_dir=str(tmp_path))
    step, flat, extra = Checkpointer(str(tmp_path)).restore()
    assert step == 2 and extra == {"step": 3}
    state = first["state"]
    want = train.state_dict(state)
    assert sorted(flat) == sorted(want)
    for k, v in want.items():
        assert torch.equal(flat[k], v.detach()), k
    cfg = treg.smoke("qwen3-1.7b")
    rc = RunConfig(model=cfg, shape=SHAPES["train_4k"])
    fresh = tsteps.init_state(TM.init_model(cfg, seed=1, device="cpu"), rc,
                              AdamWConfig())
    loaded = train.load_state_dict(fresh, flat)
    for k, v in train.state_dict(loaded).items():
        assert torch.equal(v, want[k]), k
    again = train.train("qwen3-1.7b", steps=2, seq_len=16, device="cpu",
                        ckpt_dir=str(tmp_path), resume=True)
    assert [h["step"] for h in again["history"]] == [2, 3]
    assert Checkpointer(str(tmp_path)).latest_step() == 3


# --------------------------------------------------------- fault tolerance


def test_fault_tolerance_is_a_line_for_line_copy():
    ours = (ROOT / "src/repro_torch/runtime/fault_tolerance.py").read_text()
    ref = (ROOT / "src/repro/runtime/fault_tolerance.py").read_text()
    assert ours == ref.replace("from repro.core.qos import",
                               "from repro_torch.core.qos import")


def test_fault_tolerance_same_outputs_on_the_same_stamps():
    stamps = [(0, 5, 0.1, 100.0), (1, 5, 0.12, 105.0), (3, 6, 0.5, 109.0),
              (1, 6, 0.11, 111.0)]
    out = []
    for ft in (tft, jft):
        hb = ft.Heartbeat(n_workers=4, dead_after_s=10)
        for w, step, dt, now in stamps:
            hb.stamp(w, step, dt, now=now)
        sm = ft.StragglerMitigator(evict_threshold=2.0)
        acts = [sm.assess({0: 1.0, 1: 1.0, 2: 1.05, 3: 5.0}),
                sm.assess({0: 1.0, 1: 1.6, 2: 1.05, 3: 1.0}),
                sm.assess(hb.step_times())]
        ports = sm.assess_ports([
            {"port": 0, "down": True}, {"port": 1, "degrade_mult": 3.0},
            {"port": 2, "devload": 2}, {"port": 3}])
        rp = ft.RestartPolicy(min_workers=2)
        plans = [rp.plan(n_alive=4, latest_ckpt=100, data_step=101, seed=0),
                 rp.plan(n_alive=1, latest_ckpt=100, data_step=101, seed=0),
                 rp.plan(n_alive=3, latest_ckpt=None, data_step=0, seed=1)]
        out.append((hb.dead_workers(now=112.0), hb.step_times(), acts,
                    ports, [(a, p.checkpoint_step, p.data_step, p.seed)
                            for a, p in plans]))
    assert out[0] == out[1]
    assert out[0][0] == [0, 2]
    assert out[0][2][0][3] == "evict" and out[0][2][0][0] == "ok"


# ----------------------------------------------------- deterministic store


@given(st.lists(st.tuples(st.integers(0, 7), st.floats(-10, 10)),
                min_size=1, max_size=40))
@settings(max_examples=30, deadline=None)
def test_ring_latest_write_wins(writes):
    """``read_through`` returns the most recent staged value for a key,
    else the backing value."""
    state = ds.ring_init(8, {"x": torch.zeros(2)})
    last = {}
    for key, val in writes:
        state = ds.ring_write(state, key, {"x": torch.full((2,), val)})
        last[key] = val
    recent = {}
    for key, val in writes[-8:]:
        recent[key] = val
    for key in range(8):
        got = ds.read_through(state, key, {"x": torch.full((2,), -99.0)})
        hit, _ = ds.ring_lookup(state, key)
        assert bool(hit) == (key in recent)
        if key in recent and last[key] == recent[key]:
            torch.testing.assert_close(got["x"],
                                       torch.full((2,), recent[key]),
                                       atol=1e-6, rtol=0)
        if key not in recent:
            assert torch.equal(got["x"], torch.full((2,), -99.0))


@given(st.integers(1, 64))
@settings(max_examples=20, deadline=None)
def test_ring_occupancy_bounded(n_writes):
    state = ds.ring_init(8, {"x": torch.zeros(())})
    for i in range(n_writes):
        state = ds.ring_write(state, i, {"x": torch.tensor(float(i))})
    occ = float(ds.ring_occupancy(state))
    assert 0.0 < occ <= 1.0
    assert occ == min(n_writes, 8) / 8
    assert int(state.head) == n_writes % 8


def test_ds_grads_pass_through_on_one_rank():
    """On one rank the gradients pass through; the placement is the pool
    specs with DS on, the gathered ones (no FSDP axis) off."""
    grads = [torch.ones(3), torch.zeros(2, 2)]
    assert ds.apply_ds(grads, None) is grads
    assert ds.apply_ds(grads, [("data",), (None, None)]) is grads
    specs = {"w": ("data", "model")}
    assert ds.ds_grad_specs(specs, True) is specs
    assert ds.ds_grad_specs(specs, False) == {"w": (None, "model")}


# --------------------------------------------------------------- tier map


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-2.7b"])
def test_bytes_per_device_matches_reference_on_one_device(host_mesh, arch):
    """On a one-device mesh the reference's POOL tier shards nothing:
    every byte is resident, as the port's map says."""
    from repro.configs import registry as jreg
    from repro.models import model as JM
    jcfg = jreg.smoke(arch)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    with jax.set_mesh(host_mesh):
        shapes = jax.eval_shape(lambda: JM.init_model(jax.random.PRNGKey(0),
                                                      jcfg))
        params = JM.init_model(jax.random.PRNGKey(0), jcfg)
    want = jhdm.bytes_per_device(shapes, jhdm.HDMStore(mesh=mesh))
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            params),
                                     treg.smoke(arch), device="cpu")
    for tier in (thdm.POOL, thdm.DEVICE, thdm.HOST):
        assert thdm.bytes_per_device(tparams.parameters(),
                                     thdm.HDMStore(tier=tier)) == want
    # HOST is accepted with or without its host memory; placed on the
    # CPU it holds every byte in host arenas, copied bit for bit
    store = thdm.HDMStore(tier=thdm.HOST, enable_host_tier=True)
    placed = store.place(tparams)
    assert thdm.bytes_per_device(placed.parameters(), store) == want
    for (name, p), q in zip(tparams.named_parameters(), placed.parameters()):
        assert thdm.host_target(q) == torch.device("cpu"), name
        assert thdm.host_target(p) is None and torch.equal(p, q), name
    assert thdm.HDMStore(tier=thdm.HOST).place(tparams) is tparams
    with pytest.raises(ValueError, match="unknown tier"):
        thdm.HDMStore(tier="ssd")
