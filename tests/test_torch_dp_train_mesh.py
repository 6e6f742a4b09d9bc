"""Training over the data and pod axes at other meshes, the deterministic
store's two modes, int8 error feedback on shards, the collectives and
bytes of a step and the bridge's training state, on the CPU.

The reference runs every case in one subprocess of four forced host
devices, the port's ranks over gloo (``tests/test_torch_dp_train.py``
holds the same machinery and the same rules for a step). Cases, smoke
qwen3-1.7b in f32: (4, 1); (2, 2, 1) with ``multi_pod`` (FSDP and batch
over pod and data) and without (the pod ranks replicas); (2, 1) with the
deterministic store off (all-reduce then slice); (2, 1) with two
microbatches, on the DEVICE tier (plain data parallel) and at SR
granularity 2; ``int8_ef`` at (2, 1) and at (2, 2, 1) with
``multi_pod``.
Held: the loss, the gradients and one AdamW step against the
reference's at the same mesh (the cases at (2, 1) with DS off, on the
DEVICE tier and at granularity 2 against its (2, 1) case's values: those
knobs move no value in the reference, where they differ by at most
7.5e-9, so it computes them once -- ``case(same_as=)`` -- and counts each
case's bytes); with int8 error feedback the residuals
within one quantization step of the largest gradient block (a code may
round the other way where the two libraries' gradients part by an ulp),
and on identical inputs the codes, scales and residuals of
``compression.compress_grads`` on shards bit for bit those of the
reference's ``_quantize`` / ``compress_leaf`` of the whole leaf --
shards along an inner axis ([256, 64] cut on its columns, the
embedding's ``("M", "F")``) and shards whose start is no multiple of 256
elements ([12, 40] cut on its rows over 4 ranks: 120 elements each);
DS off bit for bit DS on at D 2 (gradients and the whole step); the
collectives of a step from ``launch.mesh.COLLECTIVES``: with DS on 2
all-gathers a streamed layer (forward and recompute) and one
reduce-scatter, and no data all-reduce of an FSDP leaf; with it off the
reduce-scatters replaced by all-reduces; a rank's ``TrainState`` bytes
(``core.hdm.bytes_per_device``) equal to the reference's
``bytes_per_device`` over its ``state_specs`` trees (the DEVICE tier's
whole); the reference's ``TrainState`` carried to a rank's shards and
back (``bridge``). The refusals and ``launch.train.train_ranks`` are
``tests/test_torch_train_ranks.py``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as jsteps
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
from repro_torch.launch import mesh
from repro_torch.launch import steps as tsteps
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tcomp

from test_torch_dp_train import (F32_TOL, as_tree, assert_grads_close,
                                 assert_step_close, case, joined,
                                 np_params, rank_main, run_reference)

ARCH = "qwen3-1.7b"
N_LAYERS = 4                     # smoke qwen3's streamed layers
CASES = [case("4x1", ARCH, shape=(4, 1)),
         case("2x2x1-multipod", ARCH, shape=(2, 2, 1), multi_pod=True),
         case("2x2x1", ARCH, shape=(2, 2, 1)),
         case("2x1", ARCH),
         case("2x1-ds-off", ARCH, ds=False, same_as="2x1"),
         case("2x1-micro2", ARCH, microbatches=2),
         case("2x1-device", ARCH, tier="device", same_as="2x1"),
         case("2x1-gran2", ARCH, granularity=2, same_as="2x1"),
         case("2x1-int8", ARCH, int8_ef=True),
         case("2x2x1-multipod-int8", ARCH, shape=(2, 2, 1), multi_pod=True,
              int8_ef=True)]
BY_NAME = {c["name"]: c for c in CASES}
# leaves for the int8 blocks on shards: (shape, FSDP axis)
ODD_LEAVES = [((256, 64), 1), ((12, 40), 0), ((64, 96), 0)]


def _odd_leaves():
    rng = np.random.default_rng(9)
    return [(rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 1, shape)
             ).astype(np.float32) for shape, _ in ODD_LEAVES]


def _bridge_round_trip(group, np_state):
    """``bridge.train_state_from_jax`` at (2, 1): this rank's shards
    against ``init_state``'s of the same weights, and
    ``train_state_to_numpy`` of them (gathered over the data axis)."""
    from repro_torch import bridge
    cfg = treg.smoke(ARCH)
    rank_mesh = mesh.init_mesh(group.rank, (2, 1), device="cpu")
    got = bridge.train_state_from_jax(np_state, cfg, device="cpu",
                                      rank=group.rank, mesh_shape=(2, 1))
    rc = RunConfig(model=cfg, shape=SHAPES["train_4k"], mesh=MeshConfig())
    want = tsteps.init_state(bridge.params_from_jax(
        np_state.params, cfg, device="cpu"), rc, tadamw.AdamWConfig(),
        mesh=rank_mesh)
    same = all(torch.equal(a, b) for a, b in zip(
        list(got.params.parameters()) + got.opt.m + got.opt.v
        + got.opt.master, list(want.params.parameters()) + want.opt.m
        + want.opt.v + want.opt.master))
    return same, bridge.train_state_to_numpy(got, cfg, rank_mesh.data)


def _rank(group, cases, params_np, np_state):
    """The cases of this world's size, then int8 on shards of the odd
    leaves over the whole world (a residual of half the leaf added) and,
    on two ranks, the bridge's round trip of a training state."""
    out = rank_main(group, cases, params_np)
    if group.size == 2:
        out["bridge"] = _bridge_round_trip(group, np_state)
    leaves = _odd_leaves()
    coded, residuals = [], []
    for x, (shape, axis) in zip(leaves, ODD_LEAVES):
        n = shape[axis] // group.size
        g = torch.from_numpy(np.ascontiguousarray(np.take(
            x, range(group.rank * n, (group.rank + 1) * n), axis=axis)))
        r = 0.5 * g
        layout = (shape, axis)
        (q, s, _), = tcomp.quantize_shards([g + r], [layout], group)
        deq, new_r = tcomp.compress_grads([g], [r], group=group,
                                          layouts=[layout])
        coded.append((q.numpy(), s.numpy(), deq[0].numpy()))
        residuals.append(new_r[0].numpy())
    out["odd"] = {"coded": coded, "residuals": residuals}
    return out


def _np_state():
    """The reference's initial training state of smoke qwen3-1.7b (its
    bf16 weights, zero moments, f32 masters), numpy leaves (bf16 as
    2-byte voids)."""
    params = np_params(ARCH, "bfloat16")
    wide = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a.view(jnp.bfloat16)), np.float32),
        params)
    zeros = jax.tree_util.tree_map(np.zeros_like, wide)
    opt = jadamw.AdamWState(step=np.zeros((), np.int32), m=zeros, v=zeros,
                            master=wide)
    return jsteps.TrainState(params, opt, None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("dp_mesh"))
    result = run_reference(CASES, out_dir)
    params_np = {(ARCH, "float32"): np_params(ARCH, "float32")}
    port = {}
    for size in (4, 2):
        ranks = mesh.spawn(_rank, size, (CASES, params_np, _np_state()),
                           rendezvous_dir=str(tmp_path_factory.mktemp("rdv")),
                           device="cpu", timeout_s=300.0)
        for r in ranks:
            for name, res in r.items():
                port.setdefault((size, name) if name in ("odd", "bridge")
                                else name, []).append(res)
    return port, result()


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_mesh_loss_grads_and_step_match_reference(runs, name):
    port, ref = runs
    c = BY_NAME[name]
    got, want = port[name], ref[name]
    for r in got:
        np.testing.assert_allclose(r["loss"], want["loss"], **F32_TOL)
    assert_grads_close(as_tree(ARCH, "float32", joined(got, c, "grads"),
                               "g"), want)
    assert_step_close(got, c, want)
    if c["int8_ef"]:
        one_step = max(np.abs(v).max() for k, v in want.items()
                       if k.startswith("g/")) / 127.0
        gnorm = np.sqrt(sum(float(np.sum(np.square(v)))
                            for k, v in want.items() if k.startswith("g/")))
        res = as_tree(ARCH, "float32", joined(got, c, "residuals"), "r")
        for k, w in ((k, v) for k, v in want.items() if k.startswith("r/")):
            assert np.abs(res[k] - w).max() <= one_step + 3e-5 * gnorm, k


def test_pod_replicas_agree(runs):
    """Without ``multi_pod`` the two pods' ranks hold the same shards and
    the same results."""
    port, _ = runs
    got = port["2x2x1"]
    for a, b in ((0, 2), (1, 3)):
        for key in ("params", "m", "v", "master"):
            for x, y in zip(got[a][key], got[b][key]):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("world", [2, 4])
def test_int8_on_shards_matches_whole_leaf(runs, world):
    """Identical inputs: every rank's codes, the blocks' scales and the
    decompressed gradient and residual of its shard equal, bit for bit,
    the reference's ``_quantize`` and ``compress_leaf`` of the whole
    leaf, for shards across blocks (an inner axis; starts that are no
    multiple of 256 elements)."""
    port, _ = runs
    odd = port[world, "odd"]
    assert any(axis == 1 for _, axis in ODD_LEAVES)
    assert any(np.prod(shape) // world % 256 for shape, _ in ODD_LEAVES)
    for i, (x, (shape, axis)) in enumerate(zip(_odd_leaves(), ODD_LEAVES)):
        r = 0.5 * x
        q, s = jcomp._quantize(jnp.asarray(x + r))
        deq, new_r = jcomp.compress_leaf(jnp.asarray(x), jnp.asarray(r))
        q = np.asarray(q).reshape(-1)[:x.size].reshape(shape)
        np.testing.assert_array_equal(np.concatenate(
            [o["coded"][i][0] for o in odd], axis=axis), q)
        for o in odd:
            np.testing.assert_array_equal(o["coded"][i][1],
                                          np.asarray(s).reshape(-1))
        np.testing.assert_array_equal(np.concatenate(
            [o["coded"][i][2] for o in odd], axis=axis), np.asarray(deq))
        np.testing.assert_array_equal(np.concatenate(
            [o["residuals"][i] for o in odd], axis=axis), np.asarray(new_r))


def test_granularity_splits_the_gathers_only(runs):
    """``sr_granularity`` 2 gathers each unit in two all-gathers and
    changes no bit of the gradients or the step."""
    port, _ = runs
    one, two = port["2x1"], port["2x1-gran2"]
    for key in ("grads", "params", "m", "v", "master"):
        for ra, rb in zip(one, two):
            for x, y in zip(ra[key], rb[key]):
                np.testing.assert_array_equal(x, y)
    coll = dict(one[0]["collectives"],
                **{"data:all_gather": 2 * (2 * N_LAYERS + 1)})
    assert two[0]["collectives"] == coll


def test_ds_off_is_bit_equal_to_ds_on(runs):
    """At D 2 the all-reduce-then-slice baseline gives DS on's bits:
    each sum is one f32 addition of the two ranks' values."""
    port, ref = runs
    on, off = port["2x1"], port["2x1-ds-off"]
    for key in ("grads", "params", "m", "v", "master"):
        for ra, rb in zip(on, off):
            for x, y in zip(ra[key], rb[key]):
                np.testing.assert_array_equal(x, y)
    for ra, rb in zip(on, off):
        assert ra["loss"] == rb["loss"] and ra["grad_norm"] == rb[
            "grad_norm"]
    np.testing.assert_allclose(ref["2x1-ds-off"]["loss"], ref["2x1"]["loss"],
                               rtol=1e-6)


def test_step_collectives(runs):
    """One step's collectives by axis: with DS on, per streamed layer two
    data all-gathers (the forward's and the recompute's) and one
    reduce-scatter, plus the leaves outside the stream (one gather, one
    reduce-scatter), and three data all-reduces, none of an FSDP leaf:
    the loss's mean, the whole leaves' gradients and the clip's norm;
    with DS off no reduce-scatter and an all-reduce in place of each."""
    port, _ = runs
    on = port["2x1"][0]["collectives"]
    off = port["2x1-ds-off"][0]["collectives"]
    assert on == {"data:all_gather": 2 * N_LAYERS + 1,
                  "data:reduce_scatter": N_LAYERS + 1,
                  "data:all_reduce": 3}
    assert off == {"data:all_gather": 2 * N_LAYERS + 1,
                   "data:all_reduce": 3 + N_LAYERS + 1}
    multi = port["2x2x1-multipod"][0]["collectives"]
    assert multi == {"pod,data:all_gather": 2 * N_LAYERS + 1,
                     "pod,data:reduce_scatter": N_LAYERS + 1,
                     "pod,data:all_reduce": 3}


@pytest.mark.parametrize("name", ["4x1", "2x2x1-multipod", "2x2x1", "2x1",
                                  "2x1-int8", "2x1-device"])
def test_train_state_bytes_match_reference(runs, name):
    """A rank's parameters, m, v, masters (and residuals) in bytes: the
    reference's ``bytes_per_device`` over the same trees under
    ``state_specs``; the FSDP leaves at 1/D of the whole."""
    port, ref = runs
    c = BY_NAME[name]
    p_n, d_n, _ = mesh.mesh_shape3(c["shape"])
    n = p_n * d_n if c["multi_pod"] else d_n
    whole = sum(a.nbytes for a in as_tree(
        ARCH, "float32", joined(port[name], c, "params"), "p").values())
    trees = 5 if c["int8_ef"] else 4       # params, m, v, master (f32)
    want = int(ref[name]["bytes"])
    for r in port[name]:
        held = sum(a.nbytes for a in r["params"])
        assert r["bytes"] == want == trees * held
        if c["tier"] == "device":          # plain data parallel: whole
            assert held == whole
        else:
            assert held < 1.02 * whole / n


def test_bridge_carries_a_train_state_to_shards_and_back(runs):
    """The reference's ``TrainState`` carried into each rank's shards of
    a (2, 1) POOL mesh (``bridge.train_state_from_jax``) equals
    ``init_state``'s placement of the same weights bit for bit, and put
    back together (``bridge.train_state_to_numpy``) it is the reference's
    whole trees."""
    port, _ = runs
    want = _np_state()
    for same, back in port[2, "bridge"]:
        assert same
        for key, tree in (("params", want.params), ("m", want.opt.m),
                          ("v", want.opt.v), ("master", want.opt.master)):
            for a, b in zip(jax.tree_util.tree_leaves(back[key]),
                            jax.tree_util.tree_leaves(tree)):
                b = np.asarray(b)
                if b.dtype.kind == "V":
                    b = np.asarray(jnp.asarray(b.view(jnp.bfloat16)),
                                   np.float32)
                np.testing.assert_array_equal(a, b)
        assert back["residuals"] is None and back["step"] == 0
