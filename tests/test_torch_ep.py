"""The expert-parallel MoE forms of the port against the reference's, on
the CPU, at smoke widths.

The reference's ``moe_apply_ep`` (prefill: per-destination send buffers,
``all_to_all`` over the model axis, a second capacity per expert on the
receiver, ``all_to_all`` back, the gated combine) and
``moe_apply_ep_decode`` (tokens replicated, each rank its own experts, a
psum) run in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` on model axes of 2
and 4, jitted as its engine runs them. Held here:

 * ``moe_apply_ep_ref`` (the port's N ranks in one process) and
   ``moe_apply_ep_loop`` (a per-pair loop that shares no helper with the
   forms under test) against them:
   f32 3e-5, bf16 2e-2, and the dropped pairs at each stage counted equal
   (the reference's counts taken from its own routing, its positions
   formulas line for line). Shapes: smoke granite (E 8, top-2) and E 32
   top-8 (granite's routing) at d 64; token counts: an even chunk of 48
   whose routes lean to rank 0's experts, so that it drops at stage 1 and
   at stage 2 (asserted), an odd chunk of 37, which takes the one-device
   fallback, and decode ticks of 4 and 8 slots;
 * the distributed forms on spawned gloo ranks (``launch.mesh.spawn``, 2
   and 4 ranks, 1 torch thread each) against ``moe_apply_ep_ref``, with
   whole experts and with each rank's own slice of them (granite's 32
   experts, which ``param_specs`` splits), their aux loss against the
   reference's and, without it (the serving path), their collectives,
   and ``RankGroup.all_to_all``
   against its definition (bf16 and int32);
 * ``spawn``'s results outlive their rank: a rank's tensor result is read
   after the rank exited.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.launch import mesh
from repro_torch.models import moe as tmoe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "granite-moe-1b-a400m"
D_MODEL, D_FF = 64, 64
SHAPES = {"e8": dict(n_experts=8, top_k=2), "e32": dict(n_experts=32,
                                                      top_k=8)}
# (name, tokens, decode): an even chunk that drops at both stages, an odd
# chunk (the fallback), decode ticks of 4 and 8 slots
COUNTS = [("even", 48, False), ("odd", 37, False), ("tick4", 4, True),
          ("tick8", 8, True)]
RANKS = (2, 4)
NAMES = ("float32", "bfloat16")
TOL = {"float32": dict(atol=3e-5, rtol=3e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
# a shared direction in every token that rank 0's experts prefer: the
# even chunk overfills rank 0's send buffer and some of its experts
SKEW = 2.0
SPAWN_TIMEOUT_S = 240.0


def _inputs(shape, t, decode, seed):
    """Router, experts (f32) and tokens ([1, t, d], a decode tick [t, 1,
    d]) from a numpy seed."""
    e = SHAPES[shape]["n_experts"]
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(D_MODEL).astype(np.float32)
    u /= np.linalg.norm(u)
    router = rng.standard_normal((D_MODEL, e)).astype(np.float32) * 0.02
    router[:, :e // 2] += 0.05 * u[:, None]
    experts = [rng.standard_normal(s).astype(np.float32) * 0.02
               for s in ((e, D_MODEL, D_FF), (e, D_MODEL, D_FF),
                         (e, D_FF, D_MODEL))]
    x = rng.standard_normal((t, D_MODEL)).astype(np.float32) + SKEW * u
    x = x[:, None] if decode else x[None]
    return {"router": router, "e_gate": experts[0], "e_up": experts[1],
            "e_down": experts[2], "x": x}


CASES = {(shape, name): _inputs(shape, t, decode, seed)
         for seed, (shape, (name, t, decode)) in enumerate(
             (s, c) for s in SHAPES for c in COUNTS)}
DECODE = {name: decode for name, _, decode in COUNTS}


def _key(shape, count, dtype, n):
    return f"{shape}/{count}/{dtype}/{n}"


def _cfg(shape, dtype):
    return dataclasses.replace(treg.smoke(ARCH), dtype=dtype,
                               d_model=D_MODEL, d_ff=D_FF, **SHAPES[shape])


def _moe(arrays, dtype):
    """The port's ``MoE`` from the case's f32 arrays: the router in f32,
    the experts in ``dtype``."""
    dt = getattr(torch, dtype)
    return tmoe.MoE(torch.from_numpy(arrays["router"]),
                    *(torch.from_numpy(arrays[n]).to(dt)
                      for n in ("e_gate", "e_up", "e_down")))


def _x(arrays, dtype):
    return torch.from_numpy(arrays["x"]).to(getattr(torch, dtype))


# ------------------------------------------- the reference, in a subprocess

_JAX_EP = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json, sys
    import repro  # installs the jax < 0.5 compat shims
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import registry
    from repro.launch.mesh import make_production_mesh
    from repro.models import moe

    path, shapes, counts, ranks, names, d_model, d_ff = json.loads(
        sys.stdin.read())
    cases = np.load(path)
    ep = jax.jit(moe.moe_apply_ep, static_argnums=1)
    ep_decode = jax.jit(moe.moe_apply_ep_decode, static_argnums=1)

    def positions(ids, n, valid=None):
        # the reference's cumsum of a one-hot, minus the pair itself
        onehot = jax.nn.one_hot(ids, n, dtype=jnp.int32)
        if valid is not None:
            onehot = onehot * valid[:, None].astype(jnp.int32)
        pos = jnp.cumsum(onehot, axis=0) - onehot
        return jnp.take_along_axis(pos, ids[:, None], axis=1)[:, 0]

    def routes(p, cfg, xt):
        probs = jax.nn.softmax(xt.astype(jnp.float32) @ p["router"], -1)
        return jax.lax.top_k(probs, cfg.top_k)[1].T.reshape(-1)

    def drops(p, cfg, x, nm, decode):
        # the pairs moe_apply_ep drops at each stage, from its routing
        e, k, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
        b, s, d = x.shape
        if decode:
            return {"dispatch": 0, "expert": 0}
        if s % nm:                       # moe_apply, one capacity
            t = b * s
            flat_e = routes(p, cfg, x.reshape(t, d))
            cap = min(moe._capacity(cf, t, k, e), t)
            return {"dispatch": 0, "expert": int(
                (positions(flat_e, e) >= cap).sum())}
        e_loc, sl = e // nm, s // nm
        t = b * sl
        cd = moe._capacity(cf, t, k, nm)
        metas, lost1 = [], 0
        for r in range(nm):
            flat_e = routes(p, cfg, x[:, r * sl:(r + 1) * sl].reshape(t, d))
            dest = flat_e // e_loc
            posd = positions(dest, nm)
            keep1 = posd < cd
            lost1 += int((~keep1).sum())
            safe1 = jnp.where(keep1, posd, cd - 1)
            metas.append(jnp.zeros((nm, cd), jnp.int32).at[dest, safe1].max(
                jnp.where(keep1, flat_e % e_loc + 1, 0)))
        ce_cap = moe._capacity(cf, t * nm, k, e)
        lost2 = 0
        for r in range(nm):
            recv_e = jnp.stack([m[r] for m in metas]).reshape(-1) - 1
            ok = recv_e >= 0
            recv_e = jnp.where(ok, recv_e, 0)
            pose = positions(recv_e, e_loc, ok)
            lost2 += int((ok & ~(pose < ce_cap)).sum())
        return {"dispatch": lost1, "expert": lost2}

    out, counted = {}, {}
    for shape, fields in shapes.items():
        for name, t, decode in counts:
            for dtype in names:
                cfg = dataclasses.replace(
                    registry.smoke("granite-moe-1b-a400m"), dtype=dtype,
                    d_model=d_model, d_ff=d_ff, **fields)
                p = {n: jnp.asarray(cases[f"{shape}/{name}/{n}"])
                     for n in ("router", "e_gate", "e_up", "e_down")}
                p = dict(p, **{n: p[n].astype(dtype)
                               for n in ("e_gate", "e_up", "e_down")})
                x = jnp.asarray(cases[f"{shape}/{name}/x"]).astype(dtype)
                for nm in ranks:
                    key = f"{shape}/{name}/{dtype}/{nm}"
                    with jax.set_mesh(make_production_mesh(shape=(1, nm))):
                        if decode:
                            y = ep_decode(p, cfg, x)
                        else:
                            y, out[key + "/aux"] = ep(p, cfg, x)
                    out[key] = np.asarray(jnp.asarray(y, jnp.float32))
                    counted[key] = drops(p, cfg, x, nm, decode)
    np.savez(path + ".out.npz", **out)
    print("JAX_EP " + json.dumps(counted))
""")


@pytest.fixture(scope="module")
def jax_ep(tmp_path_factory):
    """{key: (the reference's output, its dropped pairs, its aux loss or
    None at decode)}."""
    path = str(tmp_path_factory.mktemp("ep") / "cases.npz")
    np.savez(path, **{f"{shape}/{name}/{n}": a
                      for (shape, name), arrays in CASES.items()
                      for n, a in arrays.items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run(
        [sys.executable, "-c", _JAX_EP],
        input=json.dumps([path, SHAPES, COUNTS, RANKS, NAMES, D_MODEL,
                          D_FF]),
        capture_output=True, text=True, env=env, timeout=600)
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("JAX_EP ")]
    assert line, res.stderr[-3000:]
    counted = json.loads(line[0][len("JAX_EP "):])
    ys = np.load(path + ".out.npz")
    return {key: (ys[key], counted[key], ys[key + "/aux"]
                  if key + "/aux" in ys.files else None) for key in counted}


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("dtype", NAMES)
@pytest.mark.parametrize("count", [c[0] for c in COUNTS])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_ep_ref_matches_reference(shape, count, dtype, n, jax_ep):
    """``moe_apply_ep_ref`` on N ranks against the reference's shard_map
    forms on a model axis of N: the outputs within tolerance, the pairs
    dropped at each stage equal; the even chunk drops at both stages."""
    want, want_drops, _ = jax_ep[_key(shape, count, dtype, n)]
    arrays = CASES[shape, count]
    cfg = _cfg(shape, dtype)
    x = _x(arrays, dtype)
    got, drops = tmoe.moe_apply_ep_ref(_moe(arrays, dtype), cfg, x, n,
                                       decode=DECODE[count])
    assert got.dtype == x.dtype and got.shape == x.shape
    np.testing.assert_allclose(bridge.to_numpy(got), want, **TOL[dtype])
    assert drops == want_drops
    if count == "even":
        assert drops["dispatch"] > 0 and drops["expert"] > 0
    if count == "odd":
        assert drops["expert"] > 0
    if DECODE[count]:
        assert drops == {"dispatch": 0, "expert": 0}


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("dtype", NAMES)
@pytest.mark.parametrize("count", [c[0] for c in COUNTS])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_ep_loop_matches_reference(shape, count, dtype, n, jax_ep):
    """``moe_apply_ep_loop`` (the plain form that shares no helper with
    the forms under test) against the reference's shard_map forms: the
    outputs within tolerance, the pairs dropped at each stage equal."""
    want, want_drops, _ = jax_ep[_key(shape, count, dtype, n)]
    arrays = CASES[shape, count]
    x = _x(arrays, dtype)
    got, drops = tmoe.moe_apply_ep_loop(_moe(arrays, dtype),
                                        _cfg(shape, dtype), x, n,
                                        decode=DECODE[count])
    assert got.dtype == x.dtype and got.shape == x.shape
    np.testing.assert_allclose(bridge.to_numpy(got), want, **TOL[dtype])
    assert drops == want_drops


# ------------------------------------------------ the ranks, over gloo

def _ep_rank(group, cases):
    """One rank: every case through the distributed forms, with whole
    experts and with this rank's slice of them; and ``all_to_all`` on
    bf16 and int32 rows that name their sender and receiver."""
    out = {}
    for (shape, count, dtype), arrays in cases.items():
        cfg = _cfg(shape, dtype)
        whole = _moe(arrays, dtype)
        e_loc = cfg.n_experts // group.size
        own = tmoe.MoE(whole.router, *(
            w[group.rank * e_loc:(group.rank + 1) * e_loc]
            for w in (whole.e_gate, whole.e_up, whole.e_down)))
        x = _x(arrays, dtype)
        for held, m in (("whole", whole), ("own", own)):
            if DECODE[count]:
                y = tmoe.moe_apply_ep_decode(m, cfg, x, group=group)
            else:
                y, loss = tmoe.moe_apply_ep(m, cfg, x, group=group)
                mesh.COLLECTIVES.clear()
                served, none = tmoe.moe_apply_ep(m, cfg, x, group=group,
                                                 aux=False)
                out[shape, count, dtype, held, "aux"] = (
                    loss, torch.equal(served, y) and none is None,
                    dict(mesh.COLLECTIVES))
            out[shape, count, dtype, held] = y
    sent = torch.arange(group.size * 6).view(group.size, 6) \
        + 1000 * group.rank
    out["a2a"] = {str(dt): group.all_to_all(sent.to(dt))
                  for dt in (torch.bfloat16, torch.int32)}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = {(shape, count, dtype): CASES[shape, count]
             for shape in SHAPES for count in DECODE for dtype in NAMES}
    return {n: mesh.spawn(_ep_rank, n, (cases,), rendezvous_dir=str(
        tmp_path_factory.mktemp("rendezvous")), device="cpu",
        timeout_s=SPAWN_TIMEOUT_S) for n in RANKS}


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("dtype", NAMES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_ep_ranks_match_ref(shape, dtype, n, ranks):
    """Each rank's ``moe_apply_ep`` / ``moe_apply_ep_decode`` output,
    whole on every rank, equals ``moe_apply_ep_ref``'s within tolerance,
    whether the rank holds every expert or only its own."""
    cfg = _cfg(shape, dtype)
    for count in DECODE:
        arrays = CASES[shape, count]
        want, _ = tmoe.moe_apply_ep_ref(_moe(arrays, dtype), cfg,
                                        _x(arrays, dtype), n,
                                        decode=DECODE[count])
        for r, run in enumerate(ranks[n]):
            for held in ("whole", "own"):
                got = run[shape, count, dtype, held]
                assert got.dtype == want.dtype, (count, r, held)
                torch.testing.assert_close(got.float(), want.float(),
                                           **TOL[dtype])


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("dtype", NAMES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_ep_ranks_aux(shape, dtype, n, ranks, jax_ep):
    """Each rank's aux loss of ``moe_apply_ep`` (the routes' statistics
    all-reduced on the expert-parallel form; over every token on the
    fallback) against the reference's; without ``aux`` the same output
    and no all-reduce: 2 all_to_alls and 1 all_gather on an even chunk,
    1 all-reduce (the combine) on the fallback."""
    want_collectives = {"even": {"all_to_all": 2, "all_gather": 1},
                        "odd": {"all_reduce": 1}}
    for count, collectives in want_collectives.items():
        _, _, want = jax_ep[_key(shape, count, dtype, n)]
        for r, run in enumerate(ranks[n]):
            for held in ("whole", "own"):
                loss, same, seen = run[shape, count, dtype, held, "aux"]
                np.testing.assert_allclose(float(loss), float(want),
                                           **TOL[dtype])
                assert same, (count, r, held)
                assert seen == collectives, (count, r, held, seen)


@pytest.mark.parametrize("n", RANKS)
def test_all_to_all_definition(n, ranks):
    """Row i of rank j's result is row j of what rank i sent, bit for
    bit, in bf16 and in int32."""
    for j, run in enumerate(ranks[n]):
        for dt in (torch.bfloat16, torch.int32):
            got = run["a2a"][str(dt)]
            want = torch.stack([(torch.arange(n * 6).view(n, 6)
                                 + 1000 * i)[j] for i in range(n)]).to(dt)
            assert got.dtype == dt and torch.equal(got, want)


# ------------------------------------------------- spawn's results

class _SlowToLoad:
    """Unpickles by sleeping: holds the parent in ``spawn`` while the
    next rank's result waits and that rank exits."""

    def __reduce__(self):
        return time.sleep, (3.0,)


def _slow_first(group):
    if group.rank == 1:
        time.sleep(1.0)              # rank 0's result is read first
        return torch.arange(4)
    return _SlowToLoad(), torch.arange(4)


def test_spawn_results_outlive_their_rank(tmp_path):
    """A rank's tensor result is read after the rank has exited: it
    travels by value, not as a file descriptor only the live rank could
    hand over (the cause of ``tests/test_torch_sharded.py``'s unsteady
    failures under load)."""
    out = mesh.spawn(_slow_first, 2, rendezvous_dir=str(tmp_path),
                     device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    assert torch.equal(out[0][1], torch.arange(4))
    assert torch.equal(out[1], torch.arange(4))
