"""Training on the model axis, the tier pairs on a data axis and the
prefill and serve step builders, on the CPU.

The collectives: each differentiable collective of
``parallel.sharding`` (``copy_in`` / ``reduce_out`` through the
row-parallel MLP, ``all_sum`` through the split RMSNorm, ``gather_cols``
with each backward, ``all_to_all_grad``) on two spawned gloo ranks,
forward and backward against the unsplit op (f64 inputs; the sums,
norms, softmaxes and routing in f32, as the port takes them); the vocabulary-
parallel cross-entropy (qwen3's split table, three audio codebooks of 64
whose columns straddle the ranks, and a vocabulary of 200 that the
divisibility guard leaves whole); the attention's head layouts
(``attention.attention_train``: heads on the ranks' edges, ``wq`` split
beside a whole ``wk``, one kv head split inside, three heads a rank over
kv groups of two); the MoE's expert-parallel training form against its
plain version ``moe_apply_ep_ref`` under autograd, with drops at both
stages and its load-balance term.

Against the reference at the same mesh (``tests/test_torch_dp_train.py``'s
machinery: one subprocess of four forced host devices for every case of
this file, the port's ranks over gloo, one spawn a world size): smoke
qwen3-1.7b at (1, 2) and at (2, 2) with the deterministic store off, two
microbatches and int8 error feedback; granite-moe-1b-a400m at (1, 2) and
(2, 2), whose tokens the reference shards over (data, model) -- each
rank's capacity from its own tokens, drops at both stages and the aux
loss -- and, held to the (1, 2) case, at (2, 1, 2) with ``multi_pod``
(the batch split over (pod, data), the MoE's tokens over the data axis
alone, of one rank there); musicgen-large at (1, 2); qwen3 at (2, 1) with
DEVICE weights beside POOL state and the reverse; a rank's state bytes
against the reference's. Held, in f32: the loss, every gradient leaf
(each rank's (F, M) shard put together) and one AdamW step
(``assert_step_close``), int8 residuals as ``test_torch_dp_train_mesh.py``
holds them. The HOST tier at (1, 2) (weights, m, v and masters in host
arenas) bit for bit its DEVICE twin. ``build_prefill_step`` /
``build_serve_step`` against the reference's at (1, 1) and (1, 2):
qwen3's last-position logits and three decode ticks over a page-sharded
cache; granite's (the expert-parallel MoE) at (2, 2) and at (2, 2, 2)
with ``multi_pod`` on a batch of 4 rows (each (pod, data) rank's rows,
its model rank's pages), every rank's rows of the reference's.
The reference's training state carried to a (2, 2) rank's shards and
back (``bridge``), and ``launch.train``'s rank there against one rank's
``train``. The refusals are ``test_torch_train_ranks.py``'s.
"""
import collections
import concurrent.futures
import contextlib
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
from repro_torch.launch import mesh
from repro_torch.launch import steps as tsteps

from test_torch_dp_train import (F32_TOL, _JAX as _JAX_TRAIN, as_tree,
                                 assert_grads_close, assert_step_close,
                                 case, joined, np_batch, np_params,
                                 rank_main, run_reference)
import test_torch_dp_train as dp

QWEN, GRANITE, MUSIC = "qwen3-1.7b", "granite-moe-1b-a400m", "musicgen-large"
ZAMBA, VLM, XLSTM = "zamba2-2.7b", "llama-3.2-vision-11b", "xlstm-125m"
# granite's capacity factor in the training cases: both stages drop pairs
DROPS = dict(capacity_factor=1.0)
CASES = [case("q12", QWEN, shape=(1, 2)),
         case("q22-int8", QWEN, shape=(2, 2), ds=False, microbatches=2,
              int8_ef=True),
         case("g12", GRANITE, shape=(1, 2), over=DROPS),
         case("g22", GRANITE, shape=(2, 2), over=DROPS),
         case("m12", MUSIC, shape=(1, 2)),
         case("z12", ZAMBA, shape=(1, 2)),
         case("z22", ZAMBA, shape=(2, 2)),
         case("v12", VLM, shape=(1, 2)),
         case("x12", XLSTM, shape=(1, 2)),
         case("dev-pool", QWEN, tier="device", opt_tier="pool"),
         case("pool-dev", QWEN, tier="pool", opt_tier="device",
              same_as="dev-pool")]
BY_NAME = {c["name"]: c for c in CASES}
# port-only: the HOST tier at (1, 2) and its DEVICE twin; DEVICE beside
# HOST at (2, 1), either way round, and their POOL twins (cases above)
HOST = case("q12-host", QWEN, shape=(1, 2), tier="host", host_memory=True)
TWIN = case("q12-device", QWEN, shape=(1, 2), tier="device")
HOST_PAIRS = {"dev-host": case("dev-host", QWEN, tier="device",
                               opt_tier="host", host_memory=True),
              "host-dev": case("host-dev", QWEN, tier="host",
                               opt_tier="device", host_memory=True)}
TWINS = {HOST["name"]: TWIN["name"], "dev-host": "dev-pool",
         "host-dev": "pool-dev"}
# port-only: granite at (2, 1, 2) with multi_pod -- the batch split over
# (pod, data), the MoE's tokens over the data axis (of one rank) and the
# model axis, as at (1, 2): the reference's (1, 2) case is its reference
MULTIPOD = case("g212-multipod", GRANITE, shape=(2, 1, 2), multi_pod=True,
                over=DROPS)
# the step builders: (name, arch, mesh shape, with decode ticks); granite
# over (data, model) and (pod, data, model): the prefill's MoE routes each
# data rank's tokens (the reference's moe_apply_ep), the ticks each data
# rank's slots (moe_apply_ep_decode)
SERVE = [("q11", QWEN, (1, 1), True), ("q12", QWEN, (1, 2), True),
         ("z12", ZAMBA, (1, 2), False), ("v12", VLM, (1, 2), False),
         ("x12", XLSTM, (1, 2), False), ("g22", GRANITE, (2, 2), True),
         ("g222", GRANITE, (2, 2, 2), True)]
# the archs of the training cases
ARCHS = (QWEN, GRANITE, MUSIC, ZAMBA, VLM, XLSTM)
# xLSTM's leaves that are whole on the model axis and used alike by
# every rank: their gradient is whole on each rank, counted once
ALIKE = ("r_gates", "mlstm.0.0.w_gates", "gate_bias", "ln_head.scale")
SB, SS, MAX_SEQ, PAGE, TICKS = 2, 16, 32, 8, 3
# granite's rows: a row for each (pod, data) rank of (2, 2, 2), two for
# each data rank of (2, 2) (the reference's moe_apply_ep takes both)
SERVE_ROWS = {GRANITE: 4}
# ``launch.train`` at (2, 2): smoke qwen3 in bf16, 4 x 16 tokens a step
TRAIN_KW = dict(smoke=True, seq_len=16, global_batch=4, steps=2)
# the collectives sum in f32, as the norms, softmaxes and routing do
COLL_TOL = dict(rtol=1e-5, atol=1e-6)

_SERVE_JAX = """
serve = json.load(open(os.path.join(out_dir, "serve.json")))
for name, arch, shp, ticks, sbatch in serve:
    cfg = dataclasses.replace(registry.smoke(arch), dtype="float32")
    rc = dataclasses.replace(RunConfig(
        model=cfg, shape=SHAPES["decode_32k"],
        mesh=MeshConfig(multi_pod=len(shp) == 3)), kv_page_size=%d)
    if (arch, "float32") not in params:
        params[arch, "float32"] = M.init_model(jax.random.PRNGKey(0), cfg)
    p0 = params[arch, "float32"]
    toks = np.asarray(sbatch["tokens"], np.int32)
    pbatch = {"tokens": jnp.asarray(toks)}
    if "vision_embeds" in sbatch:
        pbatch["vision_embeds"] = jnp.asarray(np.asarray(
            sbatch["vision_embeds"], np.float32))
    out = {}
    pmesh = make_production_mesh(shape=tuple(shp))
    with jax.set_mesh(pmesh):
        pspecs = shlib.param_specs(p0, tier=rc.param_tier,
                                   multi_pod_fsdp=False)
        p = jax.device_put(p0, shlib.shardings_from_specs(pmesh, pspecs))
        out["prefill"] = np.asarray(jax.jit(steps.build_prefill_step(
            cfg, rc))(p, pbatch), np.float32)
        if ticks:
            b = toks.shape[0]
            cache = jax.device_put(M.cache_init(cfg, rc, b, %d),
                                   shlib.shardings_from_specs(
                                       pmesh, M.cache_specs(cfg, rc, b)))
            step = jax.jit(steps.build_serve_step(cfg, rc))
            for t in range(%d):
                lg, cache = step(p, cache, jnp.asarray(toks[:, t:t + 1]))
                out["tick%%d" %% t] = np.asarray(lg, np.float32)
    np.savez(os.path.join(out_dir, "serve_" + name + ".npz"), **out)
""" % (PAGE, MAX_SEQ, TICKS)
# eight host devices: the (2, 2, 2) mesh's (a mesh takes the first of them)
_JAX = _JAX_TRAIN.replace('print("JAX_TRAIN done")',
                          _SERVE_JAX + 'print("JAX_TRAIN done")').replace(
    "device_count=4", "device_count=8")


def _serve_batch(arch):
    """The step builders' batch: tokens [rows, SS] (SB rows, or
    ``SERVE_ROWS``'; and the VLM's f32 vision embeddings)."""
    cfg = treg.smoke(arch)
    rng = np.random.default_rng(3)
    rows = SERVE_ROWS.get(arch, SB)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (rows, SS)).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = (rng.standard_normal(
            (rows, cfg.n_vision_tokens, cfg.d_model)) * 0.02).astype(
                np.float32)
    return out


# ------------------------------------------------------------ rank work

def _live(cls, *ts):
    """A module of ``cls`` whose parameters are the tensors ``ts``
    themselves (the port's constructors freeze them as new leaves)."""
    mod = cls(*(None if t is None else t.detach() for t in ts))
    for k, t in zip(list(mod._parameters), ts):
        mod._parameters[k] = t
    return mod


def _grads(loss, leaves):
    return [g.detach().numpy() for g in torch.autograd.grad(loss, leaves)]


def _collectives(group):
    """Each differentiable collective on this rank, in f64, beside the
    unsplit op on the same inputs (drawn alike on every rank from shared
    seeds, every rank's own ones too): ``{name: [(label, got, want)]}``,
    this rank's part of each output and gradient against the same part
    of the unsplit op's."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import attention as tattn
    from repro_torch.models import layers as L
    from repro_torch.models import model as TM
    from repro_torch.models import moe as tmoe
    from repro_torch.models import transformer
    from repro_torch.parallel import sharding as sh
    r, n = group.rank, group.size
    out = {}

    def draw(seed, *shape, scale=1.0):
        return torch.randn(shape, generator=torch.Generator().manual_seed(
            seed), dtype=torch.float64) * scale

    def part(t, dim):
        k = t.shape[dim] // n
        return t.narrow(dim, r * k, k)

    def leaves(ts):
        return [t.detach().clone().requires_grad_(True) for t in ts]

    # copy_in / reduce_out: the row-parallel MLP (swiglu, d_ff 128)
    cfg = dataclasses.replace(treg.smoke(QWEN), dtype="float32")
    x = draw(1, 2, 5, 64)
    ws = [draw(2, 64, 128, scale=.1), draw(3, 128, 64, scale=.1),
          draw(4, 64, 128, scale=.1)]
    wy = draw(5, 2, 5, 64)
    whole = leaves([x, *ws])
    want = _grads((L.mlp_apply(_live(L.MLP, *whole[1:]), cfg, whole[0])
                   * wy).sum(), whole)
    mine = leaves([x, part(ws[0], 1), part(ws[1], 0), part(ws[2], 1)])
    y = L.mlp_apply(_live(L.MLP, *mine[1:]), cfg, mine[0], group, train=True)
    got = _grads((y * wy).sum(), mine)
    out["mlp"] = [("y", y.detach().numpy(), L.mlp_apply(
        L.MLP(*ws), cfg, x).numpy()), ("dx", got[0], want[0]),
        ("dw_up", got[1], part(torch.from_numpy(want[1]), 1).numpy()),
        ("dw_down", got[2], part(torch.from_numpy(want[2]), 0).numpy()),
        ("dw_gate", got[3], part(torch.from_numpy(want[3]), 1).numpy())]
    # all_sum: RMSNorm over 64 channels, 32 a rank, each rank weighing
    # its channels by its own draw
    scale = draw(6, 64)
    wn = torch.cat([draw(10 + i, 2, 5, 64 // n) for i in range(n)], -1)
    whole = leaves([x, scale])
    yw = L.head_rmsnorm(whole[1], whole[0], 1e-6)
    want = _grads((yw * wn).sum(), whole)
    mine = leaves([part(x, 2), scale])
    y = sh.split_rmsnorm(group, mine[1], mine[0], 64, 1e-6)
    got = _grads((y * part(wn, 2)).sum(), mine)
    out["rms"] = [("y", y.detach().numpy(), part(yw, 2).detach().numpy()),
                  ("dx", got[0], part(torch.from_numpy(want[0]), 2).numpy()),
                  ("dscale", got[1], want[1])]
    # gather_cols: "own" (one weight on every rank) and "sum" (each
    # rank's own weight)
    pieces = [draw(20 + i, 3, 4) for i in range(n)]
    same, own = draw(30, 3, 4 * n), [draw(40 + i, 3, 4 * n)
                                     for i in range(n)]
    mine = leaves([pieces[r]])
    ya = sh.gather_cols(group, mine[0], dim=1)
    ga = _grads((ya * same).sum(), mine)[0]
    yb = sh.gather_cols(group, mine[0], dim=1, grad="sum")
    gb = _grads((yb * own[r]).sum(), mine)[0]
    out["gather"] = [("y", ya.detach().numpy(), torch.cat(pieces, 1).numpy()),
                     ("own", ga, part(same, 1).numpy()),
                     ("sum", gb, part(sum(own), 1).numpy())]
    # all_to_all_grad, an int rider beside
    sent = [draw(50 + i, n, 3, 4) for i in range(n)]
    wa = [draw(60 + i, n, 3, 4) for i in range(n)]
    mine = leaves([sent[r]])
    rider = torch.arange(n * 3, dtype=torch.int32).view(n, 3) + 10 * r
    got, ride = sh.all_to_all_grad(group, mine[0], rider)
    ga = _grads((got * wa[r]).sum(), mine)[0]
    out["a2a"] = [("y", got.detach().numpy(),
                   torch.stack([sent[i][r] for i in range(n)]).numpy()),
                  ("rider", ride.numpy(), np.stack(
                      [np.arange(n * 3).reshape(n, 3)[r] + 10 * i
                       for i in range(n)])),
                  ("dx", ga, torch.stack([wa[j][r]
                                          for j in range(n)]).numpy())]
    # vocabulary-parallel cross-entropy: split tables and a whole one
    xent = []
    for key, over in (("qwen", {}), ("audio3", dict(family="audio",
                                                    n_codebooks=3,
                                                    vocab_size=64,
                                                    tie_embeddings=False)),
                      ("whole200", dict(vocab_size=200))):
        c = dataclasses.replace(cfg, **over)
        rows = L._table_rows(c)
        table = draw(70, rows, 64, scale=.3)
        lab = torch.randint(0, c.vocab_size, (2, 3, 8) if key == "audio3"
                            else (2, 8),
                            generator=torch.Generator().manual_seed(71))
        xx = draw(72, 2, 8, 64)
        tied = c.tie_embeddings
        w = table if tied else table.T.contiguous()
        whole = leaves([xx, w])
        emb = (_live(L.Embed, whole[1]) if tied
               else _live(L.Embed, table[:1].clone(), whole[1]))
        lw = L.softmax_xent(L.unembed_apply(emb, c, whole[0]), lab)
        want = _grads(lw, whole)
        cut = rows % 16 == 0
        mine = leaves([xx, part(w, 0 if tied else 1) if cut else w])
        emb = (_live(L.Embed, mine[1]) if tied
               else _live(L.Embed, table[:1].clone(), mine[1]))
        loss = TM._chunked_xent(emb, c, mine[0], lab, n_chunks=2,
                                group=group)
        got = _grads(loss, mine)
        gw = torch.from_numpy(want[1])
        xent += [(key + " split", L.table_split(emb, c), cut),
                 (key + " loss", float(loss.detach()), float(lw.detach())),
                 (key + " dx", got[0], want[0]),
                 (key + " dtable", got[1],
                  (part(gw, 0 if tied else 1) if cut else gw).numpy())]
    out["xent"] = xent
    # the attention's head layouts (heads, kv heads, head dim)
    att = []
    for key, (h, hkv, d) in (("edges", (4, 4, 16)), ("whole_wk", (4, 2, 12)),
                             ("inside", (4, 1, 32)), ("uneven", (6, 3, 16))):
        c = ModelConfig(arch_id=key, family="dense", n_layers=1, d_model=64,
                        n_heads=h, n_kv_heads=hkv, head_dim=d, d_ff=128,
                        vocab_size=256, qk_norm=True, dtype="float32")
        blk = transformer.block_init(torch.Generator().manual_seed(7), c,
                                     "cpu").double()
        a = blk.attn
        names = ("wq", "wk", "wv", "wo", "q_norm", "k_norm")
        ws = [getattr(a, k).detach() for k in names]
        ws[4], ws[5] = 1 + draw(80, d, scale=.1), 1 + draw(81, d, scale=.1)
        xx, wy = draw(82, 2, 6, 64), draw(83, 2, 6, 64)
        pos = torch.arange(6, dtype=torch.int32)[None].expand(2, 6)
        axes = (1, 1, 1, 0, None, None)
        cuts = [ax is not None and w.shape[ax] % 16 == 0
                for w, ax in zip(ws, axes)]

        def run(ts, grp):
            x_, *w_ = ts
            blk.attn = _live(tattn.Attention, *w_)
            if grp is None:
                q, k, v = tattn.qkv_project(blk.attn, c, L.head_rmsnorm(
                    blk.ln_attn.scale, x_, c.norm_eps), pos)
                o = tattn.chunked_attention(q, k, v)
                return x_ + o.reshape(2, 6, -1) @ w_[3]
            return tattn.attention_train(blk, c, x_, pos, grp)
        whole = leaves([xx, *ws])
        yw = run(whole, None)
        want = _grads((yw * wy).sum(), whole)
        mine = leaves([xx, *(part(w, ax) if cut else w
                             for w, ax, cut in zip(ws, axes, cuts))])
        y = run(mine, group)
        got = _grads((y * wy).sum(), mine)
        att.append((key + " y", y.detach().numpy(), yw.detach().numpy()))
        att.append((key + " dx", got[0], want[0]))
        for k, gg, gw, ax, cut in zip(names, got[1:], want[1:], axes, cuts):
            gw = torch.from_numpy(gw)
            att.append((f"{key} d{k}", gg,
                        (part(gw, ax) if cut else gw).numpy()))
        att.append((key + " wq cut, wk cut", (cuts[0], cuts[1]),
                    {"edges": (True, True), "whole_wk": (True, False),
                     "inside": (True, True),
                     "uneven": (True, True)}[key]))
    out["attn"] = att
    # the MoE's expert-parallel training form against its plain version
    # (``moe_apply_ep_ref``, all ranks in one process) under autograd, in
    # f32 (the routing's dtype): 48 tokens a rank, capacity factor 0.6
    # (drops at both stages)
    mc = dataclasses.replace(treg.smoke(GRANITE), dtype="float32",
                             capacity_factor=0.6)
    moe = tmoe.moe_init(torch.Generator().manual_seed(5), mc, "cpu")
    ws = [draw(90, *moe.router.shape).float()] + [
        p.detach() for p in (moe.e_gate, moe.e_up, moe.e_down)]
    xx, wy = draw(91, 2, 48, 64).float(), draw(92, 2, 48, 64).float()
    whole = leaves([xx, *ws])
    live = _live(tmoe.MoE, *whole[1:])
    yw, drops = tmoe.moe_apply_ep_ref(live, mc, whole[0], n)
    mes, ces = [], []
    for i in range(n):
        xt = whole[0][:, i * 24:(i + 1) * 24].reshape(-1, 64)
        me, ce, _ = tmoe._aux(mc, *tmoe._gates(live, mc, xt)[::2])
        mes.append(me)
        ces.append(ce)
    auxw = (mc.router_aux_coef * mc.n_experts
            * torch.sum(sum(mes) / n * (sum(ces) / n)))
    want = _grads((yw * wy).sum() + 10 * auxw, whole)
    mine = leaves([xx, *ws])
    y, aux = tmoe.moe_apply_ep_train(_live(tmoe.MoE, *mine[1:]), mc,
                                     mine[0], group=group)
    got = _grads((y * wy).sum() + 10 * aux, mine)
    f32 = dict(rtol=1e-5, atol=1e-7)
    out["moe"] = [("drops", drops["dispatch"] > 0 and drops["expert"] > 0,
                   True),
                  ("y", y.detach().numpy(), yw.detach().numpy(), f32),
                  ("aux", float(aux.detach()), float(auxw.detach()), f32)
                  ] + [("d" + k, gg, gw, f32) for k, gg, gw in zip(
                      ("x", "router", "e_gate", "e_up", "e_down"), got,
                      want)]
    return out


def _serve(rank_mesh, cases, np_params_by):
    """The step builders of every ``SERVE`` case of this world's size:
    each on this rank's rows of the batch (its (pod, data) rank's part)
    and its model rank's pages, its rows kept under "rows"."""
    from repro_torch.models import model as TM
    from repro_torch.parallel import sharding as sh
    out = {}
    for name, arch, shp, ticks in cases:
        cfg = dataclasses.replace(treg.smoke(arch), dtype="float32")
        rc = dataclasses.replace(RunConfig(
            model=cfg, shape=SHAPES["decode_32k"],
            mesh=MeshConfig(multi_pod=len(shp) == 3)), kv_page_size=PAGE)
        m = rank_mesh if rank_mesh.world.size > 1 else None
        # placed as the port's serving steps take it (hdm.HDMStore): with
        # multi_pod the FSDP shards are over (pod, data)
        params = bridge.params_from_jax(
            np_params_by[arch], cfg, device="cpu", rank=rank_mesh.rank,
            mesh_shape=shp, multi_pod_fsdp=rc.mesh.multi_pod)
        whole = _serve_batch(arch)
        dp_group = tsteps.batch_group(rc, m)
        row, n_rows = (0, 1) if dp_group is None else (dp_group.rank,
                                                        dp_group.size)
        per = whole["tokens"].shape[0] // n_rows
        batch = {k: torch.from_numpy(v[row * per:(row + 1) * per])
                 for k, v in whole.items()}
        toks = batch["tokens"]
        res = {"rows": (row * per, (row + 1) * per),
               "prefill": bridge.to_numpy(tsteps.build_prefill_step(
                   cfg, rc, mesh=m)(params, batch))}
        if ticks:
            cache = TM.cache_init(cfg, rc, whole["tokens"].shape[0],
                                  MAX_SEQ, device="cpu")
            cache = sh.shard_cache(cache, rank_mesh.model.rank,
                                   rank_mesh.model.size, (row, n_rows))
            step = tsteps.build_serve_step(cfg, rc, mesh=m)
            for t in range(TICKS):
                lg, cache = step(params, cache, toks[:, t:t + 1])
                res[f"tick{t}"] = bridge.to_numpy(lg)
        out[name] = res
    return out


def _host_twin(group, params_np):
    """The HOST and DEVICE twins at (1, 2), and DEVICE beside HOST at
    (2, 1): every number of one step."""
    out = {}
    for c in (HOST, TWIN, *HOST_PAIRS.values()):
        rank_mesh = mesh.init_mesh(group.rank, c["shape"], device="cpu")
        out[c["name"]] = dp.train_case(rank_mesh, c, params_np)
    return out


def _bridge(rank_mesh, np_state):
    """The reference's training state carried to this (2, 2) rank's
    shards against ``init_state``'s, and put back together."""
    cfg = treg.smoke(QWEN)
    got = bridge.train_state_from_jax(np_state, cfg, device="cpu",
                                      rank=rank_mesh.rank,
                                      mesh_shape=(2, 2))
    rc = RunConfig(model=cfg, shape=SHAPES["train_4k"], mesh=MeshConfig())
    from repro_torch.optim import adamw as tadamw
    want = tsteps.init_state(bridge.params_from_jax(
        np_state.params, cfg, device="cpu"), rc, tadamw.AdamWConfig(),
        mesh=rank_mesh)
    same = all(torch.equal(a, b) for a, b in zip(
        list(got.params.parameters()) + got.opt.m + got.opt.v
        + got.opt.master, list(want.params.parameters()) + want.opt.m
        + want.opt.v + want.opt.master))
    return same, bridge.train_state_to_numpy(got, cfg, rank_mesh.data,
                                             model=rank_mesh.model)


@contextlib.contextmanager
def _drops():
    """The pairs the expert-parallel MoE drops at each stage, counted
    while the block runs (its forward and its recompute)."""
    from repro_torch.models import moe as tmoe
    count = collections.Counter()
    send, experts = tmoe._ep_send, tmoe._ep_experts

    def _send(*a, **k):
        out = send(*a, **k)
        count["dispatch"] += int((~out["keep"]).sum())
        return out

    def _experts(*a, **k):
        out = experts(*a, **k)
        count["expert"] += int(out[1])
        return out
    tmoe._ep_send, tmoe._ep_experts = _send, _experts
    try:
        yield count
    finally:
        tmoe._ep_send, tmoe._ep_experts = send, experts


def _rank(group, cases, params_np, np_state):
    """One rank of a world of 2, 4 or 8: the training cases of its size,
    the step builders and, on 2, the collectives and the HOST twins; on 4
    the bridge."""
    out = {}
    for c in cases + [MULTIPOD]:
        with _drops() as drops:
            out.update(rank_main(group, [c], params_np))
        if c["name"] in out:
            out[c["name"]]["drops"] = dict(drops)
    by_arch = {a: params_np[a, "float32"] for a, _ in params_np}
    if group.size == 8:
        rank_mesh = mesh.init_mesh(group.rank, (2, 2, 2), device="cpu")
        out["serve"] = _serve(rank_mesh, [s for s in SERVE
                                          if s[2] == (2, 2, 2)], by_arch)
        return out
    shape = (1, 2) if group.size == 2 else (2, 2)
    rank_mesh = mesh.init_mesh(group.rank, shape, device="cpu")
    out["serve"] = _serve(rank_mesh, [s for s in SERVE if s[2] == shape],
                          by_arch)
    if group.size == 2:
        out["collectives"] = _collectives(group)
        out.update(_host_twin(group, params_np[QWEN, "float32"]))
    else:
        out["bridge"] = _bridge(rank_mesh, np_state)
        from repro_torch.launch import train
        run = train._train_rank(rank_mesh, QWEN, TRAIN_KW)
        out["train"] = {"losses": [h["loss"] for h in run["history"]],
                        "table": run["state"]["params/embed.embedding"].shape}
    return out


def _np_state():
    """The reference's initial training state of smoke qwen3-1.7b in
    f32 (zero moments, f32 masters)."""
    from repro.launch import steps as jsteps
    from repro.optim import adamw as jadamw
    params = np_params(QWEN, "float32")
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    opt = jadamw.AdamWState(step=np.zeros((), np.int32), m=zeros, v=zeros,
                            master=params)
    return jsteps.TrainState(params, opt, None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("tp_train"))
    import json
    with open(os.path.join(out_dir, "serve.json"), "w") as f:
        json.dump([(n, a, list(s), t, {k: v.tolist() for k, v in
                                       _serve_batch(a).items()})
                   for n, a, s, t in SERVE], f)
    dp._JAX, saved = _JAX, dp._JAX
    try:
        result = run_reference(CASES, out_dir)
    finally:
        dp._JAX = saved
    params_np = {(a, "float32"): np_params(a, "float32") for a in ARCHS}
    port = {}
    # the three worlds side by side, beside the reference's subprocess
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        worlds = [pool.submit(
            mesh.spawn, _rank, size, (CASES, params_np, _np_state()),
            rendezvous_dir=str(tmp_path_factory.mktemp("rdv")),
            device="cpu", timeout_s=600.0) for size in (2, 4, 8)]
        for world in worlds:
            for r in world.result():
                for name, res in r.items():
                    port.setdefault(name, []).append(res)
    # the step builders at one rank, in this process
    one = mesh.RankMesh.of_group(mesh.RankGroup(0, 1, torch.device("cpu"),
                                                "gloo"))
    port["serve"].append(_serve(one, [s for s in SERVE if s[2] == (1, 1)],
                                {a: params_np[a, "float32"]
                                 for a in (QWEN, GRANITE)}))
    ref = result()
    for name, *_ in SERVE:
        with np.load(os.path.join(out_dir, f"serve_{name}.npz")) as z:
            ref["serve_" + name] = {k: z[k] for k in z.files}
    return port, ref


# ------------------------------------------------------------ collectives

@pytest.mark.parametrize("name", ["mlp", "rms", "gather", "a2a", "xent",
                                  "attn", "moe"])
def test_collectives_forward_and_backward(runs, name):
    """Each differentiable collective on two gloo ranks against the
    unsplit op in f64 (module docstring), every rank's part of every
    output and gradient: ``mlp`` (``copy_in`` / ``reduce_out``), ``rms``
    (``all_sum``), ``gather`` (``gather_cols``, both backwards), ``a2a``
    (``all_to_all_grad``), ``xent`` (the vocabulary-parallel
    cross-entropy, and the whole table's), ``attn`` (the head layouts),
    ``moe`` (the expert-parallel form with drops, and its aux term)."""
    port, _ = runs
    for checks in port["collectives"]:
        for label, got, want, *tol in checks[name]:
            if isinstance(want, (bool, tuple)):
                assert got == want, label
            else:
                np.testing.assert_allclose(got, want, err_msg=label,
                                           **(tol[0] if tol else COLL_TOL))


# ------------------------------------------------------- reference cases

@pytest.mark.parametrize("name", [c["name"] for c in CASES]
                         + [MULTIPOD["name"]])
def test_model_axis_and_tier_pairs_match_reference(runs, name):
    """The loss on every rank, every gradient leaf (the ranks' (F, M)
    shards put together) and one AdamW step against the reference's at
    the same mesh (granite with ``multi_pod`` at (2, 1, 2): its (1, 2)
    case, whose MoE routes the same tokens), f32; int8 residuals within
    one quantization step of the largest gradient block."""
    port, ref = runs
    c = BY_NAME.get(name, MULTIPOD)
    got, want = port[name], ref["g12" if c is MULTIPOD else name]
    for r in got:
        np.testing.assert_allclose(r["loss"], want["loss"], **F32_TOL)
    assert_grads_close(as_tree(c["arch"], "float32",
                               joined(got, c, "grads"), "g"), want)
    assert_step_close(got, c, want)
    if c["int8_ef"]:
        one_step = max(np.abs(v).max() for k, v in want.items()
                       if k.startswith("g/")) / 127.0
        gnorm = np.sqrt(sum(float(np.sum(np.square(v)))
                            for k, v in want.items() if k.startswith("g/")))
        res = as_tree(c["arch"], "float32", joined(got, c, "residuals"), "r")
        for k, w in ((k, v) for k, v in want.items() if k.startswith("r/")):
            assert np.abs(res[k] - w).max() <= one_step + 3e-5 * gnorm, k


def test_whole_leaves_used_alike_count_once(runs):
    """xLSTM at (1, 2): the leaves whole on the model axis that every
    rank uses alike (the sLSTM's ``r_gates``, the mLSTM's ``w_gates``,
    both ``gate_bias`` and ``ln_head``) hold on each rank the one-device
    gradient of the same weights and batch, not N times it."""
    from repro_torch.optim import adamw as tadamw
    port, _ = runs
    c = BY_NAME["x12"]
    cfg = dataclasses.replace(treg.smoke(XLSTM), dtype="float32")
    rc = dp.run_config(dp.case("one", XLSTM, shape=(1, 1)), cfg)
    params = tsteps.init_state(bridge.params_from_jax(
        np_params(XLSTM, "float32"), cfg, device="cpu"), rc,
        tadamw.AdamWConfig()).params
    batch = {k: torch.from_numpy(v) for k, v in np_batch(XLSTM).items()}
    _, grads = tsteps.loss_and_grads(params, cfg, rc, batch)
    names = [n for n, _ in params.named_parameters()]
    alike = [i for i, n in enumerate(names) if any(k in n for k in ALIKE)]
    assert any(names[i].endswith("r_gates") for i in alike)
    for i in alike:
        want = bridge.to_numpy(grads[i])
        assert np.abs(want).max() > 0, names[i]
        for r in port[c["name"]]:
            assert r["model_axes"][i] is None, names[i]
            np.testing.assert_allclose(r["grads"][i], want, err_msg=names[i],
                                       **F32_TOL)


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_train_state_bytes_match_reference(runs, name):
    """A rank's parameters, m, v, masters (and residuals) in bytes: the
    reference's ``bytes_per_device`` over the same trees (the weights
    under the parameter tier, the optimizer state under its own), the
    model-axis leaves at 1/N."""
    port, ref = runs
    for r in port[name]:
        assert r["bytes"] == int(ref[name]["bytes"])


@pytest.mark.parametrize("name", ["g12", "g22", "g212-multipod"])
def test_moe_cases_drop_at_both_stages(runs, name):
    """The MoE cases route past both capacities: pairs dropped at the
    per-destination send buffers (stage 1) and at the experts (stage 2)
    (stage 1 on some rank, stage 2 on every rank)."""
    ranks = runs[0][name]
    assert sum(r["drops"]["dispatch"] for r in ranks) > 0
    assert all(r["drops"]["expert"] > 0 for r in ranks)


def test_moe_model_axis_differs_from_one_device(runs):
    """The reference's MoE routes each (data, model) rank's tokens at its
    own capacity: granite's loss at (1, 2) and (2, 2) is not the
    one-device loss of the same weights, and the port follows the
    reference there (the case above), not the one-device form."""
    port, ref = runs
    from repro_torch.models import model as TM
    cfg = dataclasses.replace(treg.smoke(GRANITE), dtype="float32", **DROPS)
    model = bridge.params_from_jax(np_params(GRANITE, "float32"), cfg,
                                   device="cpu")
    rc = RunConfig(model=cfg, shape=SHAPES["train_4k"], mesh=MeshConfig())
    with torch.no_grad():
        one = float(TM.loss_fn(model, cfg, rc, {
            k: torch.from_numpy(v) for k, v in np_batch(GRANITE).items()}))
    for name in ("g12", "g22"):
        assert abs(float(ref[name]["loss"]) - one) > 1e-5
        assert abs(port[name][0]["loss"] - one) > 1e-5


@pytest.mark.parametrize("name", sorted(TWINS))
def test_host_tier_is_its_card_twin(runs, name):
    """(host, host) at (1, 2), and DEVICE beside HOST at (2, 1) either
    way round: each rank's HOST leaves in host arenas, and every number
    of the step bit for bit its twin's on the card (the DEVICE case at
    (1, 2), DEVICE beside POOL and POOL beside DEVICE): the same shards,
    the same collectives."""
    port, _ = runs
    for r, q in zip(port[name], port[TWINS[name]]):
        assert any(r["on_host"]) and not any(q["on_host"])
        assert all(r["on_host"]) == (name == HOST["name"])
        assert r["loss"] == q["loss"] and r["step_loss"] == q["step_loss"]
        assert r["collectives"] == q["collectives"]
        for key in ("grads", "params", "m", "v", "master"):
            for a, b in zip(r[key], q[key]):
                np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("name", [s[0] for s in SERVE])
def test_step_builders_match_reference(runs, name):
    """``build_prefill_step`` (the last position's logits) and
    ``build_serve_step`` (three ticks over the page-sharded cache) against
    the reference's at the same mesh, every rank (its rows), f32 3e-5."""
    port, ref = runs
    want = ref["serve_" + name]
    got = [r[name] for r in port["serve"] if name in r]
    _, _, shp, ticks = next(s for s in SERVE if s[0] == name)
    assert len(got) == int(np.prod(shp))
    rows = {tuple(r["rows"]) for r in got}
    assert sorted(rows) == sorted({(i * len(want["prefill"]) // len(rows),
                                    (i + 1) * len(want["prefill"])
                                    // len(rows))
                                   for i in range(len(rows))})
    for r in got:
        lo, hi = r["rows"]
        assert sorted(k for k in r if k != "rows") == sorted(want)
        for k in want:
            np.testing.assert_allclose(r[k], want[k][lo:hi], err_msg=k,
                                       **F32_TOL)


def test_train_loop_on_the_model_axis(runs):
    """``launch.train``'s rank (``_train_rank``, what ``train_ranks``
    spawns) at (2, 2): every rank's losses equal, one rank's ``train``'s
    within bf16's 2e-2, and each rank's final state its (F, M) shard --
    the tied table [V, d] cut to [V/2, d/2]."""
    from repro_torch.launch import train
    port, _ = runs
    cfg = treg.smoke(QWEN)
    solo = train.train(QWEN, device="cpu", **TRAIN_KW)
    for r in port["train"]:
        assert r["losses"] == port["train"][0]["losses"]
        assert r["table"] == (cfg.vocab_size // 2, cfg.d_model // 2)
    np.testing.assert_allclose(port["train"][0]["losses"],
                               [h["loss"] for h in solo["history"]],
                               atol=2e-2, rtol=2e-2)


def test_bridge_carries_a_train_state_to_model_shards_and_back(runs):
    """The reference's ``TrainState`` carried to each rank's (F, M)
    shards of a (2, 2) POOL mesh equals ``init_state``'s placement bit
    for bit, and put back together over both axes it is the reference's
    whole trees."""
    port, _ = runs
    want = _np_state()
    for same, back in port["bridge"]:
        assert same
        for key, tree in (("params", want.params), ("m", want.opt.m),
                          ("v", want.opt.v), ("master", want.opt.master)):
            for a, b in zip(jax.tree_util.tree_leaves(back[key]),
                            jax.tree_util.tree_leaves(tree)):
                np.testing.assert_array_equal(a, np.asarray(b))
