"""``chip_smoke.py``'s tp logits gate on a restored request whose source
parted at its first token, and the restore it gates, on the CPU.

On the H100 (qwen3-1.7b at full width cut to 2 layers, int8 pages, two
ranks against the one-rank engine on the tp phase's traffic) rid 0's
prefill row on the ranks lies 0.0156 from the one-rank engine's, within
the gate's bound of 0.366, but its argmax parts there (a near tie: the
ranks sample 35051, the one-rank engine 45328). rid 1000 resubmits rid
0's prompt and restores its retired entry: its first token is the
entry's, so each engine's rid 1000 continues from its own rid 0's first
token (and pages that hold its own rid 0's decode rows), and its first
decode step's logits lie 5.39 apart: each engine's rid 1000 repeats its
own rid 0's continuation. The gate held those steps as if they were
conditioned alike. Here the gate and ``tp_tokens_check`` run on rows of
that shape: the restore of a source that parted at its first step is
held to its own engine's rows of the source at the matching steps, and
its first token must be its source's on both engines; a restore that
starts from the same token is held as before. Then the behaviour the
gate relies on, the port's engine against the JAX engine (smoke
qwen3-1.7b, f32, bf16 and int8 pages): a restore whose entry's first
token was forced continues from that token on both, as a fresh prompt
ending in it does."""
import dataclasses
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import MeshConfig, RunConfig, SHAPES
from repro.models import model as JM
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.configs.base import MeshConfig as TMeshConfig
from repro_torch.configs.base import RunConfig as TRunConfig
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 16
# the one-rank engine's and the ranks' first tokens of rid 0
ONE_FIRST, RANK_FIRST = 3, 5


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _row(top, second=None, gap=0.0156, seed=0):
    """A logits row whose argmax is ``top`` (``second`` ``gap`` below)."""
    row = torch.randn(V, generator=torch.Generator().manual_seed(seed)) * .1
    row[top] = 2.0
    if second is not None:
        row[second] = 2.0 - gap
    return row


def _traffic():
    """rid 0 and rid 1 in the first wave, rid 1000 restoring rid 0."""
    return [[(0, [7, 8, 9], 3), (1, [4, 4], 3)], [(1000, [7, 8, 9], 3)]]


def _engines(restored_first_rank=RANK_FIRST):
    """The one-rank engine's rows and tokens and the ranks': rid 0 parts
    at its first step (a near tie), rid 1 never; rid 1000's rows are
    conditioned on each engine's own first token of rid 0, each engine's
    repeating its own rid 0's later rows."""
    one_rows = {0: [_row(ONE_FIRST, RANK_FIRST), _row(9, seed=1),
                    _row(2, seed=2)],
                1: [_row(6, seed=3), _row(7, seed=4), _row(8, seed=5)],
                1000: [_row(9, seed=1), _row(2, seed=2)]}
    # rid 0's first row on the ranks: the one-rank row with the two
    # tokens swapped, 0.0156 apart (the near tie the card showed)
    first = one_rows[0][0].clone()
    first[[ONE_FIRST, RANK_FIRST]] = first[[RANK_FIRST, ONE_FIRST]]
    mine = {0: [first, _row(11, seed=6), _row(12, seed=7)],
            1: [r.clone() for r in one_rows[1]]}
    mine[1000] = [r.clone() for r in mine[0][1:]]
    one_tokens = {0: [ONE_FIRST, 9, 2], 1: [6, 7, 8], 1000: [ONE_FIRST, 9, 2]}
    rank_tokens = {0: [RANK_FIRST, 11, 12], 1: [6, 7, 8],
                   1000: [restored_first_rank, 11, 12]}
    ref = {"one": one_rows, "f32": {k: [r.clone() for r in v]
                                    for k, v in one_rows.items()},
           "bound": 0.366, "tokens": one_tokens}
    return mine, ref, rank_tokens


def test_restore_of_a_source_parted_at_its_first_token_is_held_to_it():
    """The card's case: the gate passes, records rid 1000 as parted
    before its first step (source rid 0, the two first tokens) and holds
    each engine's rid 1000 to its own rid 0 at the next step, and the
    token check holds rid 0 to its near tie at step 0 and rid 1000's
    first token to rid 0's on each engine."""
    mine, ref, tokens = _engines()
    sources = CS.restore_sources(_traffic())
    assert sources == {1000: 0}
    gate = CS.tp_logits_gate("tp2 int8", mine, ref, tokens, sources)
    assert gate[0]["parted_at"] == 0
    assert gate[0]["tokens"] == [ONE_FIRST, RANK_FIRST]
    assert gate[0]["gap"] <= ref["bound"]
    assert gate[1]["parted_at"] is None and gate[1]["steps"] == 3
    assert gate[1000] == {"steps": 2, "max_abs_err": 0.0,
                          "max_abs_err_f32": 0.0, "parted_at": -1,
                          "tokens": [ONE_FIRST, RANK_FIRST], "source": 0,
                          "vs_source": {"steps": 2, "max_abs_err": 0.0,
                                        "one_rank_steps": 2,
                                        "one_rank_max_abs_err": 0.0}}
    leading = CS.tp_tokens_check("tp2 int8", tokens, ref["tokens"], gate,
                                 [1000], {"bound": ref["bound"],
                                          "one_rank_vs_f32": 0.1})
    assert leading == {0: 0, 1: 3, 1000: 0}


def test_restore_from_the_same_first_token_is_still_held():
    """A restore that starts from the one-rank engine's first token is
    held step by step to the one-rank engine's: rows conditioned on
    other tokens fail the gate."""
    mine, ref, tokens = _engines(restored_first_rank=ONE_FIRST)
    tokens[0][0] = ONE_FIRST
    with pytest.raises(SystemExit):
        CS.tp_logits_gate("tp2 int8", mine, ref, tokens,
                          CS.restore_sources(_traffic()))


@pytest.mark.parametrize("engine", ["ranks", "one"])
def test_restore_that_strays_from_its_source_fails(engine):
    """A parted restore is still held: on either engine, rows of rid 1000
    beyond the bound of that engine's rid 0 at the matching step fail the
    gate."""
    mine, ref, tokens = _engines()
    rows = mine if engine == "ranks" else ref["one"]
    rows[1000][1] = rows[1000][1] + 1.0
    with pytest.raises(SystemExit):
        CS.tp_logits_gate("tp2 int8", mine, ref, tokens,
                          CS.restore_sources(_traffic()))


def test_restored_first_token_must_be_its_sources():
    """A restore whose first token parted while its source's first token
    did not part (or is not the restore's own) fails the token check."""
    mine, ref, tokens = _engines()
    gate = CS.tp_logits_gate("tp2 int8", mine, ref, tokens,
                             CS.restore_sources(_traffic()))
    gate[0] = dict(gate[0], parted_at=1)
    with pytest.raises(SystemExit):
        CS.tp_tokens_check("tp2 int8", tokens, ref["tokens"], gate, [1000],
                           {"bound": ref["bound"], "one_rank_vs_f32": 0.1})
    gate = CS.tp_logits_gate("tp2 int8", mine, ref, tokens,
                             CS.restore_sources(_traffic()))
    tokens[1000][0] = 13
    with pytest.raises(SystemExit):
        CS.tp_tokens_check("tp2 int8", tokens, ref["tokens"], gate, [1000],
                           {"bound": ref["bound"], "one_rank_vs_f32": 0.1})


# ------------------------- the restore itself: port against the reference

PAGE = 16
KNOBS = dict(n_slots=2, max_seq=64, prefill_chunk=8,
             tier_topology=("dram", "ssd-fast"))
PROMPT = [5, 17, 42, 9, 77, 3, 120, 64, 8, 31, 2, 99, 14, 250, 6, 71, 33]


def _force(engine, rid, token):
    """Flush ``rid``'s retired entry to the store and set its first token
    to ``token``."""
    for _ in range(10):
        if rid in engine.store.pages:
            break
        engine.flusher.maybe_flush()
    engine.store.pages[rid]["first_token"] = token


def _forced_run(engine, request_cls):
    """rid 0 served, its entry's first token forced to another one, then
    rid 1000 (its prompt again: a restore) and rid 2000 (the prompt with
    the forced token appended: a fresh prefill). Returns every request's
    tokens, the forced token and which requests were restored."""
    def serve(rid, prompt, n):
        engine.submit(request_cls(rid=rid, prompt=list(prompt),
                                  max_new_tokens=n))
        engine.run(max_ticks=200)
    serve(0, PROMPT, 6)
    first = engine.finished[-1].generated[0]
    forced = (first + 1) % 256
    _force(engine, 0, forced)
    serve(1000, PROMPT, 5)
    serve(2000, PROMPT + [forced], 4)
    return ({r.rid: list(r.generated) for r in engine.finished}, forced,
            sorted(r.rid for r in engine.finished if r.restored))


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_restore_continues_from_its_entrys_first_token(host_mesh, kv_quant):
    cfg = dataclasses.replace(jreg.smoke("qwen3-1.7b"), dtype="float32")
    rc = RunConfig(model=cfg, shape=SHAPES["decode_32k"], mesh=MeshConfig(),
                   kv_page_size=PAGE)
    with jax.set_mesh(host_mesh):
        params = JM.init_model(jax.random.PRNGKey(0), cfg)
        want = _forced_run(JEngine(params, cfg, rc, kv_quant=kv_quant,
                                   **KNOBS), JRequest)
    tcfg = dataclasses.replace(treg.smoke("qwen3-1.7b"), dtype="float32")
    trc = TRunConfig(model=tcfg, shape=TSHAPES["decode_32k"],
                     mesh=TMeshConfig(), kv_page_size=PAGE)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    got = _forced_run(TEngine(tparams, tcfg, trc, device="cpu",
                              kv_quant=kv_quant, **KNOBS), TRequest)
    assert got == want
    toks, forced, restored = got
    assert restored == [1000]
    assert toks[1000][0] == forced != toks[0][0]
    # conditioned on the forced token: the fresh prompt ending in it
    assert toks[1000][1:] == toks[2000]
