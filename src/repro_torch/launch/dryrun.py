"""The dry run on the production meshes: one rank's step counted on meta
tensors, for every (arch x shape x mesh) cell.

The port's counterpart of the reference's ``repro.launch.dryrun``, which
lowers and compiles each cell on 512 forced host devices and reads XLA's
analyses. The port runs one process a rank, so a cell here is the
program of one rank -- rank 0 of the (16, 16) mesh or, with
``--multi-pod``, of the (2, 16, 16) one (``launch.mesh.
make_production_mesh``) -- run once on the meta device: the step that
``launch.steps.assemble`` builds, on this rank's state, rows and cache,
with no data and no card. What it records keeps the reference's keys:

* ``memory_analysis``: ``argument_size_in_bytes`` (this rank's state,
  rows and cache), ``output_size_in_bytes`` (what the step returns),
  ``alias_size_in_bytes`` (the outputs that are donated arguments
  updated in place: the train state, the decode cache),
  ``temp_size_in_bytes`` (the peak of the bytes the step allocates
  beyond its arguments while it runs) and
  ``generated_code_size_in_bytes`` (null: eager mode compiles nothing).
  Leaves on the HOST tier (``--set enable_host_tier=True
  param_tier=host``) count as ``host_argument_size_in_bytes``, not as
  the card's;
* ``module``: ``flops`` (``torch.utils.flop_counter`` over every aten op,
  plus each kernel's own closed form, ``kernels.meta``),
  ``bytes_accessed`` (every op's operands and outputs, eager and unfused:
  an upper bound on XLA's fused count; the kernels' by their ``cost``)
  and ``collective_bytes`` by the reference's kinds with ``count``, from
  the rank's groups (``launch.mesh.RECORD``); ``kernels``: each kernel's
  launches, flops and bytes;
* ``model_flops``, ``n_stacked``, ``n_devices``, ``compile_s`` (here the
  count's wall time), and with ``--cost`` the reference's ``corrected``
  (``reduced_depth_cfg``, ``_combine``, ``_polyfit_cost``).

Eager mode runs every layer, so ``module`` already counts each layer
once per layer (the reference's raw module counts a scan body once):
``corrected`` equals ``module`` but where a fit over short sequences
stands in for a long one.

Usage (no card and no JAX needed; ``--out`` defaults to
``artifacts/dryrun_torch``)::

  PYTHONPATH=src python -m repro_torch.launch.dryrun             # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape decode_32k --cost
  PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import registry
from repro_torch.configs.base import (MeshConfig, RunConfig, SHAPES,
                                      ShapeConfig, shape_applicable)
from repro_torch.kernels import meta as kmeta
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import model as M
from repro_torch.parallel import sharding

ART = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute", "broadcast")
# ops that move no bytes of their own: they make a tensor without writing
# it, or read only metadata
_NO_TRAFFIC = {torch.ops.aten.empty.memory_format,
               torch.ops.aten.empty_strided.default,
               torch.ops.aten.empty_like.default,
               torch.ops.aten.new_empty.default,
               torch.ops.aten.new_empty_strided.default,
               torch.ops.aten.detach.default,
               torch.ops.aten.lift_fresh.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tensors_of(tree):
    """The tensors under ``tree``: its leaves, a module's parameters and
    buffers."""
    out = []
    for x in tree_flatten(tree)[0]:
        if isinstance(x, nn.Module):
            out.extend(x.parameters())
            out.extend(x.buffers())
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


class _Traffic(TorchDispatchMode):
    """Every aten op's operand and output bytes (views and allocations
    without a write excepted) and the bytes the ops allocate: each new
    storage is live from the op that made it until it is freed, the
    peak kept (the step's temporaries beyond its arguments)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = tensors_of((args, kwargs))
        outs = tensors_of(out)
        if not (func.is_view or func in _NO_TRAFFIC):
            self.bytes += (sum(_nbytes(t) for t in {id(t): t for t in ins}
                               .values()) + sum(_nbytes(t) for t in outs))
        if func.is_view:
            return out
        held = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in held or key in self._held:
                continue
            n = st.nbytes()
            self._held[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return out

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)


class _Kernels:
    """The kernels' charges (``kernels.meta``) by name."""

    def __init__(self):
        self.by_name: Dict[str, Dict[str, float]] = {}

    def kernel(self, name: str, flops: float, n_bytes: float) -> None:
        row = self.by_name.setdefault(name, {"launches": 0, "flops": 0,
                                             "bytes": 0})
        row["launches"] += 1
        row["flops"] += flops
        row["bytes"] += n_bytes


def collective_bytes(records) -> Dict[str, int]:
    """The records' (``launch.mesh.RECORD``) payload bytes by kind, and
    their ``count``: the reference's ``collective_bytes`` keys."""
    out = dict.fromkeys(KINDS, 0)
    out["count"] = 0
    for kind, _, n in records:
        out[kind] += n
        out["count"] += 1
    return out


def _is_host(t: torch.Tensor) -> bool:
    return sharding.host_target(t) is not None


def _arg_bytes(args) -> Dict[str, int]:
    """Bytes of the distinct storages under ``args``: on the card, and
    on the HOST tier (leaves marked for streaming)."""
    seen, card, host = set(), 0, 0
    for t in tensors_of(args):
        key = id(t.untyped_storage())
        if key in seen:
            continue
        seen.add(key)
        if _is_host(t):
            host += t.untyped_storage().nbytes()
        else:
            card += t.untyped_storage().nbytes()
    return {"card": card, "host": host}


def count_step(cell: steps_lib.LoweredCell) -> Dict:
    """Run ``cell.step(*cell.args)`` once under the counts: its flops,
    bytes, collectives (the ``RECORD`` entries), kernels and memory, with
    the reference's keys, and what the step returned (``outputs``)."""
    args = cell.args
    arg = _arg_bytes(args)
    donated = {id(t.untyped_storage()) for i in cell.donated
               for t in tensors_of(args[i])}
    kern = _Kernels()
    records = []
    out = None
    mesh_lib.RECORD, saved = records, mesh_lib.RECORD
    kmeta.COUNTS.append(kern)
    try:
        with FlopCounterMode(display=False) as flops, _Traffic() as traffic:
            out = cell.step(*args)
            outs = tensors_of(out)
    finally:
        kmeta.COUNTS.remove(kern)
        mesh_lib.RECORD = saved
    seen, out_bytes, alias = set(), 0, 0
    for t in outs:
        key = id(t.untyped_storage())
        if key in seen:
            continue
        seen.add(key)
        if _is_host(t):
            continue
        out_bytes += t.untyped_storage().nbytes()
        alias += t.untyped_storage().nbytes() if key in donated else 0
    k_flops = sum(r["flops"] for r in kern.by_name.values())
    k_bytes = sum(r["bytes"] for r in kern.by_name.values())
    return {
        "module": {"flops": float(flops.get_total_flops() + k_flops),
                   "bytes_accessed": float(traffic.bytes + k_bytes),
                   "collective_bytes": collective_bytes(records)},
        "memory_analysis": {
            "argument_size_in_bytes": arg["card"],
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": traffic.peak,
            "generated_code_size_in_bytes": None,
            "alias_size_in_bytes": alias,
            "host_argument_size_in_bytes": arg["host"]},
        "kernels": kern.by_name,
        "collectives": records,
        "outputs": out,
    }


def reduced_depth_cfg(cfg, k: int):
    """Config with n_stacked == k (k stacked steps), same family/width."""
    if cfg.family in ("dense", "moe", "audio"):
        return dataclasses.replace(cfg, n_layers=k)
    if cfg.family == "vlm":
        return dataclasses.replace(cfg, n_layers=k * cfg.cross_attn_period)
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg,
                                   n_layers=k * cfg.shared_block_period)
    return dataclasses.replace(cfg, n_layers=k * cfg.slstm_every)  # ssm


def _extract(count: Dict) -> Dict:
    m = count["module"]
    return {"flops": m["flops"], "bytes_accessed": m["bytes_accessed"],
            "collective_bytes": dict(m["collective_bytes"])}


def _combine(e2: dict, e3: dict, n: int) -> dict:
    """edges + n * body, where body = e3 - e2 (the reference's, depths 2
    and 3)."""
    out = {}
    for key in ("flops", "bytes_accessed"):
        body = e3[key] - e2[key]
        out[key] = max(e2[key] - 2 * body + n * body, 0.0)
    coll = {}
    for k in e2["collective_bytes"]:
        body = e3["collective_bytes"][k] - e2["collective_bytes"][k]
        coll[k] = max(e2["collective_bytes"][k] - 2 * body + n * body, 0.0)
    out["collective_bytes"] = coll
    return out


def _polyfit_cost(pts: dict, target_seq: int) -> dict:
    """Each cost term at ``target_seq`` from short-sequence samples (the
    reference's): 2 points affine, 3 quadratic; a Vandermonde solve per
    term."""
    import numpy as np
    seqs = sorted(pts)
    deg = len(seqs) - 1
    V = np.vander(np.array(seqs, float), deg + 1, increasing=True)

    def fit(vals):
        coef = np.linalg.solve(V, np.array(vals, float))
        return float(max(sum(c * target_seq ** i
                             for i, c in enumerate(coef)), 0.0))

    out = {"flops": fit([pts[s]["flops"] for s in seqs]),
           "bytes_accessed": fit([pts[s]["bytes_accessed"] for s in seqs])}
    out["collective_bytes"] = {
        k: fit([pts[s]["collective_bytes"][k] for s in seqs])
        for k in pts[seqs[0]]["collective_bytes"]}
    return out


# Sequence lengths the --cost fits sample for the recurrent families past
# 2048 tokens (the reference's laws: affine for xLSTM, quadratic for the
# hybrid's shared attention). xLSTM's sLSTM runs token by token on meta
# too, so its points are short: the count's wall time grows with them.
FIT_SEQS = {"ssm": (256, 512), "hybrid": (512, 1024, 2048)}


def fit_seqs(cfg, shape: ShapeConfig):
    """The fit's points for a cell, or None where the cell is counted
    at its own length."""
    if shape.kind == "decode" or shape.seq_len <= 2048:
        return None
    return FIT_SEQS.get(cfg.family)


def _count_cell(cfg, shape, rc, mesh):
    return count_step(steps_lib.assemble(cfg, shape, rc, mesh))


def corrected_cost(cfg, shape: ShapeConfig, rc: RunConfig, mesh) -> Dict:
    """The reference's ``corrected``: depths 2 and 3 combined to
    ``n_stacked`` (``_combine``), at the cell's length or fitted over
    ``fit_seqs``' (``_polyfit_cost``)."""
    def extract_at(seq_len):
        shape_s = (dataclasses.replace(shape, seq_len=seq_len) if seq_len
                   else shape)
        e = {}
        for k in (2, 3):
            cfg_k = reduced_depth_cfg(cfg, k)
            rc_k = dataclasses.replace(rc, model=cfg_k)
            e[k] = _extract(_count_cell(cfg_k, shape_s, rc_k, mesh))
        return _combine(e[2], e[3], M.n_stacked(cfg))

    seqs = fit_seqs(cfg, shape)
    if seqs is None:
        return {"corrected": extract_at(None)}
    pts = {s: extract_at(s) for s in seqs}
    return {"corrected": _polyfit_cost(pts, shape.seq_len),
            "cost_fit_seqs": list(seqs)}


def model_flops(cfg, shape: ShapeConfig) -> int:
    """6 N_active D to train (forward and backward), 2 N_active D for a
    forward (the reference's)."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    return (6 if shape.kind == "train" else 2) * cfg.n_active_params() \
        * tokens


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             rc_overrides: Optional[dict] = None, verbose: bool = True,
             with_cost: bool = False) -> Dict:
    """One cell: rank 0 of the production mesh counted on meta."""
    cfg = registry.get(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": why}
    rc = RunConfig(model=cfg, shape=shape, mesh=MeshConfig(
        multi_pod=multi_pod), **(rc_overrides or {}))
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    got = _count_cell(cfg, shape, rc, mesh)
    t_count = time.time() - t0
    res = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": mesh.world.size,
        "status": "ok",
        "compile_s": round(t_count, 2),
        "module": got["module"],
        "memory_analysis": got["memory_analysis"],
        "kernels": got["kernels"],
        "n_stacked": M.n_stacked(cfg),
        "model_flops": model_flops(cfg, shape),
        "rc": dict(rc_overrides or {}),
    }
    if with_cost:
        t1 = time.time()
        res.update(corrected_cost(cfg, shape, rc, mesh))
        res["cost_extract_s"] = round(time.time() - t1, 2)
    if verbose:
        mem = res["memory_analysis"]
        mod = res["module"]
        print(f"  mem={mem}")
        print(f"  module: flops={mod['flops']:.3e} "
              f"bytes={mod['bytes_accessed']:.3e} "
              f"coll={mod['collective_bytes']}")
        if with_cost:
            c = res["corrected"]
            print(f"  corrected: flops={c['flops']:.3e} "
                  f"bytes={c['bytes_accessed']:.3e}")
            print(f"  model_flops={res['model_flops']:.3e} useful="
                  f"{res['model_flops'] / max(c['flops'] * res['n_devices'], 1):.3f}")
    return res


def parse_overrides(pairs) -> dict:
    """``k=v`` strings as RunConfig overrides: True / False, ints, else
    strings (the reference's ``--set``)."""
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        if v in ("True", "False"):
            v = v == "True"
        else:
            try:
                v = int(v)
            except ValueError:
                pass
        out[k] = v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true",
                    help="run single-pod AND multi-pod for each cell")
    ap.add_argument("--tag", default=None,
                    help="artifact suffix for rc-override variants")
    ap.add_argument("--set", nargs="*", default=[],
                    help="RunConfig overrides k=v (int/bool/str)")
    ap.add_argument("--cost", action="store_true",
                    help="also the reference's per-layer corrected costs")
    ap.add_argument("--out", default=str(ART),
                    help="directory of the cells' JSON files")
    args = ap.parse_args(argv)

    overrides = parse_overrides(args.set)
    archs = [args.arch] if args.arch else sorted(registry.ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape_name}__{'mp' if mp else 'sp'}"
                if args.tag:
                    tag += f"__{args.tag}"
                print(f"[dryrun] {tag}", flush=True)
                try:
                    res = run_cell(arch, shape_name, multi_pod=mp,
                                   rc_overrides=overrides,
                                   with_cost=args.cost)
                except Exception as e:  # a failure here is a sharding bug
                    traceback.print_exc()
                    res = {"arch": arch, "shape": shape_name,
                           "mesh": "2x16x16" if mp else "16x16",
                           "status": "failed", "error": str(e)[-2000:]}
                    failures += 1
                (out / f"{tag}.json").write_text(json.dumps(res, indent=1))
                print(f"  -> {res['status']}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
