"""Training driver: data -> step -> telemetry -> checkpoint, fault-aware.

The paper's controller appears as the between-step adaptation loop of the
reference (``repro/launch/train.py``): step variants are built for a
ladder of (sr_prefetch_depth, sr_granularity) settings, and each step's
telemetry (wall time against the roofline expectation, staging occupancy)
drives the DevLoad state machine (``core.qos.RuntimeQoS``), which picks
the active variant. The expectation divides by the H100's dense bf16 peak.
``Heartbeat`` and ``StragglerMitigator`` watch the workers; the state
checkpoints asynchronously and resumes from the latest step.

Over a rank mesh (``train_ranks(arch, mesh_shape=(D, N))`` or ``(P, D,
N)``: one process per rank, spawned as ``serve_ranks`` spawns them) each
rank trains its shard of the weights and of the optimizer state -- its
model rank's part of every leaf ``param_specs`` splits on "model"
(the dense, audio and MoE families), cut again to its FSDP part on the
POOL tier -- on its data row's rows of every global batch
(``launch.steps``); every rank stamps
the heartbeat with every rank's step time (one all-gather a step), and
the QoS loop reads the slowest, so every rank picks the same variant.
Each rank checkpoints its own shard under ``<ckpt_dir>/rank_<r>``; a
resume on the same mesh continues as the uninterrupted run does.

Usage (smoke size on the CPU; drop ``--smoke --device cpu`` for the full
model on the card, 8 sequences of the shape's length a step):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --smoke --device cpu --steps 20

The mesh has no CLI flag, as the reference's CLI has none: call
``train_ranks`` from Python (README).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile
import time
from typing import Dict, Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import registry
from repro_torch.configs.base import (MeshConfig, ModelConfig, RunConfig,
                                      SHAPES)
from repro_torch.core.qos import RuntimeQoS, StepTelemetry
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import Heartbeat, StragglerMitigator

# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet), flop/s
PEAK_FLOPS_BF16 = 989e12


def build_variants(cfg: ModelConfig, rc: RunConfig,
                   opt_cfg: adamw.AdamWConfig, ladder=None,
                   mesh=None) -> Dict:
    """Step variants keyed by (depth, granularity), a step built for each
    rung: the same numbers on other schedules. On the HOST tier the depth
    is how many layers ahead of use each layer is copied onto the card
    (in the forward pass, and in the backward pass ahead of each
    recompute); the POOL tier's gathers run in line, in each remat'd
    body, whatever the depth. The granularity splits each layer's gathers
    into that many all-gathers over the FSDP axes of a ``mesh``. On one
    rank with the weights on the card neither moves any weight."""
    ladder = ladder or [(0, 1), (1, 1), (2, 1), (1, 2)]
    return {(d, g): steps_lib.build_train_step(
        cfg, dataclasses.replace(rc, sr_prefetch_depth=d, sr_granularity=g),
        opt_cfg, mesh=mesh) for d, g in ladder}


def state_dict(state: steps_lib.TrainState) -> Dict:
    """The training state as a flat name -> tensor map (the
    checkpointer's form): parameters, AdamW step, moments and masters,
    int8-EF residuals, each keyed by its parameter's name."""
    names = [n for n, _ in state.params.named_parameters()]
    out = {f"params/{n}": p.detach()
           for n, p in state.params.named_parameters()}
    out["opt/step"] = state.opt.step
    lists = {"opt/m": state.opt.m, "opt/v": state.opt.v,
             "opt/master": state.opt.master, "residuals": state.residuals}
    for prefix, tensors in lists.items():
        for n, t in zip(names, tensors or ()):
            out[f"{prefix}/{n}"] = t
    return out


@torch.no_grad()
def load_state_dict(state: steps_lib.TrainState,
                    flat: Dict) -> steps_lib.TrainState:
    """Copy a checkpointed flat map into ``state`` (in place: a HOST-tier
    tensor keeps its pinned host memory, a card tensor its card
    memory)."""
    names = [n for n, _ in state.params.named_parameters()]
    for n, p in state.params.named_parameters():
        p.copy_(flat[f"params/{n}"])
    lists = {"opt/m": state.opt.m, "opt/v": state.opt.v,
             "opt/master": state.opt.master, "residuals": state.residuals}
    for prefix, tensors in lists.items():
        for n, t in zip(names, tensors or ()):
            t.copy_(flat[f"{prefix}/{n}"])
    opt = state.opt._replace(step=flat["opt/step"].to(state.opt.step.device))
    return state._replace(opt=opt)


def train(arch: str, *, smoke: bool = True, steps: int = 20,
          shape_name: str = "train_4k", ckpt_dir: Optional[str] = None,
          global_batch: int = 8, seq_len: Optional[int] = None,
          log_every: int = 5, resume: bool = False,
          device="cuda", mesh=None, param_tier: str = "pool",
          optimizer_tier: str = "pool",
          enable_host_tier: bool = False) -> Dict:
    """Train ``arch`` (its smoke config with ``smoke``) for ``steps``
    steps on ``device``. The batch is
    ``global_batch`` sequences of ``seq_len`` tokens (default 64 at smoke
    size, the shape's own length at full size, where one card holds 8
    sequences of ``train_4k``, not its 256). On a rank ``mesh``
    (``launch.mesh.RankMesh``) this process is one rank: its shard of
    the state (on the model axis too), its data row's rows of each batch
    (the reference's ``MeshConfig()``: pod ranks are replicas); rank 0
    prints. ``param_tier`` / ``optimizer_tier`` place the weights and the
    optimizer state (``core.hdm``); with ``enable_host_tier`` a "host"
    tier keeps them in pinned host memory, streamed through the card.
    A resume restores the checkpoint to host memory and copies it into
    the state in place, so no HOST-tier leaf passes through the card
    whole."""
    dev = resolve_device(device)
    cfg = registry.smoke(arch) if smoke else registry.get(arch)
    base_shape = SHAPES[shape_name]
    seq_len = seq_len or (64 if smoke else base_shape.seq_len)
    shape = dataclasses.replace(base_shape, global_batch=global_batch,
                                seq_len=seq_len)
    rc = RunConfig(model=cfg, shape=shape, mesh=MeshConfig(),
                   param_tier=param_tier, optimizer_tier=optimizer_tier,
                   enable_host_tier=enable_host_tier)
    M.check_trainable(cfg, mesh.shape if mesh is not None else ())
    opt_cfg = adamw.AdamWConfig(learning_rate=rc.learning_rate,
                                total_steps=max(steps, 10))
    params = M.init_model(cfg, seed=rc.seed, device=dev)
    state = steps_lib.init_state(params, rc, opt_cfg, mesh=mesh)
    del params
    group = steps_lib.batch_group(rc, mesh)
    rows = (0, 1) if group is None else (group.rank, group.size)
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.world.size)
    verbose = rank == 0
    data_cfg = DataConfig(
        vocab_size=cfg.vocab_size, global_batch=shape.global_batch,
        seq_len=shape.seq_len, seed=rc.seed,
        n_codebooks=cfg.n_codebooks if cfg.family == "audio" else 0,
        vision_tokens=cfg.n_vision_tokens if cfg.family == "vlm" else 0,
        d_model=cfg.d_model)

    if ckpt_dir and mesh is not None:
        ckpt_dir = os.path.join(ckpt_dir, f"rank_{rank}")
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if ckpt and resume and ckpt.latest_step() is not None:
        start_step, flat, _ = ckpt.restore(device="cpu")
        state = load_state_dict(state, flat)
        if verbose:
            print(f"[train] resumed from step {start_step}")

    pipe = Pipeline(data_cfg, start_step=start_step, device=dev, rows=rows)
    variants = build_variants(cfg, rc, opt_cfg, mesh=mesh)
    qos = RuntimeQoS(list(variants))
    active = (rc.sr_prefetch_depth, rc.sr_granularity)

    # roofline expectation for the telemetry's service ratio (one card)
    tokens = shape.global_batch * shape.seq_len
    exp_s = 6 * cfg.n_active_params() * tokens / PEAK_FLOPS_BF16

    hb = Heartbeat(n_workers=world)
    strag = StragglerMitigator()
    history = []
    for _ in range(steps):
        step_idx, batch = next(pipe)
        t0 = time.time()
        state, metrics = variants[active](state, batch)
        loss = float(metrics["loss"])    # sync point
        dt = time.time() - t0
        times = [dt] if mesh is None else mesh.world.all_gather(
            torch.tensor([dt], dtype=torch.float64,
                         device=mesh.device)).reshape(-1).tolist()
        for w, t in enumerate(times):
            hb.stamp(w, step_idx, t)
        strag.assess(hb.step_times())
        active = qos.observe(StepTelemetry(
            step=step_idx, wall_time_s=max(times), expected_time_s=exp_s,
            staging_occupancy=0.0))
        if active not in variants:
            active = min(variants, key=lambda v: abs(v[0] - active[0]))
        history.append({"step": step_idx, "loss": loss, "dt": dt,
                        "variant": active})
        if verbose and step_idx % log_every == 0:
            print(f"[train] step={step_idx} loss={loss:.4f} "
                  f"dt={dt*1e3:.0f}ms variant={active}", flush=True)
        if ckpt and step_idx and step_idx % 50 == 0:
            ckpt.save(step_idx, state_dict(state), extra=pipe.state())
    if ckpt:
        ckpt.save(steps - 1 + start_step, state_dict(state),
                  extra=pipe.state(), blocking=True)
    pipe.close()
    return {"history": history, "state": state,
            "final_loss": history[-1]["loss"] if history else None}


def _train_rank(rank_mesh, arch, kwargs):
    """One rank of ``train_ranks``: its history and its shard of the
    final state as plain data (numpy, by parameter name)."""
    run = train(arch, device=rank_mesh.device, mesh=rank_mesh, **kwargs)
    flat = {k: (None if v is None else v.detach().cpu().float().numpy())
            for k, v in state_dict(run["state"]).items()}
    return {"history": run["history"], "final_loss": run["final_loss"],
            "state": flat, "coords": rank_mesh.coords}


def train_ranks(arch: str, *, mesh_shape, device="cuda",
                timeout_s: float = 3600.0, **kwargs):
    """``train`` on the ranks of a ``mesh_shape`` mesh ((D, N) or (P, D,
    N)), spawned as ``launch.serve.serve_ranks`` spawns them (a
    ``file://`` rendezvous in a new temporary directory, each rank given
    its ``RankMesh``); rank 0 prints. Returns each rank's history and its
    shard of the final state (``state_dict`` names, numpy)."""
    shape = mesh_lib.mesh_shape3(mesh_shape)
    with tempfile.TemporaryDirectory() as rendezvous:
        return mesh_lib.spawn(_train_rank, math.prod(shape), (arch, kwargs),
                              rendezvous_dir=rendezvous,
                              device=resolve_device(device).type,
                              timeout_s=timeout_s, mesh_shape=shape)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config of the same family")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only on request)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=None,
                    help="default 64 with --smoke, else the shape's")
    args = ap.parse_args(argv)
    out = train(args.arch, smoke=args.smoke, steps=args.steps,
                shape_name=args.shape, ckpt_dir=args.ckpt_dir,
                resume=args.resume, global_batch=args.global_batch,
                seq_len=args.seq_len, device=args.device)
    print(f"[train] done: final_loss={out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
