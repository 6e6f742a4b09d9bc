"""Training driver: data -> step -> telemetry -> checkpoint, fault-aware.

The paper's controller appears as the between-step adaptation loop of the
reference (``repro/launch/train.py``): step variants are built for a
ladder of (sr_prefetch_depth, sr_granularity) settings, and each step's
telemetry (wall time against the roofline expectation, staging occupancy)
drives the DevLoad state machine (``core.qos.RuntimeQoS``), which picks
the active variant. The expectation divides by the H100's dense bf16 peak.
``Heartbeat`` and ``StragglerMitigator`` watch the one worker; the state
checkpoints asynchronously and resumes from the latest step.

Usage (smoke size on the CPU; drop ``--smoke --device cpu`` for the full
model on the card, 8 sequences of the shape's length a step):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --smoke --device cpu --steps 20
"""
from __future__ import annotations

import argparse
import dataclasses
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
from repro_torch.launch import steps as steps_lib
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import Heartbeat, StragglerMitigator

# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet), flop/s
PEAK_FLOPS_BF16 = 989e12


def build_variants(cfg: ModelConfig, rc: RunConfig,
                   opt_cfg: adamw.AdamWConfig, ladder=None) -> Dict:
    """Step variants keyed by (depth, granularity). On one rank the layer
    stream moves no weights in training, so depth and granularity change
    nothing and every rung shares one step."""
    ladder = ladder or [(0, 1), (1, 1), (2, 1), (1, 2)]
    step = steps_lib.build_train_step(cfg, rc, opt_cfg)
    return {rung: step for rung in ladder}


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
    """Copy a checkpointed flat map into ``state`` (in place)."""
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
          device="cuda") -> Dict:
    """Train ``arch`` (its smoke config with ``smoke``) for ``steps``
    steps on ``device``. The batch is ``global_batch`` sequences of
    ``seq_len`` tokens (default 64 at smoke size, the shape's own length
    at full size, where one card holds 8 sequences of ``train_4k``, not
    its 256)."""
    dev = resolve_device(device)
    cfg = registry.smoke(arch) if smoke else registry.get(arch)
    M.check_trainable(cfg)
    base_shape = SHAPES[shape_name]
    seq_len = seq_len or (64 if smoke else base_shape.seq_len)
    shape = dataclasses.replace(base_shape, global_batch=global_batch,
                                seq_len=seq_len)
    rc = RunConfig(model=cfg, shape=shape, mesh=MeshConfig())
    opt_cfg = adamw.AdamWConfig(learning_rate=rc.learning_rate,
                                total_steps=max(steps, 10))
    params = M.init_model(cfg, seed=rc.seed, device=dev)
    state = steps_lib.init_state(params, rc, opt_cfg)
    data_cfg = DataConfig(
        vocab_size=cfg.vocab_size, global_batch=shape.global_batch,
        seq_len=shape.seq_len, seed=rc.seed,
        n_codebooks=cfg.n_codebooks if cfg.family == "audio" else 0,
        vision_tokens=cfg.n_vision_tokens if cfg.family == "vlm" else 0,
        d_model=cfg.d_model)

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if ckpt and resume and ckpt.latest_step() is not None:
        start_step, flat, _ = ckpt.restore(device=dev)
        state = load_state_dict(state, flat)
        print(f"[train] resumed from step {start_step}")

    pipe = Pipeline(data_cfg, start_step=start_step, device=dev)
    variants = build_variants(cfg, rc, opt_cfg)
    qos = RuntimeQoS(list(variants))
    active = (rc.sr_prefetch_depth, rc.sr_granularity)

    # roofline expectation for the telemetry's service ratio (one card)
    tokens = shape.global_batch * shape.seq_len
    exp_s = 6 * cfg.n_active_params() * tokens / PEAK_FLOPS_BF16

    hb = Heartbeat(n_workers=1)
    strag = StragglerMitigator()
    history = []
    for _ in range(steps):
        step_idx, batch = next(pipe)
        t0 = time.time()
        state, metrics = variants[active](state, batch)
        loss = float(metrics["loss"])    # sync point
        dt = time.time() - t0
        hb.stamp(0, step_idx, dt)
        strag.assess(hb.step_times())
        active = qos.observe(StepTelemetry(
            step=step_idx, wall_time_s=dt, expected_time_s=exp_s,
            staging_occupancy=0.0))
        if active not in variants:
            active = min(variants, key=lambda v: abs(v[0] - active[0]))
        history.append({"step": step_idx, "loss": loss, "dt": dt,
                        "variant": active})
        if step_idx % log_every == 0:
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
