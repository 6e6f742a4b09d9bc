#!/usr/bin/env python3
"""Where the time goes in the port's serving and training steps, on the
card.

    python3 benchmarks/torch_profile.py [--arch qwen3-1.7b] [--ticks 5]
        [--chunks 2] [--kv-quant int8]
    python3 benchmarks/torch_profile.py --train [--arch qwen3-1.7b]
        [--steps 1]

Builds the full-width engine of ``chip_smoke.py`` for ``--arch``
(qwen3-1.7b, zamba2-2.7b or gemma-2b; 8 slots, 2048-token slots, bf16
weights, KV
pages in bf16 or, with ``--kv-quant int8``, int8 codes with per-page
scales; random weights from a seed), fills every slot with a
300-1000-token prompt,
then traces ``--ticks`` decode ticks and ``--chunks`` 256-token prefill
chunks with ``torch.profiler`` (CPU and CUDA activities). Prints, for
each step kind, the wall time per step, the summed device-kernel time
per step, the device idle share and the top device ops, then the
host-clock cost of one slot's retire -> flush -> restore page path;
writes the chrome traces and a JSON record under
``chiprun_out/``. With ``--train`` it instead traces ``--steps`` full
training steps of ``--arch`` at full width (``launch/steps.py``: forward
with remat, backward, AdamW with f32 masters; 8 sequences of 4096 tokens
from the port's ``SyntheticLM``, random bf16 weights from a seed, one
untraced step first) and prints the same step record. Needs one CUDA
card; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
OUT_DIR = os.path.join(ROOT, "chiprun_out")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile(fn, n: int, label: str):
    """Trace ``n`` calls of ``fn``; wall and device time per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    # device kernels only: CPU-side ops (aten::mm, ...) report their
    # children's device time too and would count it twice
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    device_ms = sum(_device_us(e) for e in kernels) / 1e3 / n
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    os.makedirs(OUT_DIR, exist_ok=True)
    prof.export_chrome_trace(os.path.join(OUT_DIR, f"trace_{label}.json"))
    n_launch = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC")) / n
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_idle_share": (max(0.0, 1 - device_ms / wall_ms)
                                  if device_ms else None),
            "runtime_launches_per_step": n_launch,
            "top": [(e.key[:120], _device_us(e) / 1e3 / n, e.count // n)
                    for e in top]}


def host_phases(engine) -> dict:
    """Host-clock seconds of the retire -> flush -> restore page path for
    one full-width slot: device copy of its pages, the copy to host memory
    (``HostPageStore.put``), the simulated tier's flush and restore charges
    (the Python CXL simulator walks every page), and the copy back."""
    import torch
    from repro_torch.core.tier import CxlTier
    sync = torch.cuda.synchronize

    def clock(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return time.perf_counter() - t0, out

    rec = {}
    rec["capture_s"], kv = clock(lambda: engine._capture_slot_kv(0))
    nbytes = CxlTier.entry_bytes(kv)
    rec["entry_bytes"] = nbytes
    rec["store_put_s"], _ = clock(lambda: engine.store.put(
        -1, {"kv": kv, "prompt": ()}))
    tier = engine.serve_config.make_tier()
    rec["tier_write_s"], _ = clock(lambda: tier.write_entry(-1, nbytes))
    tier.advance(engine.tier_step_ns)
    rec["tier_read_s"], _ = clock(lambda: tier.read_entry(-1, nbytes))
    host = engine.store.pages[-1]["kv"]
    rec["restore_copy_s"], _ = clock(lambda: engine._load_slot_kv(0, host))
    engine.store.drop(-1)
    return rec


def print_step(kind: str, r: dict) -> None:
    print(f"[profile] {kind}: wall {r['wall_ms']:.3f} ms/step, device "
          f"{r['device_ms']:.3f} ms/step, idle share "
          f"{r['device_idle_share']}, runtime launches/step "
          f"{r['runtime_launches_per_step']:.0f}")
    for key, ms, count in r["top"]:
        print(f"[profile]   {ms:9.4f} ms  x{count:<5d} {key}")


def profile_train(arch: str, n_steps: int) -> None:
    """Trace full-width training steps of ``arch`` (see the module
    docstring)."""
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    dev = torch.device("cuda", 0)
    cfg = registry.get(arch)
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=8)
    rc = RunConfig(model=cfg, shape=shape, mesh=MeshConfig())
    opt_cfg = adamw.AdamWConfig(learning_rate=3e-4, warmup_steps=0)
    state = steps_lib.init_state(M.init_model(cfg, seed=0, device=dev), rc,
                                 opt_cfg)
    batch = to_device(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, global_batch=shape.global_batch,
        seq_len=shape.seq_len, seed=0)).batch(0), dev)
    step = steps_lib.build_train_step(cfg, rc, opt_cfg)
    holder = {"state": state}

    def one_step():
        holder["state"], metrics = step(holder["state"], batch)
        return float(metrics["loss"])

    torch.cuda.reset_peak_memory_stats()
    rec = {"card": torch.cuda.get_device_name(0), "arch": arch,
           "batch": shape.global_batch, "seq_len": shape.seq_len,
           "train_step": profile(one_step, n_steps, f"{arch}_train_step"),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print_step("train_step", rec["train_step"])
    print(f"[profile] peak memory {rec['peak_gib']:.2f} GiB")
    with open(os.path.join(OUT_DIR, f"torch_profile_{arch}_train.json"),
              "w") as f:
        json.dump(rec, f, indent=1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--ticks", type=int, default=5)
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--kv-quant", default="none", choices=["none", "int8"])
    ap.add_argument("--train", action="store_true",
                    help="trace full-width training steps instead")
    ap.add_argument("--steps", type=int, default=1,
                    help="training steps traced with --train")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda is not available: this profile needs the card")
    if args.train:
        torch.backends.cuda.matmul.allow_tf32 = False
        profile_train(args.arch, args.steps)
        return
    from repro_torch.configs import registry
    from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
    from repro_torch.models import model as M
    from repro_torch.serving.config import ServeConfig
    from repro_torch.serving.engine import Request, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = registry.get(args.arch)
    rc = RunConfig(model=cfg, shape=SHAPES["decode_32k"], mesh=MeshConfig())
    params = M.init_model(cfg, seed=0, device=dev)
    engine = ServingEngine(params, cfg, rc, device=dev, config=ServeConfig(
        n_slots=8, max_seq=2048, prefill_chunk=256,
        tier_topology=("dram", "ssd-fast"), store_budget_bytes=16 << 30,
        kv_quant=args.kv_quant))
    rc = engine.rc
    label = args.arch + ("_int8" if args.kv_quant == "int8" else "")
    rng = np.random.default_rng(0)
    for rid, n in enumerate(rng.integers(300, 1001, 8)):
        engine.submit(Request(rid=rid, max_new_tokens=10_000, prompt=rng
                              .integers(1, cfg.vocab_size, int(n)).tolist()))
    engine.step()                         # admits (prefills) every slot
    torch.cuda.synchronize()

    chunk = torch.randint(1, cfg.vocab_size, (1, 256), device=dev,
                          dtype=torch.int32)

    def prefill_chunk():
        cache1 = M.slot_view(engine.cache, 0)
        cache1["pos"] = torch.full((1,), 300, dtype=torch.int32, device=dev)
        M.prefill_step_cached(params, cfg, rc, chunk, cache1, last_only=True)

    rec = {"card": torch.cuda.get_device_name(0), "arch": args.arch,
           "kv_quant": args.kv_quant,
           "decode_tick": profile(engine._decode_sample, args.ticks,
                                  f"{label}_decode_tick"),
           "prefill_chunk": profile(prefill_chunk, args.chunks,
                                    f"{label}_prefill_chunk"),
           "host_phases": host_phases(engine)}
    for kind in ("decode_tick", "prefill_chunk"):
        print_step(kind, rec[kind])
    print(f"[profile] page path, one slot (host clock): "
          f"{rec['host_phases']}")
    with open(os.path.join(OUT_DIR, f"torch_profile_{label}.json"),
              "w") as f:
        json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
