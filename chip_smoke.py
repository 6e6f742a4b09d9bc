#!/usr/bin/env python3
"""On-card smoke of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository around it; imports neither
``jax`` nor the JAX package. Phases, each fatal on failure:

1. print the card (``nvidia-smi`` name and power limit) and build the CUDA
   kernels from ``src/repro_torch/csrc`` (timed);
2. hold each kernel against its plain PyTorch version on the card at the
   serving path's shapes in bf16 (atol = rtol = 2e-2), and time kernel,
   plain version and one PyTorch library call (SDPA) with CUDA events;
   then run the smoke-size model (f32) through chunked prefill and ragged
   decode on the card and on the CPU from the same weights, and hold
   logits and caches together (atol = rtol = 3e-5);
3. serve qwen3-1.7b at full width (random bf16 weights drawn on the card
   from a seed; 8 slots, 2048-token slots, 256-token prefill chunks, a
   DRAM + SSD CXL tier, greedy): 16 requests of 300-1000 prompt tokens and
   32 new tokens, then 4 of the same prompts again under new rids, served
   by prefix restore;
4. check that every request finished, both kernels ran on that path, the
   restores happened and stalled on the tier, and each restored request's
   greedy tokens equal its first run's;
5. print the measured numbers, one ``kernels`` JSON line, the card line and
   last ``{"ok": true, "device": {...}}``. ``chiprun_out/chip_smoke.json``
   keeps the full record.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
OUT_DIR = os.path.join(ROOT, "chiprun_out")

ARCH = "qwen3-1.7b"
N_SLOTS, MAX_SEQ, CHUNK = 8, 2048, 256
N_REQUESTS, N_RESUBMIT, MAX_NEW = 16, 4, 32
PROMPT_LENS = (300, 1001)
TOPOLOGY = ("dram", "ssd-fast")
SEED = 0
TOL = dict(atol=2e-2, rtol=2e-2)        # bf16, tests/test_kernel_parity.py

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 flop/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms (CUDA events around ``iters``)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, want):
    import torch
    err = float((got.float() - want.float()).abs().max())
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite output")
    if not torch.allclose(got.float(), want.float(), **TOL):
        fail(f"{name}: max abs err {err} beyond atol=rtol=2e-2")
    return err


# ---------------------------------------------------------------- phase 2

def check_decode(dev):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops, ref
    b, p, page, hkv, g, d = N_SLOTS, MAX_SEQ // 256, 256, 8, 2, 128
    h, smax = hkv * g, p * page
    gen = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).bfloat16()
    kp = torch.randn((b, p, page, hkv, d), generator=gen,
                     device=dev).bfloat16()
    vp = torch.randn((b, p, page, hkv, d), generator=gen,
                     device=dev).bfloat16()
    lens = [1, smax, 300, 777, 1024, 1500, 64, smax - 1]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    res = {}
    for cap in (0.0, 30.0):
        got = ops.paged_decode(q, kp, vp, kv_len, logit_softcap=cap)
        want = ref.paged_decode_ref(q, kp, vp, kv_len, cap)
        torch.cuda.synchronize()
        res[f"err_softcap{cap:g}"] = check_close(f"paged_decode cap={cap}",
                                                 got, want)
    got32 = ops.paged_decode(q.float(), kp.float(), vp.float(), kv_len)
    res["err_f32"] = float((got32 - ref.paged_decode_ref(
        q.float(), kp.float(), vp.float(), kv_len)).abs().max())
    if res["err_f32"] > 1e-4:
        fail(f"paged_decode f32 max abs err {res['err_f32']}")
    # SDPA yardstick: the same function, per-slot length as a boolean mask
    # and the kv heads expanded to the query heads beforehand (untimed)
    mask = (torch.arange(smax, device=dev)[None] < kv_len[:, None].long()
            )[:, None, None, :]
    qs = q.transpose(1, 2)                                  # [B, H, 1, D]
    ks, vs = (t.view(b, smax, hkv, d).transpose(1, 2)
              .repeat_interleave(g, dim=1) for t in (kp, vp))

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
    got = ops.paged_decode(q, kp, vp, kv_len)
    res["library_err"] = float((sdpa().transpose(1, 2).float()
                                - got.float()).abs().max())
    res["ms"] = time_ms(lambda: ops.paged_decode(q, kp, vp, kv_len), 50)
    res["plain_ms"] = time_ms(
        lambda: ref.paged_decode_ref(q, kp, vp, kv_len), 10)
    res["library_ms"] = time_ms(sdpa, 50)
    tokens = sum(min(n, smax) for n in lens)
    n_bytes = (2 * tokens * hkv * d * 2 + 2 * q.numel() * 2
               + kv_len.numel() * 4)
    res["bound_ms"], res["bound_by"] = bound(n_bytes, 4 * tokens * h * d)
    res["max_abs_err"] = res["err_softcap0"]
    res["shape"] = (f"q [{b},1,{h},{d}] bf16, pages [{b},{p},{page},{hkv},"
                    f"{d}], kv_len {lens}")
    return res


def check_prefill(dev):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    hkv, g, d, c, smax = 8, 2, 128, CHUNK, MAX_SEQ
    h = hkv * g
    gen = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn((1, c, h, d), generator=gen, device=dev).bfloat16()
    kc = torch.randn((1, smax, hkv, d), generator=gen, device=dev).bfloat16()
    vc = torch.randn((1, smax, hkv, d), generator=gen, device=dev).bfloat16()
    res = {}
    for p0 in (0, 300):
        pos = torch.tensor([p0], dtype=torch.int32, device=dev)
        for cap in (0.0, 30.0):
            got = ops.flash_prefill(q, kc, vc, pos, logit_softcap=cap)
            want = ref.flash_prefill_ref(q, kc, vc, pos, cap)
            torch.cuda.synchronize()
            res[f"err_pos{p0}_softcap{cap:g}"] = check_close(
                f"flash_prefill pos={p0} cap={cap}", got, want)
    # ragged chunk and cache length, f32 instantiation
    qr, kr, vr = q[:, :37].float(), kc[:, :1000].float(), vc[:, :1000].float()
    pr = torch.tensor([951], dtype=torch.int32, device=dev)
    res["err_ragged_f32"] = float((ops.flash_prefill(qr, kr, vr, pr)
                                   - ref.flash_prefill_ref(qr, kr, vr, pr)
                                   ).abs().max())
    if res["err_ragged_f32"] > 1e-4:
        fail(f"flash_prefill ragged f32 err {res['err_ragged_f32']}")
    # timings at the mid-prompt chunk (offset 300, not a block multiple)
    p0 = 300
    pos = torch.tensor([p0], dtype=torch.int32, device=dev)
    got = ops.flash_prefill(q, kc, vc, pos)
    mask = (torch.arange(smax, device=dev)[None]
            <= p0 + torch.arange(c, device=dev)[:, None])   # [C, Smax]
    qs = q.transpose(1, 2)
    ks, vs = (t.transpose(1, 2).repeat_interleave(g, dim=1)
              for t in (kc, vc))

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
    res["library_err"] = float((sdpa().transpose(1, 2).float()
                                - got.float()).abs().max())
    res["ms"] = time_ms(lambda: ops.flash_prefill(q, kc, vc, pos), 20)
    res["plain_ms"] = time_ms(
        lambda: ref.flash_prefill_ref(q, kc, vc, pos), 5)
    res["library_ms"] = time_ms(sdpa, 20)
    visible = sum(p0 + i + 1 for i in range(c))          # (query, key) pairs
    n_bytes = (2 * (p0 + c) * hkv * d * 2 + 2 * q.numel() * 2 + 4)
    res["bound_ms"], res["bound_by"] = bound(n_bytes, 4 * visible * h * d)
    res["max_abs_err"] = res["err_pos300_softcap0"]
    res["shape"] = (f"q [1,{c},{h},{d}] bf16, cache [1,{smax},{hkv},{d}], "
                    f"pos {p0} (also 0)")
    return res


def check_model_small(dev):
    """The whole model step on the card against the same weights on the
    CPU (plain kernel versions; the CPU tests hold that path to the JAX
    reference): smoke-size qwen3-1.7b in f32, chunked prefill with a ragged
    last chunk, then decode ticks with ragged per-slot positions. Returns
    the largest logit and cache differences."""
    import copy
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
    from repro_torch.models import model as M
    cfg = dataclasses.replace(registry.smoke(ARCH), dtype="float32")
    rc = RunConfig(model=cfg, shape=SHAPES["decode_32k"], mesh=MeshConfig(),
                   kv_page_size=8)
    cpu = torch.device("cpu")
    params = {cpu: M.init_model(cfg, seed=SEED, device=cpu)}
    params[dev] = copy.deepcopy(params[cpu]).to(dev)
    caches = {d: M.cache_init(cfg, rc, 2, 64, device=d) for d in params}
    rng = np.random.default_rng(SEED)
    prompt = rng.integers(1, cfg.vocab_size, (2, 21)).astype(np.int32)
    steps = [("prefill", prompt[:, s:s + 8]) for s in range(0, 21, 8)]
    steps += [("decode", rng.integers(1, cfg.vocab_size, (2, 1)).astype(
        np.int32)) for _ in range(4)]
    f32_tol = dict(atol=3e-5, rtol=3e-5)   # tests/test_kernel_parity.py
    err = 0.0
    for i, (kind, toks) in enumerate(steps):
        if i == len(steps) - 4:                   # row 1 runs 5 positions on
            for c in caches.values():
                c["pos"][1] += 5
        logits = {}
        for d in params:
            t = torch.from_numpy(toks).to(d)
            fn = M.prefill_step_cached if kind == "prefill" else M.decode_step
            logits[d], caches[d] = fn(params[d], cfg, rc, t, caches[d])
        got, want = logits[dev].cpu(), logits[cpu]
        if not torch.allclose(got, want, **f32_tol):
            fail(f"small model {kind} step {i}: card logits differ from the "
                 f"CPU by {float((got - want).abs().max())}")
        err = max(err, float((got - want).abs().max()))
    cache_err = 0.0
    for n in ("k", "v"):
        got, want = caches[dev]["kv"][n].cpu(), caches[cpu]["kv"][n]
        cache_err = max(cache_err, float((got - want).abs().max()))
        if not torch.allclose(got, want, **f32_tol):
            fail(f"small model: card {n} cache differs from the CPU by "
                 f"{cache_err}")
    return {"logits_max_abs_err": err, "cache_max_abs_err": cache_err,
            "steps": len(steps)}


# ---------------------------------------------------------------- phase 3

def serve(dev):
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import model as M
    from repro_torch.serving.config import ServeConfig
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = registry.get(ARCH)
    rc = RunConfig(model=cfg, shape=SHAPES["decode_32k"], mesh=MeshConfig())
    t0 = time.time()
    params = M.init_model(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    config = ServeConfig(n_slots=N_SLOTS, max_seq=MAX_SEQ,
                         prefill_chunk=CHUNK, tier_topology=TOPOLOGY,
                         store_budget_bytes=16 << 30, seed=SEED)
    engine = ServingEngine(params, cfg, rc, config=config, device=dev)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(*PROMPT_LENS, N_REQUESTS)]
    torch.cuda.reset_peak_memory_stats(dev)

    # the main path: counts from 0 just before, read just after
    dops.launches = 0
    fops.launches = 0
    t0 = time.time()
    first = [engine.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW))
             for i, p in enumerate(prompts)]
    engine.run(max_ticks=10_000)
    again = [engine.submit(Request(rid=1000 + i, prompt=prompts[i],
                                   max_new_tokens=MAX_NEW))
             for i in range(N_RESUBMIT)]
    engine.run(max_ticks=10_000)
    torch.cuda.synchronize()
    wall_s = time.time() - t0
    launches = {"paged_decode": dops.launches, "flash_prefill": fops.launches}

    st = engine.stats
    out = {"init_s": init_s, "wall_s": wall_s, "launches": launches,
           "requests_done": sum(h.done() for h in first + again),
           "requests": len(first) + len(again),
           "decode_tokens": st["decode_tokens"],
           "prefill_tokens": st["prefill_tokens"],
           "decode_ticks": st["decode_dispatches"],
           "prefill_chunks": st["prefill_dispatches"],
           "tokens_per_s": st["decode_tokens"] / wall_s,
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
           "prefix_hits": st["prefix_hits"],
           "restore_stall_ns": st["restore_stall_ns"],
           "tier_write_ns": st["tier_write_ns"],
           "store_bytes": st["store_bytes"], "flushes": st["flushes"],
           "tier_sr_hit_rate": st["tier_sr_hit_rate"],
           "restored": [h.request.restored for h in again],
           "tokens_equal": [h.result() == first[i].result()
                            for i, h in enumerate(again)
                            if h.done() and first[i].done()]}

    # steady-state costs of the two steps at the path's shapes
    out["decode_tick_ms"] = time_ms(engine._decode_sample, 10)
    kv1 = {n: a[:, :1] for n, a in engine.cache["kv"].items()}
    chunk = torch.tensor([prompts[0][:CHUNK]], dtype=torch.int32,
                         device=dev)

    def prefill_chunk():
        cache1 = {"kv": kv1, "pos": torch.zeros(1, dtype=torch.int32,
                                                device=dev)}
        M.prefill_step_cached(params, cfg, rc, chunk, cache1,
                              last_only=True)
    out["prefill_chunk_ms"] = time_ms(prefill_chunk, 5)

    # the output itself: finite logits of the expected shape
    logits, _ = M.decode_step(params, cfg, rc, engine.last_tokens[:, None],
                              engine.cache)
    torch.cuda.synchronize()
    if tuple(logits.shape) != (N_SLOTS, 1, cfg.vocab_size):
        fail(f"decode logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits.float()).all():
        fail("non-finite decode logits")
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda is not available: this smoke needs the card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run it from a checkout")
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    from repro_torch.kernels import build
    t0 = time.time()
    lib_path = build.build()
    build.library()
    build_s = time.time() - t0
    log(f"kernels built in {build_s:.1f}s -> {lib_path}")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")

    dec = check_decode(dev)
    log(f"paged_decode ok: {dec['shape']}; {dec}")
    pre = check_prefill(dev)
    log(f"flash_prefill ok: {pre['shape']}; {pre}")
    small = check_model_small(dev)
    log(f"small {ARCH} (f32) on the card agrees with the CPU: {small}")

    run = serve(dev)
    log(f"serve {ARCH}: {run['requests_done']}/{run['requests']} requests, "
        f"{run['decode_tokens']} decode + {run['prefill_tokens']} prefill "
        f"tokens in {run['wall_s']:.2f}s ({run['tokens_per_s']:.1f} "
        f"decode tok/s), {run['decode_ticks']} ticks, "
        f"{run['prefill_chunks']} prefill chunks")
    log(f"decode tick {run['decode_tick_ms']:.3f} ms, prefill chunk "
        f"({CHUNK} tokens) {run['prefill_chunk_ms']:.3f} ms, "
        f"max_memory_allocated {run['max_memory_allocated']} bytes, "
        f"weights init {run['init_s']:.1f}s")
    log(f"tier: prefix_hits {run['prefix_hits']}, restore_stall_ns "
        f"{run['restore_stall_ns']}, tier_write_ns {run['tier_write_ns']}, "
        f"store_bytes {run['store_bytes']}, flushes {run['flushes']}, "
        f"sr_hit_rate {run['tier_sr_hit_rate']}")
    log(f"launches on the main path: {run['launches']}")

    if run["requests_done"] != run["requests"]:
        fail(f"only {run['requests_done']}/{run['requests']} finished")
    for name, n in run["launches"].items():
        if n <= 0:
            fail(f"kernel {name} was never launched on the main path")
    if run["prefix_hits"] < N_RESUBMIT or run["restore_stall_ns"] <= 0:
        fail(f"prefix restores missing: hits {run['prefix_hits']}, "
             f"stall {run['restore_stall_ns']}")
    if not all(run["restored"]):
        fail(f"resubmits not restored: {run['restored']}")
    if len(run["tokens_equal"]) != N_RESUBMIT or not all(
            run["tokens_equal"]):
        fail(f"restored greedy tokens differ: {run['tokens_equal']}")

    kernels = []
    for name, res, src, replaces in (
            ("paged_decode", dec, "src/repro_torch/csrc/paged_decode.cu",
             "src/repro/kernels/decode_attention/kernel.py:79"),
            ("flash_prefill", pre, "src/repro_torch/csrc/flash_prefill.cu",
             "src/repro/kernels/flash_attention/kernel.py:77")):
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": run["launches"][name],
                        "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                        "plain_ms": res["plain_ms"],
                        "bound_ms": res["bound_ms"],
                        "bound_by": res["bound_by"],
                        "library_ms": res["library_ms"]})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "build_s": build_s, "decode": dec, "prefill": pre,
                   "small_model": small, "serve": run, "kernels": kernels},
                  f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
