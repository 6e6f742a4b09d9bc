#!/usr/bin/env python3
"""On-card smoke of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository around it; imports neither
``jax`` nor the JAX package. Phases, each fatal on failure:

1. print the card (``nvidia-smi`` name and power limit) and build the CUDA
   kernels from ``src/repro_torch/csrc`` (timed);
2. hold each kernel against its plain PyTorch version on the card at the
   serving paths' shapes, and time kernel, plain version and, where one
   exists, one PyTorch library call (SDPA, cuBLAS) with CUDA events: the
   two attention kernels in bf16 (atol = rtol = 2e-2) at qwen3-1.7b's
   heads (Hkv 8, 2 query heads each, D 128) and at zamba2-2.7b's (Hkv = H =
   32, D 80); the decode kernel's int8 mode at qwen3's heads (bf16 2e-2,
   int8 pages with their scales, the new row at full precision; its
   yardstick is dequantize + SDPA); the SSD scan in f32 (atol = rtol =
   1e-4, ``y`` and ``h_last``) at zamba2's 80 heads, P = N = 64, from a
   nonzero state, over a 256-token chunk and a ragged 44-token one; the
   paged weight-streaming matmul at qwen3's MLP width (x [8, 2048] and
   [256, 2048], 8 of 16 pages of [256, 6144]; bf16 2e-2, f32 3e-5; no path
   of the reference calls it). Then run the smoke-size qwen3-1.7b and
   zamba2-2.7b (f32), and qwen3-1.7b with int8 pages, through chunked
   prefill and ragged decode on the card and on the CPU from the same
   weights, and hold logits and caches together (int8 codes equal but
   for steps of one, counted);
3. serve qwen3-1.7b at full width (random bf16 weights drawn on the card
   from a seed; 8 slots, 2048-token slots, 256-token prefill chunks, a
   DRAM + SSD CXL tier, greedy): 8 requests of 300-1000 prompt tokens and
   32 new tokens, then 4 of the same prompts again under new rids, served
   by prefix restore; check that every request finished, both attention
   kernels ran on that path, the restores happened and stalled on the
   tier, and each restored request's greedy tokens equal its first run's;
4. zamba2-2.7b at full width (random bf16 weights from the same seed):
   one 256-token prompt through one chunked prefill against 256
   ``decode_step`` calls -- with the weights widened to f32, logits within
   1e-3 and the prompt's greedy token equal; in bf16 the difference is
   reported -- then serve it on the engine of phase 3 (8 requests of
   300-1000 prompt tokens, 32 new tokens; the hybrid is never restored
   from the tier, as in the reference) and check that every request
   finished, pages were flushed, and all three kernels ran on that path;
5. serve qwen3-1.7b at full width with int8 KV pages on the engine and
   traffic of phase 3; check that every request finished, the int8 decode
   kernel ran once per layer per tick and flash_prefill ran, every
   resubmit was restored with its first token and its prompt's full pages
   bit for bit, and a stored entry is under 0.55 of phase 3's bf16 entry;
   then restore the same prompts from entries stored right after prefill
   and check that their greedy tokens equal the first run's;
6. print the measured numbers, one ``kernels`` JSON line, the card line and
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
HYBRID = "zamba2-2.7b"
N_SLOTS, MAX_SEQ, CHUNK = 8, 2048, 256
N_REQUESTS, N_RESUBMIT, MAX_NEW = 8, 4, 32
N_HYBRID_REQUESTS = 8
# an int8 entry over a bf16 one: the reference's gate is 1/itemsize + 0.05
# (tests/test_kv_quant.py:233)
INT8_ENTRY_RATIO = 0.55
# paged_matmul at qwen3-1.7b's MLP width: K = d_model, N = d_ff, 8 logical
# pages of 256 rows drawn from a pool of 16
MATMUL_K, MATMUL_N, MATMUL_PAGE_K, MATMUL_POOL = 2048, 6144, 256, 16
F32_TOL = dict(atol=3e-5, rtol=3e-5)    # tests/test_kernel_parity.py
PROMPT_LENS = (300, 1001)
TOPOLOGY = ("dram", "ssd-fast")
SEED = 0
TOL = dict(atol=2e-2, rtol=2e-2)        # bf16, tests/test_kernel_parity.py
SSD_TOL = dict(atol=1e-4, rtol=1e-4)    # f32, tests/test_kernels.py
# full-width zamba2, chunked vs stepwise prefill in f32: 10x the smoke-size
# f32 bound of tests/test_torch_hybrid.py, for sums over a 54-layer stack
FULL_F32_TOL = dict(atol=1e-3, rtol=1e-3)

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16 flop/s
# (tensor cores), f32 flop/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


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


def bound(n_bytes: float, n_flops: float, peak: float = BF16_FLOPS):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, want, tol=TOL):
    import torch
    err = float((got.float() - want.float()).abs().max())
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite output")
    if not torch.allclose(got.float(), want.float(), **tol):
        fail(f"{name}: max abs err {err} beyond {tol}")
    return err


# ---------------------------------------------------------------- phase 2

def check_decode(dev, hkv, g, d):
    """paged_decode at ``hkv`` kv heads of ``g`` query heads, head_dim
    ``d``, over the serving path's 8 slots of 2048 tokens."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops, ref
    b, p, page = N_SLOTS, MAX_SEQ // 256, 256
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


def check_decode_int8(dev, hkv, g, d):
    """paged_decode's int8 mode at ``hkv`` kv heads of ``g`` query heads,
    head_dim ``d``, over the serving path's 8 slots of 2048 tokens: codes
    quantized from random bf16 K/V with ``kv_quant.requantize_pages``, the
    new token's K/V at ``pos = kv_len - 1``. Also times the bf16 mode at the
    same shapes, and dequantize + SDPA as the library yardstick (no single
    PyTorch call reads int8 pages)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops, ref
    from repro_torch.models import kv_quant
    b, p, page = N_SLOTS, MAX_SEQ // 256, 256
    h, smax = hkv * g, p * page
    gen = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).bfloat16()
    init = torch.full((b, p, hkv), kv_quant.INIT_SCALE, device=dev)
    pages, new = {}, {}
    for name in ("k", "v"):
        x = torch.randn((b, p, page, hkv, d), generator=gen,
                        device=dev).bfloat16()
        pages[name] = kv_quant.requantize_pages(x, init)
        new[name] = torch.randn((b, 1, hkv, d), generator=gen,
                                device=dev).bfloat16()
    (kc, ks), (vc, vs) = pages["k"], pages["v"]
    lens = [1, smax, 300, 777, 1024, 1500, 64, smax - 1]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    pos = kv_len - 1
    args = dict(k_scale=ks, v_scale=vs, new_k=new["k"], new_v=new["v"],
                pos=pos)
    res = {}
    for cap in (0.0, 30.0):
        got = ops.paged_decode(q, kc, vc, logit_softcap=cap, **args)
        want = ref.paged_decode_int8_ref(q, kc, vc, ks, vs, new["k"],
                                         new["v"], pos, cap)
        torch.cuda.synchronize()
        res[f"err_softcap{cap:g}"] = check_close(
            f"paged_decode int8 cap={cap}", got, want)
    a32 = dict(args, new_k=new["k"].float(), new_v=new["v"].float())
    got32 = ops.paged_decode(q.float(), kc, vc, **a32)
    res["err_f32"] = float((got32 - ref.paged_decode_int8_ref(
        q.float(), kc, vc, ks, vs, a32["new_k"], a32["new_v"], pos)
                            ).abs().max())
    if res["err_f32"] > 1e-4:
        fail(f"paged_decode int8 f32 max abs err {res['err_f32']}")

    rows = torch.arange(b, device=dev)
    mask = (torch.arange(smax, device=dev)[None] < kv_len[:, None].long()
            )[:, None, None, :]
    qs = q.transpose(1, 2)                                  # [B, H, 1, D]

    def deq_sdpa():
        kv = []
        for c, sc, nw in ((kc, ks, new["k"]), (vc, vs, new["v"])):
            x = kv_quant.dequantize_pages(c, sc, torch.bfloat16).view(
                b, smax, hkv, d)
            x[rows, pos.long()] = nw[:, 0]
            kv.append(x.transpose(1, 2))
        return F.scaled_dot_product_attention(qs, kv[0], kv[1],
                                               attn_mask=mask,
                                               enable_gqa=True)
    got = ops.paged_decode(q, kc, vc, **args)
    res["library_err"] = float((deq_sdpa().transpose(1, 2).float()
                                - got.float()).abs().max())
    res["ms"] = time_ms(lambda: ops.paged_decode(q, kc, vc, **args), 50)
    res["plain_ms"] = time_ms(lambda: ref.paged_decode_int8_ref(
        q, kc, vc, ks, vs, new["k"], new["v"], pos), 10)
    kb, vb = (kv_quant.dequantize_pages(c, sc, torch.bfloat16)
              for c, sc in ((kc, ks), (vc, vs)))
    res["bf16_mode_ms"] = time_ms(lambda: ops.paged_decode(q, kb, vb,
                                                           kv_len), 50)
    res["library_ms"] = time_ms(deq_sdpa, 50)
    res["library"] = "dequantize_pages + SDPA (two calls)"
    # codes of the visible tokens (1 byte each) and the scales of their
    # pages, read once; q, the new rows and the output in bf16
    tokens = sum(min(n, smax) for n in lens)
    pages_read = sum(-(-min(n, smax) // page) for n in lens)
    n_bytes = (2 * tokens * hkv * d + 2 * pages_read * hkv * 4
               + 2 * q.numel() * 2 + 2 * new["k"].numel() * 2
               + pos.numel() * 4)
    res["bound_ms"], res["bound_by"] = bound(n_bytes, 4 * tokens * h * d)
    res["max_abs_err"] = res["err_softcap0"]
    res["shape"] = (f"q [{b},1,{h},{d}] bf16, codes [{b},{p},{page},{hkv},"
                    f"{d}] int8, scales [{b},{p},{hkv}], pos "
                    f"{[n - 1 for n in lens]}")
    return res


def check_prefill(dev, hkv, g, d):
    """flash_prefill at ``hkv`` kv heads of ``g`` query heads, head_dim
    ``d``: one 256-token chunk against a 2048-token cache."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    c, smax = CHUNK, MAX_SEQ
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


def check_ssd(dev):
    """ssd_scan at zamba2-2.7b's widths (B 1, H 80, P = N = 64) from a
    nonzero state: a 256-token prefill chunk and a ragged 44-token one,
    ``y`` and ``h_last`` against the plain chunked form at the kernel's
    own sub-chunk (f32). No single PyTorch call computes the SSD, so there
    is no library time."""
    import torch
    from repro_torch.kernels.mamba2_scan import ops, ref
    b, h, p, n = 1, 80, 64, 64
    gen = torch.Generator(device=dev).manual_seed(3)
    h0 = torch.randn((b, h, p, n), generator=gen, device=dev)
    res, inputs = {}, {}
    for s in (CHUNK, 44):
        xdt = torch.randn((b, s, h, p), generator=gen, device=dev)
        bm = torch.randn((b, s, n), generator=gen, device=dev) * 0.5
        cm = torch.randn((b, s, n), generator=gen, device=dev) * 0.5
        la = -torch.rand((b, s, h), generator=gen, device=dev) * 0.2
        inputs[s] = (xdt, bm, cm, la)
        y, h_last = ops.ssd(xdt, bm, cm, la, h0=h0)
        y_ref, h_ref = ref.ssd_chunked_ref(xdt, bm, cm, la, h0,
                                           chunk=ops.KERNEL_CHUNK)
        torch.cuda.synchronize()
        res[f"err_y_s{s}"] = check_close(f"ssd_scan y S={s}", y, y_ref,
                                         SSD_TOL)
        res[f"err_h_s{s}"] = check_close(f"ssd_scan h_last S={s}", h_last,
                                         h_ref, SSD_TOL)
    xdt, bm, cm, la = inputs[CHUNK]
    res["ms"] = time_ms(lambda: ops.ssd(xdt, bm, cm, la, h0=h0), 50)
    res["plain_ms"] = time_ms(lambda: ref.ssd_chunked_ref(
        xdt, bm, cm, la, h0, chunk=ops.KERNEL_CHUNK), 10)
    res["library_ms"] = None
    # each input read once, each output written once (f32); the
    # recurrence's 4 P N flops per (token, head) at the f32 peak
    n_bytes = 4 * (2 * xdt.numel() + bm.numel() + cm.numel() + la.numel()
                   + 2 * h0.numel())
    res["bound_ms"], res["bound_by"] = bound(
        n_bytes, 4 * b * CHUNK * h * p * n, F32_FLOPS)
    res["bound_peak"] = (f"{HBM_BYTES_PER_S:.3g} B/s, {F32_FLOPS:.3g} "
                         f"f32 flop/s (no tensor cores)")
    res["max_abs_err"] = max(res["err_y_s256"], res["err_h_s256"])
    res["shape"] = (f"xdt [{b},{CHUNK},{h},{p}] f32 (also S=44), b/c "
                    f"[{b},{CHUNK},{n}], h0 [{b},{h},{p},{n}]")
    return res


def check_paged_matmul(dev):
    """paged_matmul at qwen3-1.7b's MLP width: x [8, 2048] (the decode
    batch) and [256, 2048] (a prefill chunk) against 8 logical pages of
    [256, 6144] drawn by a seeded permutation from a pool of 16; bf16 at
    both, f32 at M = 256. The weights are at the models' init scale,
    N(0, 0.02^2), so that y is O(1) as in a layer: f32 sums of 2048
    products taken in another order than cuBLAS's part by ~1e-4 when y is
    O(50), as unit-variance weights make it. cuBLAS ``torch.matmul`` on
    the pre-gathered weight is the library time."""
    import torch
    from repro_torch.kernels.hdm_stream import ops, ref
    gen = torch.Generator(device=dev).manual_seed(5)
    pool = (torch.randn((MATMUL_POOL, MATMUL_PAGE_K, MATMUL_N), generator=gen,
                        device=dev) * 0.02).bfloat16()
    n_k = MATMUL_K // MATMUL_PAGE_K
    ids = torch.randperm(MATMUL_POOL, generator=torch.Generator(
    ).manual_seed(SEED))[:n_k].to(dev, torch.int32)
    w = pool[ids.long()].reshape(MATMUL_K, MATMUL_N)     # pre-gathered
    res = {"page_ids": ids.tolist()}
    for m in (8, 256):
        x = torch.randn((m, MATMUL_K), generator=gen, device=dev).bfloat16()
        got = ops.stream_matmul(x, pool, ids)
        want = ref.paged_matmul_ref(x, pool, ids)
        torch.cuda.synchronize()
        r = {"err": check_close(f"paged_matmul bf16 M={m}", got, want)}
        if m == 256:
            x32, pool32 = x.float(), pool.float()
            r["err_f32"] = check_close(
                "paged_matmul f32 M=256", ops.stream_matmul(x32, pool32, ids),
                ref.paged_matmul_ref(x32, pool32, ids), F32_TOL)
        r["ms"] = time_ms(lambda: ops.stream_matmul(x, pool, ids), 20)
        r["plain_ms"] = time_ms(
            lambda: ref.paged_matmul_ref(x, pool, ids), 10)
        r["library_ms"] = time_ms(lambda: torch.matmul(x, w), 20)
        r["library_err"] = float((torch.matmul(x, w).float()
                                  - got.float()).abs().max())
        # x and the 8 pages read once, y written once (bf16)
        n_bytes = 2 * (x.numel() + w.numel() + m * MATMUL_N) + 4 * n_k
        r["bound_ms"], r["bound_by"] = bound(n_bytes,
                                             2 * m * MATMUL_K * MATMUL_N)
        res[f"m{m}"] = r
    res.update({k: res["m8"][k] for k in ("ms", "plain_ms", "library_ms",
                                          "bound_ms", "bound_by")})
    res["max_abs_err"] = max(res["m8"]["err"], res["m256"]["err"])
    res["shape"] = (f"x [8,{MATMUL_K}] (also [256,{MATMUL_K}]) bf16, "
                    f"w_pages [{MATMUL_POOL},{MATMUL_PAGE_K},{MATMUL_N}], "
                    f"{n_k} page ids")
    return res


def check_model_small(dev, arch, kv_quant="none"):
    """The whole model step on the card against the same weights on the
    CPU (plain kernel versions; the CPU tests hold that path to the JAX
    reference): the smoke-size ``arch`` in f32, chunked prefill with a
    ragged last chunk, then decode ticks with ragged per-slot positions.
    Returns the largest logit and cache differences. Tolerances: f32 3e-5
    (tests/test_kernel_parity.py), the hybrid 1e-4 (tests/test_kernels.py
    for the SSD) with its Mamba2 states held relative to their scale (they
    are ~1e-6 at smoke size). With int8 pages the codes must be equal but
    for steps of one (counted), the scales within 1e-6 relative and the
    dequantized pages within the tolerance plus one step."""
    import copy
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
    from repro_torch.models import model as M
    cfg = dataclasses.replace(registry.smoke(arch), dtype="float32")
    rc = RunConfig(model=cfg, shape=SHAPES["decode_32k"], mesh=MeshConfig(),
                   kv_page_size=8, kv_quant=kv_quant)
    cpu = torch.device("cpu")
    params = {cpu: M.init_model(cfg, seed=SEED, device=cpu)}
    params[dev] = copy.deepcopy(params[cpu]).to(dev)
    caches = {d: M.cache_init(cfg, rc, 2, 64, device=d) for d in params}
    rng = np.random.default_rng(SEED)
    prompt = rng.integers(1, cfg.vocab_size, (2, 21)).astype(np.int32)
    steps = [("prefill", prompt[:, s:s + 8]) for s in range(0, 21, 8)]
    steps += [("decode", rng.integers(1, cfg.vocab_size, (2, 1)).astype(
        np.int32)) for _ in range(4)]
    tol = 1e-4 if cfg.family == "hybrid" else 3e-5
    f32_tol = dict(atol=tol, rtol=tol)
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
            fail(f"small {arch} {kind} step {i}: card logits differ from "
                 f"the CPU by {float((got - want).abs().max())}")
        err = max(err, float((got - want).abs().max()))
    out = {"logits_max_abs_err": err, "steps": len(steps)}
    if kv_quant == "int8":
        out.update(int8_cache_diff(arch, caches[dev]["kv"], caches[cpu]["kv"],
                                   tol))
        return out
    leaves = {n: (caches[dev]["kv"][n], caches[cpu]["kv"][n])
              for n in ("k", "v")}
    leaves.update({n: (caches[dev][n], caches[cpu][n])
                   for n in ("h", "conv") if n in caches[cpu]})
    for n, (got, want) in leaves.items():
        got = got.cpu()
        scale = float(want.abs().max()) if n in ("h", "conv") else 1.0
        cache_err = float((got - want).abs().max())
        out[f"{n}_max_abs_err"] = cache_err
        if scale == 0.0 or not torch.allclose(
                got, want, atol=tol * scale, rtol=tol):
            fail(f"small {arch}: card {n} cache differs from the CPU by "
                 f"{cache_err} (scale {scale})")
    return out


def int8_cache_diff(arch, got, want, tol):
    """int8 pages on the card (``got``) against the CPU's: scales within
    1e-6 relative, codes equal but for steps of one, dequantized values
    within ``tol`` plus one step. Returns the differences and the count
    of codes that differ."""
    import torch
    out = {"codes": 0, "codes_differ": 0}
    for n in ("k", "v"):
        gq, wq = got[n].cpu(), want[n]
        gs, ws = got[n + "_scale"].cpu(), want[n + "_scale"]
        if not torch.allclose(gs, ws, rtol=1e-6, atol=0):
            fail(f"small {arch} int8: card {n} scales differ from the CPU "
                 f"by {float((gs - ws).abs().max())}")
        step = (gq.int() - wq.int()).abs()
        out["codes"] += gq.numel()
        out["codes_differ"] += int((step > 0).sum())
        out[f"{n}_max_code_step"] = int(step.max())
        dg = gq.float() * gs[..., :, None, :, None]
        dw = wq.float() * ws[..., :, None, :, None]
        over = (dg - dw).abs() - (tol + tol * dw.abs()
                                  + ws[..., :, None, :, None])
        out[f"{n}_max_abs_err"] = float((dg - dw).abs().max())
        if int(step.max()) > 1 or float(over.max()) > 0:
            fail(f"small {arch} int8: card {n} codes differ from the CPU "
                 f"by {int(step.max())} steps")
    return out


# ---------------------------------------------------------------- phase 3

def build_engine(dev, arch, kv_quant="none"):
    """Full-width ``arch`` with random bf16 weights drawn on the card from
    the seed, on the serving engine of every serving phase."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES
    from repro_torch.models import model as M
    from repro_torch.serving.config import ServeConfig
    from repro_torch.serving.engine import ServingEngine
    cfg = registry.get(arch)
    rc = RunConfig(model=cfg, shape=SHAPES["decode_32k"], mesh=MeshConfig())
    t0 = time.time()
    params = M.init_model(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    config = ServeConfig(n_slots=N_SLOTS, max_seq=MAX_SEQ,
                         prefill_chunk=CHUNK, tier_topology=TOPOLOGY,
                         store_budget_bytes=16 << 30, seed=SEED,
                         kv_quant=kv_quant)
    engine = ServingEngine(params, cfg, rc, config=config, device=dev)
    return cfg, rc, params, engine, init_s


def run_stats(engine, handles, wall_s, launches, init_s):
    import torch
    from repro_torch.core.tier import CxlTier
    st = engine.stats
    entries = {CxlTier.entry_bytes(e) for e in engine.store.pages.values()}
    return {"init_s": init_s, "wall_s": wall_s, "launches": launches,
            "n_layers": engine.cfg.n_layers, "entry_bytes": sorted(entries),
            "requests_done": sum(h.done() for h in handles),
            "requests": len(handles),
            "decode_tokens": st["decode_tokens"],
            "prefill_tokens": st["prefill_tokens"],
            "decode_ticks": st["decode_dispatches"],
            "prefill_chunks": st["prefill_dispatches"],
            "tokens_per_s": st["decode_tokens"] / wall_s,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "prefix_hits": st["prefix_hits"],
            "restore_stall_ns": st["restore_stall_ns"],
            "tier_write_ns": st["tier_write_ns"],
            "store_bytes": st["store_bytes"], "flushes": st["flushes"],
            "tier_sr_hit_rate": st["tier_sr_hit_rate"]}


def step_costs(engine, params, cfg, rc, prompt, dev):
    """Steady-state device costs of the two steps at the path's shapes
    (CUDA events), then one more tick whose logits must be finite and of
    the expected shape."""
    import torch
    from repro_torch.models import model as M
    out = {"decode_tick_ms": time_ms(engine._decode_sample, 10)}
    chunk = torch.tensor([prompt[:CHUNK]], dtype=torch.int32, device=dev)

    def prefill_chunk():
        cache1 = M.slot_view(engine.cache, 0)
        cache1["pos"] = torch.zeros(1, dtype=torch.int32, device=dev)
        M.prefill_step_cached(params, cfg, rc, chunk, cache1,
                              last_only=True)
    out["prefill_chunk_ms"] = time_ms(prefill_chunk, 5)
    logits, _ = M.decode_step(params, cfg, rc, engine.last_tokens[:, None],
                              engine.cache)
    torch.cuda.synchronize()
    if tuple(logits.shape) != (N_SLOTS, 1, cfg.vocab_size):
        fail(f"{cfg.arch_id} decode logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits.float()).all():
        fail(f"{cfg.arch_id}: non-finite decode logits")
    return out


def prefix_pages_equal(engine, rid, again_rid, prompt_len):
    """The int8 flush -> restore -> decode round trip: the pages that the
    prompt filled (and no decode step touched) come back in the restored
    request's own retired entry with the same codes and scales, bit for
    bit (``tests/test_kv_quant.py``'s engine gate, at full width)."""
    import torch
    for _ in range(20):
        if rid in engine.store.pages and again_rid in engine.store.pages:
            break
        engine.flusher.maybe_flush()
    a, b = engine.store.pages.get(rid), engine.store.pages.get(again_rid)
    if a is None or b is None:
        return False
    full = prompt_len // engine.cache["kv"]["k"].shape[3]
    return all(torch.equal(a["kv"][n][:, :full], b["kv"][n][:, :full])
               for n in a["kv"])


def serve(dev, kv_quant="none"):
    """Serve full-width qwen3-1.7b: N_REQUESTS prompts, then N_RESUBMIT of
    them again under new rids (prefix restores)."""
    import numpy as np
    import torch
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.hdm_stream import ops as hops
    from repro_torch.serving.engine import Request

    cfg, rc, params, engine, init_s = build_engine(dev, ARCH, kv_quant)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(*PROMPT_LENS, N_REQUESTS)]
    torch.cuda.reset_peak_memory_stats(dev)

    # the main path: counts from 0 just before, read just after
    dops.launches = 0
    dops.int8_launches = 0
    fops.launches = 0
    hops.launches = 0
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
    decode = "paged_decode_int8" if kv_quant == "int8" else "paged_decode"
    launches = {decode: (dops.int8_launches if kv_quant == "int8"
                         else dops.launches),
                "flash_prefill": fops.launches}
    off_path = {"paged_decode": dops.launches,
                "paged_decode_int8": dops.int8_launches,
                "paged_matmul": hops.launches}
    off_path.pop(decode)

    out = run_stats(engine, first + again, wall_s, launches, init_s)
    out["off_path_launches"] = off_path
    out["restored"] = [h.request.restored for h in again]
    out["tokens_equal"] = [h.result() == first[i].result()
                           for i, h in enumerate(again)
                           if h.done() and first[i].done()]
    out["tokens_first_run"] = [first[i].result() for i in range(N_RESUBMIT)]
    out["tokens_restored"] = [h.result() for h in again]
    out.update(step_costs(engine, params, cfg, rc, prompts[0], dev))
    if kv_quant == "int8":
        out["prefix_pages_equal"] = [
            prefix_pages_equal(engine, i, 1000 + i, len(prompts[i]))
            for i in range(N_RESUBMIT)]
        out["tokens_equal_leading"] = [
            next((j for j, (a, b) in enumerate(zip(x, y)) if a != b),
                 len(x))
            for x, y in zip(out["tokens_first_run"], out["tokens_restored"])]
        out["post_prefill"] = restore_from_post_prefill(
            dev, prompts[:N_RESUBMIT], out["tokens_first_run"])
    return out


def restore_from_post_prefill(dev, prompts, first_tokens):
    """int8 restores are exact when the entry is the post-prefill state.

    A retired entry holds the pages as they stand at retire, so under
    int8 the page holding ``pos`` carries the scale that the decoded rows
    grew and its prompt rows come back re-rounded to it (the reference
    engine does the same). Here each prompt first runs for one token on
    fresh slots, so that its entry is exactly the state its first run
    decoded from; restored, it must give that run's greedy tokens."""
    from repro_torch.serving.engine import Request
    _, _, _, engine, _ = build_engine(dev, ARCH, "int8")
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=1))
    engine.run(max_ticks=10_000)
    again = [engine.submit(Request(rid=100 + i, prompt=p,
                                   max_new_tokens=MAX_NEW))
             for i, p in enumerate(prompts)]
    engine.run(max_ticks=10_000)
    return {"restored": [h.request.restored for h in again],
            "tokens_equal": [h.result() == t
                             for h, t in zip(again, first_tokens)]}


# ---------------------------------------------------------------- phase 4

def check_hybrid_stepwise(dev, params, cfg, rc):
    """One 256-token prompt at full width through one chunked prefill (the
    SSD-scan and flash-prefill kernels) and through 256 ``decode_step``
    calls (the reference engine's form of the hybrid prefill). With the
    bf16 weights widened to f32 the two must agree within FULL_F32_TOL,
    with the prompt's greedy token equal. In bf16 their difference is
    measured and reported, not bounded: ``dt`` comes out of a bf16 product
    whose rounding differs between a 1-row and a 256-row product, and the
    decay ``exp(dt * A)`` (A up to 16) amplifies it layer after layer."""
    import copy
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models import model as M
    toks = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        1, cfg.vocab_size, (1, CHUNK)).astype(np.int32)).to(dev)
    out = {"positions": CHUNK}
    for name in ("float32", "bfloat16"):
        wide = name == "float32"
        c = dataclasses.replace(cfg, dtype=name)
        p = copy.deepcopy(params).float() if wide else params
        cache = M.cache_init(c, rc, 1, CHUNK, device=dev)
        chunked, _ = M.prefill_step_cached(p, c, rc, toks, cache)
        cache = M.cache_init(c, rc, 1, CHUNK, device=dev)
        stepwise = torch.cat([M.decode_step(p, c, rc, toks[:, t:t + 1],
                                            cache)[0]
                              for t in range(CHUNK)], 1)
        torch.cuda.synchronize()
        got, want = chunked.float(), stepwise.float()
        if not torch.isfinite(got).all() or not torch.isfinite(want).all():
            fail(f"{cfg.arch_id} {name}: non-finite prefill logits")
        same = (got.argmax(-1) == want.argmax(-1))[0]
        diff = (got - want).abs()
        out[name] = {"logits_max_abs_err": float(diff.max()),
                     "logits_mean_abs_err": float(diff.mean()),
                     "logit_scale": float(want.abs().max()),
                     "argmax_equal_positions": int(same.sum())}
        if wide:
            check_close(f"{cfg.arch_id} f32 chunked vs stepwise prefill "
                        f"logits", got, want, FULL_F32_TOL)
            if not bool(same[-1]):
                fail(f"{cfg.arch_id}: the prompt's greedy token differs "
                     f"between chunked and stepwise prefill (f32)")
        del p, cache, chunked, stepwise
        torch.cuda.empty_cache()
    return out


def serve_hybrid(dev):
    import numpy as np
    import torch
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mamba2_scan import ops as sops
    from repro_torch.serving.engine import Request

    cfg, rc, params, engine, init_s = build_engine(dev, HYBRID)
    stepwise = check_hybrid_stepwise(dev, params, cfg, rc)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(*PROMPT_LENS, N_HYBRID_REQUESTS)]
    torch.cuda.reset_peak_memory_stats(dev)

    # the main path: counts from 0 just before, read just after
    dops.launches = 0
    fops.launches = 0
    sops.launches = 0
    t0 = time.time()
    handles = [engine.submit(Request(rid=i, prompt=p,
                                     max_new_tokens=MAX_NEW))
               for i, p in enumerate(prompts)]
    engine.run(max_ticks=10_000)
    torch.cuda.synchronize()
    wall_s = time.time() - t0
    launches = {"paged_decode": dops.launches, "flash_prefill": fops.launches,
                "ssd_scan": sops.launches}

    out = run_stats(engine, handles, wall_s, launches, init_s)
    out["stepwise"] = stepwise
    out.update(step_costs(engine, params, cfg, rc, prompts[0], dev))
    return out


def report(arch, run):
    log(f"serve {arch}: {run['requests_done']}/{run['requests']} requests, "
        f"{run['decode_tokens']} decode + {run['prefill_tokens']} prefill "
        f"tokens in {run['wall_s']:.2f}s ({run['tokens_per_s']:.1f} "
        f"decode tok/s), {run['decode_ticks']} ticks, "
        f"{run['prefill_chunks']} prefill chunks")
    log(f"{arch}: decode tick {run['decode_tick_ms']:.3f} ms, prefill chunk "
        f"({CHUNK} tokens) {run['prefill_chunk_ms']:.3f} ms, "
        f"max_memory_allocated {run['max_memory_allocated']} bytes, "
        f"weights init {run['init_s']:.1f}s")
    log(f"{arch} tier: prefix_hits {run['prefix_hits']}, restore_stall_ns "
        f"{run['restore_stall_ns']}, tier_write_ns {run['tier_write_ns']}, "
        f"store_bytes {run['store_bytes']}, flushes {run['flushes']}, "
        f"sr_hit_rate {run['tier_sr_hit_rate']}")
    log(f"{arch}: launches on the main path: {run['launches']}")
    if run["requests_done"] != run["requests"]:
        fail(f"{arch}: only {run['requests_done']}/{run['requests']} "
             f"finished")
    for name, n in run["launches"].items():
        if n <= 0:
            fail(f"{arch}: kernel {name} was never launched on the main "
                 f"path")


def check_restores(arch, run):
    """Every resubmit restored from the tier, with its first run's greedy
    tokens."""
    if run["prefix_hits"] < N_RESUBMIT or run["restore_stall_ns"] <= 0:
        fail(f"{arch}: prefix restores missing: hits {run['prefix_hits']}, "
             f"stall {run['restore_stall_ns']}")
    if not all(run["restored"]):
        fail(f"{arch}: resubmits not restored: {run['restored']}")
    if len(run["tokens_equal"]) != N_RESUBMIT or not all(
            run["tokens_equal"]):
        fail(f"{arch}: restored greedy tokens differ: "
             f"{run['tokens_equal']}")


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

    dec = check_decode(dev, 8, 2, 128)
    log(f"paged_decode ok: {dec['shape']}; {dec}")
    dec80 = check_decode(dev, 32, 1, 80)
    log(f"paged_decode ok: {dec80['shape']}; {dec80}")
    pre = check_prefill(dev, 8, 2, 128)
    log(f"flash_prefill ok: {pre['shape']}; {pre}")
    pre80 = check_prefill(dev, 32, 1, 80)
    log(f"flash_prefill ok: {pre80['shape']}; {pre80}")
    dec8 = check_decode_int8(dev, 8, 2, 128)
    log(f"paged_decode int8 ok: {dec8['shape']}; {dec8}")
    ssd = check_ssd(dev)
    log(f"ssd_scan ok: {ssd['shape']}; {ssd}")
    mm = check_paged_matmul(dev)
    log(f"paged_matmul ok: {mm['shape']}; {mm}")
    small = {arch: check_model_small(dev, arch) for arch in (ARCH, HYBRID)}
    small[f"{ARCH} int8"] = check_model_small(dev, ARCH, "int8")
    for arch, res in small.items():
        log(f"small {arch} (f32) on the card agrees with the CPU: {res}")

    run = serve(dev)
    report(ARCH, run)
    check_restores(ARCH, run)
    torch.cuda.empty_cache()

    hyb = serve_hybrid(dev)
    log(f"{HYBRID} chunked vs stepwise prefill: {hyb['stepwise']}")
    report(HYBRID, hyb)
    if hyb["flushes"] <= 0 or hyb["tier_write_ns"] <= 0:
        fail(f"{HYBRID}: no pages flushed to the tier")

    torch.cuda.empty_cache()

    run8 = serve(dev, "int8")
    int8_name = f"{ARCH} int8"
    report(int8_name, run8)
    # restored from entries captured at retire, greedy tokens may part
    # from the first run's after the first one (restore_from_post_prefill);
    # the restore itself must be exact: the prompt's full pages come back
    # bit for bit, and a post-prefill entry gives the first run's tokens
    log(f"{int8_name}: restored tokens equal to the first run's "
        f"{run8['tokens_equal']}, equal leading tokens "
        f"{run8['tokens_equal_leading']} of {MAX_NEW}; prompt pages bit "
        f"for bit {run8['prefix_pages_equal']}; restored from post-prefill "
        f"entries {run8['post_prefill']}")
    if run8["prefix_hits"] < N_RESUBMIT or not all(run8["restored"]):
        fail(f"{int8_name}: resubmits not restored: {run8['restored']}")
    if not all(run8["prefix_pages_equal"]) or min(
            run8["tokens_equal_leading"]) < 1:
        fail(f"{int8_name}: the round trip is not exact")
    post = run8["post_prefill"]
    if not (all(post["restored"]) and all(post["tokens_equal"])
            and len(post["tokens_equal"]) == N_RESUBMIT):
        fail(f"{int8_name}: restores of post-prefill entries differ from "
             f"the first run: {post}")
    per_tick = run8["launches"]["paged_decode_int8"] / run8["decode_ticks"]
    if per_tick != run8["n_layers"] or any(
            run8["off_path_launches"].values()):
        fail(f"{int8_name}: int8 decode launches per tick {per_tick} (want "
             f"one per layer, {run8['n_layers']}), off-path launches "
             f"{run8['off_path_launches']}")
    ratio = max(run8["entry_bytes"]) / min(run["entry_bytes"])
    run8["entry_ratio"] = ratio
    log(f"{int8_name}: entry {run8['entry_bytes']} bytes over the bf16 "
        f"entry {run['entry_bytes']} = {ratio:.5f} (gate < "
        f"{INT8_ENTRY_RATIO}); restore stall per restore "
        f"{run8['restore_stall_ns'] / run8['prefix_hits']:.1f} ns against "
        f"bf16 {run['restore_stall_ns'] / run['prefix_hits']:.1f} ns")
    if ratio >= INT8_ENTRY_RATIO:
        fail(f"{int8_name}: int8 entry / bf16 entry {ratio}")

    runs = {ARCH: run, HYBRID: hyb, int8_name: run8}
    kernels = []
    for name, res, src, replaces in (
            ("paged_decode", dec, "src/repro_torch/csrc/paged_decode.cu",
             "src/repro/kernels/decode_attention/kernel.py:79"),
            ("paged_decode_int8", dec8,
             "src/repro_torch/csrc/paged_decode.cu",
             "src/repro/kernels/decode_attention/kernel.py:79"),
            ("flash_prefill", pre, "src/repro_torch/csrc/flash_prefill.cu",
             "src/repro/kernels/flash_attention/kernel.py:77"),
            ("ssd_scan", ssd, "src/repro_torch/csrc/ssd_scan.cu",
             "src/repro/kernels/mamba2_scan/kernel.py:68"),
            ("paged_matmul", mm, "src/repro_torch/csrc/paged_matmul.cu",
             "src/repro/kernels/hdm_stream/kernel.py:42")):
        by_path = {arch: r["launches"][name] for arch, r in runs.items()
                   if name in r["launches"]}
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": sum(by_path.values()),
               "launches_by_path": by_path,
               "max_abs_err": res["max_abs_err"], "ms": res["ms"],
               "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
               "bound_by": res["bound_by"], "library_ms": res["library_ms"]}
        if name == "paged_matmul":
            row["note"] = ("no path of the reference calls it (its engine "
                           "drops the speculative-read weight prefetch on "
                           "one device); ported as its op, stream_matmul")
        kernels.append(row)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "build_s": build_s, "decode": dec, "decode_d80": dec80,
                   "decode_int8": dec8, "prefill": pre,
                   "prefill_d80": pre80, "ssd_scan": ssd,
                   "paged_matmul": mm, "small_model": small, "serve": run,
                   "serve_hybrid": hyb, "serve_int8": run8,
                   "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
