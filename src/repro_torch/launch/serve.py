"""Serving driver: batched requests through the port's tiered paged engine.

  python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --cxl-topology dram,ssd-fast          # full width, on the card
  python -m repro_torch.launch.serve --arch zamba2-2.7b \
      --cxl-topology dram,ssd-fast          # the hybrid family, on the card
  python -m repro_torch.launch.serve --arch qwen3-1.7b --kv-quant int8 \
      --cxl-topology dram,ssd-fast          # int8 KV pages, on the card
  python -m repro_torch.launch.serve --arch granite-moe-1b-a400m \
      --cxl-topology dram,ssd-fast          # the MoE family, on the card
  python -m repro_torch.launch.serve --arch musicgen-large \
      --cxl-topology dram,ssd-fast          # the audio family, on the card
  python -m repro_torch.launch.serve --arch llama-3.2-vision-11b \
      --cxl-topology dram,ssd-fast          # the VLM family, on the card
  python -m repro_torch.launch.serve --arch xlstm-125m \
      --cxl-topology dram,ssd-fast          # the xLSTM family, on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --smoke --device cpu --requests 4     # smoke size, on the CPU
  python -m repro_torch.launch.serve --arch qwen3-1.7b --tp 2 \
      --cxl-topology dram,ssd-fast          # two ranks (processes)
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch granite-moe-1b-a400m --smoke --device cpu --tp 2
                                            # expert-parallel MoE, CPU
  python -m repro_torch.launch.serve --arch zamba2-2.7b --tp 2 \
      --cxl-topology dram,ssd-fast          # the hybrid on two ranks
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \
      --smoke --device cpu --tp 2           # (also musicgen-large,
                                            # llama-3.2-vision-11b)
  python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --cxl-topology dram,ssd-fast --cxl-async --preempt-policy swap \
      --load --arrival bursty --arrivals 24  # open loop, on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
      --smoke --device cpu --load --arrivals 8   # open loop, on the CPU

The flags are the subset of the reference CLI (``repro.launch.serve``)
that this port supports: every family (dense, MoE, audio, hybrid, VLM
and xLSTM) on one rank or on ``--tp N`` ranks (N processes, each on its
shard of the weights; rank 0 prints; on one card they share it, see
``launch.mesh``), bf16/f32 or int8
(``--kv-quant int8``) pages, the
closed submit-then-run loop and the open loop (``--load``: a seeded
arrival trace of ``serving.loadgen``, ``--rate`` requests per simulated
second, ``--arrival poisson|bursty``, zipf prompt popularity, played on
the simulated clock; the SLO summary is printed instead of wall-clock
throughput). Every engine default
comes from :class:`~repro_torch.serving.config.ServeConfig`.
``--cxl-media`` / ``--cxl-topology`` attach the CXL-timed tier;
``--cxl-async`` and ``--preempt-policy`` drive the scheduler;
``--fault-trace`` injects a named endpoint-fault preset. Weights are
random, drawn on the device from ``--seed``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

if __package__ in (None, ""):         # run as a file: put src/ on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving.config import ServeConfig  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

# single source of truth for the CLI defaults below
_DEF = ServeConfig()

# named endpoint-fault presets (--fault-trace); times are simulated ns
# into the run, sized for the smoke/open-loop horizons. ``port`` fields
# are resolved against the attached topology at config-build time: 0 is
# always valid, -1 means the last port.
FAULT_PRESETS = {
    "degrade": (("degrade", 1.0e6, -1, 300.0, 8.0e6),),
    "flaky": (("transient", 0.5e6, 0, 0.85, 6.0e6),),
    "hot-remove": (("hot_remove", 1.5e6, -1),),
    "mix": (("transient", 0.5e6, 0, 0.85, 6.0e6),
            ("degrade", 1.0e6, -1, 300.0, 8.0e6),
            ("hot_remove", 3.0e6, -1)),
}


def resolve_fault_preset(name: str, n_ports: int):
    """Resolve a named preset's relative port indices for a topology."""
    if name not in FAULT_PRESETS:
        raise ValueError(f"unknown fault preset {name!r} "
                         f"(choices: {sorted(FAULT_PRESETS)})")
    events = []
    for kind, t_ns, port, *rest in FAULT_PRESETS[name]:
        port = port % n_ports if n_ports else port
        if kind == "hot_remove" and n_ports < 2:
            raise ValueError("the hot-remove presets need a multi-port "
                             "tier (--cxl-topology with >= 2 ports): "
                             "removing the only port leaves no tier")
        events.append((kind, t_ns, port, *rest))
    return tuple(events)


def _print_closed(engine, finished, n_requests, dt):
    """Summarize one closed-loop run (wall-clock throughput and tier)."""
    tput = engine.stats["decode_tokens"] / dt if dt > 0 else 0.0
    print(f"[serve] {len(finished)}/{n_requests} requests, "
          f"{engine.stats['decode_tokens']} tokens in {dt:.1f}s "
          f"({tput:.1f} tok/s; {engine.stats['prefill_dispatches']} prefill"
          f" + {engine.stats['decode_dispatches']} decode dispatches, "
          f"{engine.stats['prefix_hits']} prefix hits), flushed pages for "
          f"{engine.stats['flushes']} requests, host tier holds "
          f"{len(engine.store.pages)} retired caches "
          f"({engine.store.bytes / 1024:.0f} KiB, "
          f"{engine.store.evictions} evictions)")


def _print_load(metrics, depths):
    """Summarize one open-loop run (SLO percentiles and goodput)."""
    m = metrics
    print(f"[serve] open-loop: {m.completed}/{m.arrivals} arrivals "
          f"completed in {m.sim_time_ms:.2f}ms simulated "
          f"({m.throughput_req_s:.0f} req/s; "
          f"{m.completed_in_slo} within SLO "
          f"ttft<={m.slo_ttft_ms}ms & tpot<={m.slo_tpot_ms}ms "
          f"-> goodput {m.goodput_req_s:.0f} req/s)")
    print(f"[serve]   TTFT p50/p99 {m.ttft_ms_p50:.3f}/"
          f"{m.ttft_ms_p99:.3f}ms, TPOT p50/p99 {m.tpot_ms_p50:.4f}/"
          f"{m.tpot_ms_p99:.4f}ms, queue depth p50/p99 "
          f"{m.queue_depth_p50:.0f}/{m.queue_depth_p99:.0f} "
          f"({len(depths)} samples), restore stall p50/p99 "
          f"{m.restore_stall_ms_p50:.3f}/{m.restore_stall_ms_p99:.3f}ms, "
          f"{m.preemptions} preemptions, {m.prefix_hits} prefix hits")


def _print_tier(engine, config):
    """Per-tier and per-port stats lines for an attached CXL tier."""
    tier = engine.tier
    snap = tier.snapshot()
    print(f"[serve] cxl tier ({snap['media']}, "
          f"SR {'on' if config.tier_sr else 'off'}): "
          f"{snap['writes'] + snap['async_writes']} page flushes "
          f"({snap['write_ns'] / 1e3:.0f}us held), "
          f"{snap['reads'] + snap['async_reads']} cold restores "
          f"stalling "
          f"{engine.stats['restore_stall_ns'] / 1e3:.0f}us total, "
          f"SR hit rate {snap['sr_hit_rate']:.2f}, "
          f"{engine.stats['flushes_deferred']} flush windows deferred "
          f"by the EP, {snap['gc_events']} internal tasks, "
          f"{snap['frees']} segment frees "
          f"({snap['segment_reuses']} reused)")
    if config.cxl_async or config.preempt_policy != "none":
        st = engine.stats
        print(f"[serve] scheduler (async "
              f"{'on' if config.cxl_async else 'off'}"
              f", policy {config.preempt_policy}, "
              f"admit {config.admit_mode}): "
              f"{st['preemptions']} preemptions, "
              f"{st['swap_out_bytes'] / 1024:.0f} KiB swapped out / "
              f"{st['swap_in_bytes'] / 1024:.0f} KiB back in, "
              f"restore overlap {st['restore_overlap_ratio']:.2f} "
              f"({st['restore_inflight_ns'] / 1e3:.0f}us in flight), "
              f"peak {st['sched_inflight_peak']} in-flight tier ops, "
              f"{st['sim_time_ns'] / 1e6:.2f}ms simulated")
    if config.tier_faults:
        st = engine.stats
        down = [p["port"] for p in tier.port_stats() if p["down"]]
        print(f"[serve] faults (seed {config.fault_seed}): "
              f"{st['tier_fault_ops']} ops crossed the fault path "
              f"({st['tier_fault_retries']} retries, "
              f"{st['tier_fault_failures']} exhausted the budget), "
              f"{st['tier_lost_entries']} entries / "
              f"{st['tier_lost_bytes'] / 1024:.0f} KiB lost to "
              f"hot-removed ports {down or '[]'}, "
              f"{st['recoveries']} requests recovered via RECOVERING")
    if tier.cfg.tagged:
        print(f"[serve] topology ({snap['placement']} placement, "
              f"{snap['promotions']} promotions / "
              f"{snap['demotions']} demotions):")
        for p in snap["ports"]:
            rank = f"rank {p['rank']} " if "rank" in p else ""
            print(f"[serve]   {rank}port {p['port']} ({p['media']}): "
                  f"{p['ep_reads']} EP reads, {p['ep_writes']} writes, "
                  f"SR hit rate {p['sr_hit_rate']:.2f}, "
                  f"{p['live_bytes'] / 1024:.0f} KiB live, "
                  f"devload {p['devload']}, "
                  f"staging {p['staging_occupancy']:.2f}, "
                  f"{p['inflight']} in flight")


def serve(arch: str, *, smoke: bool = False, n_requests: int = 8,
          max_new: int = 12, prompt_len: int = 6,
          config: ServeConfig = _DEF, device="cuda", verbose: bool = True,
          group=None, load=None, max_ticks: int = 100_000):
    """Serve through the engine built from ``config`` on ``device``; prints
    the run's summary and tier stats (unless not ``verbose``) and returns
    ``(engine, finished_requests)``. ``smoke`` picks the reduced config.

    Closed mode (``load is None``): ``n_requests`` random prompts submitted
    up front and run to completion; wall-clock throughput is printed.
    Open-loop mode: ``load`` is a ``serving.loadgen.LoadConfig``; its
    seeded arrival trace is played on the simulated clock (at most
    ``max_ticks`` ticks) and the SLO summary is printed. With a mesh of
    more than one rank (``config.tp > 1`` or ``config.mesh_shape``) it
    serves as ``group``'s rank (``serve_ranks``)."""
    dev = resolve_device(device)
    cfg = registry.smoke(arch) if smoke else registry.get(arch)
    rc = RunConfig(model=cfg, shape=SHAPES["decode_32k"], mesh=MeshConfig())
    if config.n_ranks > 1:
        # sharded decode needs the page axis divisible by the model
        # axis: cap the page size so each slot has >= n_ranks pages
        rc = dataclasses.replace(rc, kv_page_size=min(
            rc.kv_page_size, max(config.max_seq // config.n_ranks, 1)))
    params = M.init_model(cfg, seed=config.seed, device=dev)
    engine = ServingEngine(params, cfg, rc, config=config, device=dev,
                           group=group)
    if load is not None:
        from repro_torch.serving.loadgen import (drive_open_loop,
                                                 make_trace, summarize)
        handles, depths = drive_open_loop(engine, make_trace(load),
                                          max_ticks=max_ticks)
        metrics = summarize(engine, handles, depths, load)
        finished = [h.request for h in handles if h.done()]
        if verbose:
            _print_load(metrics, depths)
    else:
        rng = np.random.default_rng(config.seed)
        handles = []
        for rid in range(n_requests):
            prompt = rng.integers(1, cfg.vocab_size, prompt_len).tolist()
            handles.append(engine.submit(
                Request(rid=rid, prompt=prompt, max_new_tokens=max_new)))
        t0 = time.time()
        finished = engine.run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
        if verbose:
            _print_closed(engine, finished, n_requests, dt)
            ttfts = [h.ttft_ns for h in handles if h.ttft_ns is not None]
            if ttfts:
                print(f"[serve]   per-request handles: "
                      f"{sum(1 for h in handles if h.done())} done, "
                      f"mean TTFT {sum(ttfts) / len(ttfts) / 1e6:.3f}ms "
                      f"simulated")
    if verbose and engine.tier is not None:
        _print_tier(engine, config)
    return engine, finished


def _serve_rank(group, arch, kwargs):
    """One rank of ``serve_ranks``: rank 0 prints; returns the tokens."""
    _, finished = serve(arch, device=group.device,
                        verbose=group.rank == 0, group=group, **kwargs)
    return {r.rid: list(r.generated) for r in finished}


def serve_ranks(arch: str, *, timeout_s: float = 3600.0, **kwargs):
    """``serve`` on the ``kwargs["config"].n_world`` rank processes of its
    mesh (``tp=N``, or ``mesh_shape`` given through the Python API;
    spawned, with a ``file://`` rendezvous in a new temporary directory,
    each rank given its ``RankMesh``); rank 0 prints. Returns each rank's
    ``{rid: tokens}``."""
    config, device = kwargs.pop("config"), kwargs.pop("device", "cuda")
    with tempfile.TemporaryDirectory() as rendezvous:
        return mesh.spawn(_serve_rank, config.n_world,
                          (arch, dict(kwargs, config=config)),
                          rendezvous_dir=rendezvous,
                          device=resolve_device(device).type,
                          timeout_s=timeout_s,
                          mesh_shape=config.resolved_mesh_shape)


def serve_waves(group, params, cfg, rc, config: ServeConfig, waves,
                device="cuda", keep_cache: bool = False) -> dict:
    """Serve ``waves`` (lists of ``(rid, prompt, max_new_tokens)``), each
    submitted then run to the end, on the engine built from ``config`` (as
    the rank of ``group`` -- a ``RankGroup`` of the model axis or a
    ``RankMesh`` -- when its mesh has more than one rank, else ``group``
    is None);
    returns what the run left,
    as plain data: every finished request's tokens, the restored rids, the
    stats, the bytes of the weights the engine holds (a rank's shard), and
    the tier's op traces (one ``CxlTier``: ``ops`` / ``op_ns``;
    a ``ShardedTier``: every rank's and every peer lane's, and its
    counters), and with ``keep_cache`` the cache's pages (this rank's) on
    the CPU. The tests and ``chip_smoke.py`` hold ranks and engines to one
    another with it."""
    engine = ServingEngine(params, cfg, rc, config=config, device=device,
                           group=group)
    for wave in waves:
        for rid, prompt, n in wave:
            engine.submit(Request(rid=rid, prompt=list(prompt),
                                  max_new_tokens=n))
        engine.run(max_ticks=10_000)
    out = {"tokens": {r.rid: list(r.generated) for r in engine.finished},
           "restored": sorted(r.rid for r in engine.finished if r.restored),
           "stats": engine.stats.as_dict(),
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in engine.params.parameters())}
    if keep_cache:
        out["cache"] = {name: t.cpu() for name, t in
                        engine.cache["kv"].items()}
    return _with_tier(engine, out)


def _with_tier(engine, out: dict) -> dict:
    """``out`` with the engine's tier traces as plain data, when it has a
    tier (one ``CxlTier``: ``ops`` / ``op_ns``; a ``ShardedTier``: every
    rank's and every peer lane's, and its counters) and its snapshot."""
    tier = getattr(engine.tier, "inner", engine.tier)
    if tier is None:
        return out
    if hasattr(tier, "ranks"):
        out["tier"] = {"ranks": [(t.ops, t.op_ns) for t in tier.ranks],
                       "peer": [(o, n) for o, n in zip(tier.peer_ops,
                                                       tier.peer_op_ns)],
                       "shard_counters": dict(tier.shard_counters)}
    else:
        out["tier"] = {"ops": tier.ops, "op_ns": tier.op_ns}
    out["tier"]["snapshot"] = tier.snapshot()
    return out


def open_loop_record(engine, handles, depths, metrics) -> dict:
    """One open-loop run (``serving.loadgen.drive_open_loop`` and
    ``summarize`` on ``engine``) as plain data: each arrival's tokens and
    simulated timings (``ttft_ns``, ``tpot_ns``, ``restore_stall_ns``,
    ``recoveries``) by rid, the ``LoadMetrics``, the queue-depth samples,
    the stats and the tier's traces."""
    out = {"tokens": {h.rid: h.tokens() for h in handles},
           "done": {h.rid: h.done() for h in handles},
           "timings": {h.rid: (h.ttft_ns, h.tpot_ns, h.restore_stall_ns,
                               h.recoveries) for h in handles},
           "metrics": metrics.as_dict(), "depths": list(depths),
           "stats": engine.stats.as_dict()}
    return _with_tier(engine, out)


def serve_open_loop(group, params, cfg, rc, config: ServeConfig, load,
                    device="cuda", max_ticks: int = 100_000) -> dict:
    """Play ``load``'s arrival trace (a ``serving.loadgen.LoadConfig``) on
    the engine built from ``config`` (as ``group``'s rank when its mesh
    has more than one rank, else ``group`` is None) and return the run as
    plain data (``open_loop_record``)."""
    from repro_torch.serving.loadgen import (drive_open_loop, make_trace,
                                             summarize)
    engine = ServingEngine(params, cfg, rc, config=config, device=device,
                           group=group)
    handles, depths = drive_open_loop(engine, make_trace(load),
                                      max_ticks=max_ticks)
    return open_loop_record(engine, handles, depths,
                            summarize(engine, handles, depths, load))


def main(argv=None) -> None:
    """CLI entry point; every engine default comes from ``ServeConfig``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config of the same family")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only on request)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=_DEF.n_slots)
    ap.add_argument("--max-seq", type=int, default=_DEF.max_seq)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--prefill-chunk", type=int, default=_DEF.prefill_chunk)
    ap.add_argument("--seed", type=int, default=_DEF.seed)
    ap.add_argument("--kv-quant", default=_DEF.kv_quant,
                    choices=["none", "int8"],
                    help="KV page format: model dtype, or int8 codes with "
                         "per-(page, head) f32 scales (every tier charge "
                         "sees the quantized bytes)")
    ap.add_argument("--cxl-media", default=_DEF.tier_media,
                    help="attach the CXL-timed tier: dram / ssd-fast / "
                         "ssd-slow (or any sim media spec, e.g. znand@2)")
    ap.add_argument("--cxl-sr-off", action="store_true",
                    help="disable the speculative-read engine on the tier")
    ap.add_argument("--cxl-topology", default="",
                    help="multi-root-port tier: comma-separated per-port "
                         "media bins (e.g. 'dram,ssd-fast'); overrides "
                         "--cxl-media")
    ap.add_argument("--cxl-placement", default=_DEF.tier_placement,
                    choices=["striped", "hashed", "hotness", "learned"])
    ap.add_argument("--cxl-heat-half-life-ns", type=float,
                    default=_DEF.tier_heat_half_life_ns)
    ap.add_argument("--cxl-async", action="store_true",
                    help="completion-based async tier I/O")
    ap.add_argument("--preempt-policy", default=_DEF.preempt_policy,
                    choices=["none", "swap", "recompute"])
    ap.add_argument("--admit-mode", default=_DEF.admit_mode,
                    choices=["continuous", "closed"])
    ap.add_argument("--fault-trace", default="",
                    choices=[""] + sorted(FAULT_PRESETS),
                    help="inject a named endpoint-fault preset into the "
                         "attached tier")
    ap.add_argument("--fault-seed", type=int, default=_DEF.fault_seed)
    ap.add_argument("--tp", type=int, default=_DEF.tp,
                    help="ranks of the model axis: the weights (by "
                         "param_specs) and the paged KV cache's pages are "
                         "split over N processes, the MoE is expert-"
                         "parallel (the dense and MoE families); the tier "
                         "gets one root-port set per rank")
    ap.add_argument("--load", action="store_true",
                    help="open-loop mode: play a seeded arrival trace on "
                         "the simulated clock instead of submitting all "
                         "requests up front; prints the SLO summary")
    ap.add_argument("--rate", type=float, default=8000.0,
                    help="open-loop offered load, requests per simulated "
                         "second")
    ap.add_argument("--arrival", default="poisson",
                    choices=["poisson", "bursty"],
                    help="open-loop inter-arrival process")
    ap.add_argument("--arrivals", type=int, default=64,
                    help="open-loop trace length (number of requests)")
    ap.add_argument("--zipf-s", type=float, default=1.1,
                    help="zipf exponent for prompt popularity (prefix "
                         "reuse); larger = more skew")
    args = ap.parse_args(argv)
    topology = tuple(m.strip() for m in
                     args.cxl_topology.split(",") if m.strip())
    tier_faults = ()
    if args.fault_trace:
        n_ports = len(topology) if topology else (1 if args.cxl_media
                                                  else 0)
        tier_faults = resolve_fault_preset(args.fault_trace, n_ports)
    config = ServeConfig(
        n_slots=args.slots, max_seq=args.max_seq,
        prefill_chunk=args.prefill_chunk, seed=args.seed,
        kv_quant=args.kv_quant, cxl_async=args.cxl_async,
        preempt_policy=args.preempt_policy, admit_mode=args.admit_mode,
        tier_media=args.cxl_media, tier_topology=topology,
        tier_placement=args.cxl_placement,
        tier_heat_half_life_ns=args.cxl_heat_half_life_ns,
        tier_sr=not args.cxl_sr_off,
        tier_faults=tier_faults, fault_seed=args.fault_seed, tp=args.tp)
    load = None
    if args.load:
        from repro_torch.serving.loadgen import LoadConfig
        load = LoadConfig(n_arrivals=args.arrivals, rate_rps=args.rate,
                          arrival=args.arrival, zipf_s=args.zipf_s,
                          seed=args.seed)
    run = serve_ranks if config.n_world > 1 else serve
    run(args.arch, smoke=args.smoke, n_requests=args.requests,
        max_new=args.max_new, config=config, device=args.device, load=load)


if __name__ == "__main__":
    main()
