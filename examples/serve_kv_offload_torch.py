"""Serving example on the PyTorch port: continuous batching + CXL-timed KV
page lifecycle.

The port's counterpart of ``examples/serve_kv_offload.py``. The hot path
(chunked prefill, on-device sampling; on the card the ``flash_prefill``
and ``paged_decode`` kernels) runs on smoke gemma-2b; retired requests'
pages flush to the host tier in the background under QoS control, and
resubmitted requests are restored from the cold tier -- the
speculative-read fetch -- with zero prefill dispatches. The attached CXL
tier (SSD media bin) charges every page movement against the simulated
endpoint. A second act hot-removes a root port mid-decode: the pages
striped onto it are lost, the affected requests pass through RECOVERING,
and every request still completes.

  python examples/serve_kv_offload_torch.py                 # on the card
  python examples/serve_kv_offload_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import MeshConfig, RunConfig, SHAPES  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving.config import ServeConfig  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

# the reference example's two engines: a Z-NAND-class SSD tier, then a
# two-port tier whose port 1 is removed at 1 ms simulated
OFFLOAD = ServeConfig(n_slots=3, max_seq=64, prefill_chunk=8,
                      tier_media="ssd-fast")
HOT_REMOVE = ServeConfig(n_slots=3, max_seq=64, prefill_chunk=8,
                         cxl_async=True, preempt_policy="recompute",
                         tier_topology=("dram", "ssd-fast"),
                         tier_faults=(("hot_remove", 1.0e6, 1),))


def _drive(engine):
    """Seven requests, then two of them again (restores): the handles."""
    handles = [engine.submit(Request(rid=rid, prompt=[rid + 1, 5, 9],
                                     max_new_tokens=8))
               for rid in range(7)]
    engine.run()
    for rid in (0, 3):
        handles.append(engine.submit(Request(rid=rid, prompt=[rid + 1, 5, 9],
                                             max_new_tokens=4)))
    return handles, engine.run()


def serve_kv_offload(params=None, *, cfg=None, device="cuda",
                     log=print) -> dict:
    """The example's work: both acts on smoke gemma-2b (``cfg``;
    ``params`` random from seed 0 unless given, e.g. the reference's
    carried by ``bridge.params_from_jax``). Returns each act's engine,
    handles and finished requests."""
    cfg = cfg or registry.smoke("gemma-2b")
    rc = RunConfig(model=cfg, shape=SHAPES["decode_32k"], mesh=MeshConfig())
    if params is None:
        params = M.init_model(cfg, device=device)
    engine = ServingEngine(params, cfg, rc, device=device, config=OFFLOAD)
    tier = engine.tier
    handles = [engine.submit(Request(rid=rid, prompt=[rid + 1, 5, 9],
                                     max_new_tokens=8)) for rid in range(7)]
    engine.run()
    # prefix reuse: resubmit two of the finished rids -- their pages come
    # back from the tiered store instead of re-prefilling
    prefill_before = engine.stats["prefill_dispatches"]
    for rid in (0, 3):
        handles.append(engine.submit(Request(rid=rid, prompt=[rid + 1, 5, 9],
                                             max_new_tokens=4)))
    finished = engine.run()      # the cumulative finished list

    for h in handles[:3]:
        ttft = f"{h.ttft_ns / 1e3:.0f}us" if h.ttft_ns is not None else "-"
        log(f"request {h.rid}: done={h.done()} -> {h.result()} "
            f"(TTFT {ttft}, TPOT {h.tpot_ns / 1e3:.1f}us/tok, "
            f"restore stall {h.restore_stall_ns / 1e3:.0f}us)")
    restored = [r for r in finished if r.restored]
    log(f"{len(finished)} requests served, "
        f"{engine.stats['decode_tokens']} tokens in "
        f"{engine.stats['prefill_dispatches']} prefill + "
        f"{engine.stats['decode_dispatches']} decode dispatches; "
        f"{engine.stats['flushes']} page sets flushed to the cold tier "
        f"({engine.store.bytes / 1024:.0f} KiB held, "
        f"{engine.store.evictions} LRU evictions); "
        f"staging never blocked: {engine.flusher.suppressed} flush "
        f"windows deferred by QoS")
    log(f"prefix reuse: {len(restored)} resubmits restored from retired "
        f"pages with {engine.stats['prefill_dispatches'] - prefill_before}"
        f" extra prefill dispatches (rids {[r.rid for r in restored]}, "
        f"hits={engine.stats['prefix_hits']})")
    snap = tier.snapshot()
    cold = [r for r in restored if r.restore_stall_ns > 0]
    log(f"cxl tier ({snap['media']}): {snap['writes']} page flushes to "
        f"the EP, {len(cold)} cold restores stalling "
        f"{engine.stats['restore_stall_ns'] / 1e3:.0f}us simulated "
        f"(SR hit rate {snap['sr_hit_rate']:.2f}, "
        f"{snap['prefetches']} MemSpecRd streams, "
        f"{engine.stats['flushes_deferred']} flush windows deferred)")
    out = {"offload": {"engine": engine, "handles": handles,
                       "finished": finished,
                       "extra_prefills": (engine.stats["prefill_dispatches"]
                                          - prefill_before)}}

    # ---- act two: serve through a hot-removed port ------------------
    # the same engine shape on a 2-port tier, with port 1 scheduled to die
    # mid-decode; its striped KV pages are invalidated, the engine sweeps
    # the lost keys, and requests whose fetch failed re-queue through
    # RECOVERING (the recompute policy re-prefills when no host copy
    # survives)
    engine = ServingEngine(params, cfg, rc, device=device, config=HOT_REMOVE)
    handles, finished = _drive(engine)
    st = engine.stats
    if not all(h.done() for h in handles):
        raise RuntimeError("a request did not complete through the "
                           "hot-removed port")
    log(f"hot-remove mid-decode: port 1 died at 1.0ms simulated — "
        f"{st['tier_lost_entries']} tier entries "
        f"({st['tier_lost_bytes'] / 1024:.0f} KiB) lost, "
        f"{st['recoveries']} requests recovered via RECOVERING, "
        f"{len(handles)}/{len(handles)} requests still completed "
        f"({st['tier_ports_down']} port down at drain)")
    out["hot_remove"] = {"engine": engine, "handles": handles,
                         "finished": finished}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    serve_kv_offload(device=args.device)


if __name__ == "__main__":
    main()
