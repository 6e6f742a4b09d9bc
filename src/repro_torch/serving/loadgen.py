"""Open-loop load generation for the serving engine.

Production serving traffic is *open loop*: arrivals keep coming at the
offered rate whether or not the engine keeps up, so queueing delay —
not per-request service time — dominates the latency a user sees. This
module generates that traffic and drives the engine with it on the
simulated clock:

 * **arrival process** — seeded Poisson (exponential inter-arrival) or
   bursty (interrupted Poisson: geometric-length bursts at
   ``burst_factor`` × the base rate, separated by OFF gaps sized so the
   long-run mean rate still equals ``rate_rps``);
 * **prompt popularity** — a fixed catalog of ``n_prompts`` prompts
   drawn once, then sampled per arrival from a zipf(``zipf_s``)
   rank-frequency distribution, so prefix reuse mirrors millions of
   users sharing a handful of system prompts (the regime the paper's
   speculative-read path is built for);
 * **mixed lengths** — prompt and output lengths drawn per arrival from
   small discrete level sets (bounded jit-trace count on the chunked
   prefill path while still exercising mixed shapes);
 * **priorities** — a ``hi_prio_frac`` fraction of arrivals is tagged
   priority 1 (interactive class), which the FIFO-vs-preempt sweep in
   ``benchmarks/serve_bench.py`` leans on.

:func:`drive_open_loop` injects the trace against ``engine.clock_ns``:
arrivals whose timestamp has passed are submitted, the engine ticks
while it has work, and genuinely idle gaps fast-forward the clock to
the next arrival (charging the idle time to the tier so DevLoad/QoS
state stays live). :func:`summarize` turns the per-request timing the
engine stamped into a :class:`~repro_torch.serving.stats.LoadMetrics` SLO
summary (TTFT/TPOT p50/p99, goodput at the latency target, queue-depth
and restore-stall percentiles).

Everything is deterministic in ``LoadConfig.seed`` — the same seed
reproduces the identical arrival trace, which is what lets the bench
sweep continuous-vs-closed batching and FIFO-vs-preempt on *identical*
traffic. Module-level imports stay numpy-only (``serve_bench`` loads
this file standalone to derive its schema in the jax-free docs CI job);
engine types are imported lazily inside the driver.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

ARRIVAL_MODES = ("poisson", "bursty")


@dataclasses.dataclass(frozen=True)
class LoadConfig:
    """One open-loop load scenario, fully determined by its fields.

    Rates are requests per *simulated* second (the engine tick clock:
    ``tier_step_ns`` per working tick); SLO targets are simulated ms.
    ``prompt_len_choices`` / ``max_new_choices`` are the discrete length
    levels arrivals mix over — discrete so the chunked prefill path
    compiles a bounded set of shapes.
    """

    n_arrivals: int = 64             # requests in the trace
    rate_rps: float = 8000.0         # mean offered rate (sim req/s)
    arrival: str = "poisson"         # "poisson" | "bursty"
    burst_factor: float = 8.0        # in-burst rate multiplier (bursty)
    burst_len: int = 8               # mean arrivals per burst (bursty)
    zipf_s: float = 1.1              # prompt-popularity exponent
    n_prompts: int = 32              # distinct prompt catalog size
    prompt_len_choices: Tuple[int, ...] = (8, 16, 32)
    max_new_choices: Tuple[int, ...] = (4, 8, 16)
    vocab: int = 1024                # prompt token id range [1, vocab)
    hi_prio_frac: float = 0.0        # fraction tagged priority 1
    seed: int = 0
    slo_ttft_ms: float = 1.5         # goodput latency targets
    slo_tpot_ms: float = 0.5

    def __post_init__(self):
        """Validate the arrival mode and distribution parameters."""
        if self.arrival not in ARRIVAL_MODES:
            raise ValueError(f"unknown arrival mode {self.arrival!r} "
                             f"(expected one of {ARRIVAL_MODES})")
        if self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0 (got {self.rate_rps})")
        if self.zipf_s <= 0:
            raise ValueError(f"zipf_s must be > 0 (got {self.zipf_s})")
        if self.n_prompts < 1 or self.n_arrivals < 1:
            raise ValueError("n_prompts and n_arrivals must be >= 1")
        if self.arrival == "bursty" and (self.burst_factor <= 1
                                         or self.burst_len < 1):
            raise ValueError("bursty mode needs burst_factor > 1 and "
                             "burst_len >= 1")
        if not self.prompt_len_choices or not self.max_new_choices:
            raise ValueError("length choice sets must be non-empty")

    @classmethod
    def field_names(cls) -> Tuple[str, ...]:
        """Declared field names (the bench's load-config schema)."""
        return tuple(f.name for f in dataclasses.fields(cls))


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One generated arrival: when it lands and what it asks for."""

    rid: int                         # unique request id
    t_ns: float                      # arrival timestamp (sim ns)
    prompt: Tuple[int, ...]          # catalog prompt (shared = reusable)
    prompt_id: int                   # catalog rank (0 = most popular)
    max_new: int                     # output-length budget
    priority: int                    # 0 = batch, 1 = interactive


def zipf_probs(cfg: LoadConfig) -> np.ndarray:
    """Analytic zipf(``zipf_s``) rank probabilities over the catalog.

    ``p[k] ∝ (k + 1) ** -s`` normalized over ``n_prompts`` ranks — the
    distribution :func:`make_trace` samples prompt ids from, exposed so
    tests can check the empirical frequencies against it.
    """
    w = np.arange(1, cfg.n_prompts + 1, dtype=np.float64) ** -cfg.zipf_s
    return w / w.sum()


def _inter_arrivals(cfg: LoadConfig, rng: np.random.Generator) -> np.ndarray:
    """Inter-arrival gaps (sim ns) for ``n_arrivals`` requests.

    Poisson mode draws exponential gaps at ``rate_rps``. Bursty mode is
    an interrupted Poisson process: bursts of geometric(1/``burst_len``)
    arrivals at ``burst_factor`` × the base rate, separated by OFF gaps
    whose mean is sized so the long-run rate still equals ``rate_rps``
    (mean cycle time ``burst_len / rate``).
    """
    base_ns = 1e9 / cfg.rate_rps
    if cfg.arrival == "poisson":
        return rng.exponential(base_ns, size=cfg.n_arrivals)
    hot_ns = base_ns / cfg.burst_factor
    off_mean_ns = cfg.burst_len * base_ns * (1.0 - 1.0 / cfg.burst_factor)
    gaps = np.empty(cfg.n_arrivals)
    left = 0                          # arrivals left in the current burst
    for i in range(cfg.n_arrivals):
        if left == 0:
            left = int(rng.geometric(1.0 / cfg.burst_len))
            gaps[i] = rng.exponential(off_mean_ns) if i else 0.0
        else:
            gaps[i] = rng.exponential(hot_ns)
        left -= 1
    return gaps


def make_trace(cfg: LoadConfig) -> List[Arrival]:
    """Generate the full seeded arrival trace for one scenario.

    One ``default_rng(seed)`` drives every draw in a fixed order, so the
    trace is bit-reproducible: identical configs produce identical
    traces (the property the continuous-vs-closed and FIFO-vs-preempt
    sweeps rely on, and which ``tests/test_loadgen.py`` gates).
    """
    rng = np.random.default_rng(cfg.seed)
    lens = rng.choice(cfg.prompt_len_choices, size=cfg.n_prompts)
    catalog = [tuple(int(t) for t in rng.integers(1, cfg.vocab, size=int(n)))
               for n in lens]
    ranks = rng.choice(cfg.n_prompts, size=cfg.n_arrivals,
                       p=zipf_probs(cfg))
    news = rng.choice(cfg.max_new_choices, size=cfg.n_arrivals)
    prios = (rng.random(cfg.n_arrivals) < cfg.hi_prio_frac).astype(int)
    gaps = _inter_arrivals(cfg, rng)
    t = 0.0
    trace = []
    for i in range(cfg.n_arrivals):
        t += float(gaps[i])
        trace.append(Arrival(rid=i, t_ns=t, prompt=catalog[int(ranks[i])],
                             prompt_id=int(ranks[i]),
                             max_new=int(news[i]), priority=int(prios[i])))
    return trace


def drive_open_loop(engine, trace: List[Arrival], *,
                    max_ticks: int = 100_000):
    """Play an arrival trace against the engine on the simulated clock.

    Each iteration submits every arrival whose timestamp the engine
    clock has passed, then either ticks the engine (when it has queued,
    running or in-flight work) or fast-forwards the clock to the next
    arrival (``engine.advance_time`` — the tier sees the idle window, so
    QoS ladders and background flushes stay live). The loop ends when
    the trace is exhausted and the engine drains, or at ``max_ticks``;
    a final ``engine.run(max_ticks=0)`` drains outstanding async tier
    ops so end-of-run stats are horizon-independent.

    Returns ``(handles, queue_depths)``: one ``RequestHandle`` per
    arrival in trace order, plus the per-tick queue-depth samples the
    SLO summary turns into percentiles.
    """
    from repro_torch.serving.engine import Request

    handles = []
    depths: List[int] = []
    i, ticks = 0, 0
    while True:
        now = engine.clock_ns
        while i < len(trace) and trace[i].t_ns <= now:
            a = trace[i]
            handles.append(engine.submit(
                Request(rid=a.rid, prompt=list(a.prompt),
                        max_new_tokens=a.max_new, priority=a.priority),
                arrival_ns=a.t_ns))
            i += 1
        busy = (engine.queue or any(s is not None for s in engine.slots)
                or engine.scheduler.busy())
        if busy:
            if ticks >= max_ticks:
                break
            engine.step()
            ticks += 1
            depths.append(len(engine.queue))
        elif i < len(trace):
            engine.advance_time(max(trace[i].t_ns - now, 1.0))
        else:
            break
    engine.run(max_ticks=0)           # drain async tier ops at the horizon
    # Fault recovery during that drain can re-queue RECOVERING requests
    # (a failed in-flight fetch has nowhere else to land at the horizon);
    # keep ticking until they finish so page loss never strands work —
    # bounded because each request force-prefills after a few failures.
    extra = 0
    while (engine.queue or any(s is not None for s in engine.slots)
           or engine.scheduler.busy()) and extra < max_ticks:
        engine.step()
        extra += 1
    return handles, depths


def _pct(values, q: float) -> float:
    """Percentile helper returning 0.0 on an empty sample."""
    arr = np.asarray(list(values), dtype=np.float64)
    return float(np.percentile(arr, q)) if arr.size else 0.0


def summarize(engine, handles, queue_depths, cfg: LoadConfig):
    """Fold one driven scenario into a ``LoadMetrics`` SLO summary.

    TTFT/TPOT come from the per-request timestamps the engine stamped on
    its tick clock (``arrival_ns`` / ``first_token_ns`` / ``finish_ns``);
    goodput counts completions within *both* SLO targets per simulated
    second of engine-clock span.
    """
    from repro_torch.serving.stats import LoadMetrics

    done = [h for h in handles if h.done()]
    ttft = [h.ttft_ns / 1e6 for h in done if h.ttft_ns is not None]
    tpot = [h.tpot_ns / 1e6 for h in done if h.tpot_ns is not None]
    stall = [h.restore_stall_ns / 1e6 for h in done]
    in_slo = sum(1 for h in done
                 if h.ttft_ns is not None and h.tpot_ns is not None
                 and h.ttft_ns / 1e6 <= cfg.slo_ttft_ms
                 and h.tpot_ns / 1e6 <= cfg.slo_tpot_ms)
    sim_s = max(engine.clock_ns / 1e9, 1e-12)
    return LoadMetrics(
        arrivals=len(handles),
        completed=len(done),
        completed_in_slo=in_slo,
        goodput_req_s=round(in_slo / sim_s, 2),
        throughput_req_s=round(len(done) / sim_s, 2),
        ttft_ms_p50=round(_pct(ttft, 50), 4),
        ttft_ms_p99=round(_pct(ttft, 99), 4),
        tpot_ms_p50=round(_pct(tpot, 50), 4),
        tpot_ms_p99=round(_pct(tpot, 99), 4),
        queue_depth_p50=round(_pct(queue_depths, 50), 2),
        queue_depth_p99=round(_pct(queue_depths, 99), 2),
        restore_stall_ms_p50=round(_pct(stall, 50), 4),
        restore_stall_ms_p99=round(_pct(stall, 99), 4),
        slo_ttft_ms=cfg.slo_ttft_ms,
        slo_tpot_ms=cfg.slo_tpot_ms,
        sim_time_ms=round(engine.clock_ns / 1e6, 4),
        preemptions=engine.stats["preemptions"],
        prefix_hits=engine.stats["prefix_hits"],
        recoveries=engine.stats["recoveries"],
        lost_requests=len(handles) - len(done),
    )
