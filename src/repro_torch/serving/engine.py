"""Continuous-batching serving engine over the paged, tiered KV cache.

The port of the reference's ``repro.serving.engine`` for the dense, MoE,
audio, hybrid, VLM and xLSTM families:
same surface (``Request``, ``RequestHandle``, ``HostPageStore``,
``ServingEngine`` with ``submit`` / ``step`` / ``run`` / ``advance_time``
/ ``stats``), same scheduler hooks, and the same CXL-timed tier charges, so
both engines produce the same tokens and the same tier traces on the same
traffic.

 * slots — the engine runs a fixed decode batch; requests stream through
   slots (continuous batching). Each slot owns a page range of the cache
   and its own position (per-slot ``pos`` vector). Every slot advances one
   position per decode tick, empty slots included, as in the reference.
 * tiered pages — a finished slot's pages retire through the staging
   flusher (deterministic store) into the host-side page store, keyed by
   request id; prefix reuse fetches them back instead of re-prefilling.
   With a ``CxlTier`` attached every page movement is charged against the
   simulated endpoints. The hybrid and VLM families flush their
   attention pages too, but are never restored from them: the Mamba2
   state, or the vision K/V, is not in the pages (as in the reference).
   xLSTM has no pages at all: nothing is staged, flushed or restored.
 * hot path — chunked prefill (one ``prefill_step_cached`` per chunk on a
   view of the slot's cache row, through the flash-prefill kernel and,
   for the hybrid, the SSD-scan kernel; xLSTM steps its recurrent layers
   token by token, on no kernel) and one decode tick for every slot with
   on-device sampling (through the paged-decode kernel). The cache is
   updated in place where the reference donates it; sampled tokens stay
   on the device until a slot retires. As in the reference, no slot state
   is reset at admission (the Mamba2 and xLSTM states, the int8 scales),
   and the VLM's vision K/V stay at the cache's zeros: the serving path
   has no vision input.

With ``kv_quant="int8"`` the pages are int8 codes with per-(page, head)
f32 scales: flush, restore, swap and prefix entries carry both, and every
tier charge and store budget counts their bytes.

Multi-rank serving (``ServeConfig(tp=N)`` or ``mesh_shape=(D, N)`` /
``(P, D, N)``, every family): one engine per rank process, each given its
place in the rank mesh (``launch.mesh``: a ``RankGroup`` for the model
axis alone, else a ``RankMesh``). Every rank runs the same scheduler on
the same traffic. It holds its shard of the weights, split by the
reference's ``param_specs`` (``parallel.sharding``: the attention's and
MLP's columns / rows, the vocabulary, the experts, the Mamba2 and xLSTM
projections) and, at ``param_tier="pool"`` or ``"host"`` over a data
axis, cut again on their FSDP axes (``core.hdm.HDMStore``): each step
gathers a layer's FSDP shards over the data group on the speculative
read's schedule, one layer ahead at ``sr_prefetch_depth`` 1
(``core.speculative_read``). With ``param_tier="host"`` and
``rc.enable_host_tier`` the weights (a rank's shard, or all of them on
one rank) live in pinned host memory, and each step copies a layer onto
the card on a side stream ``sr_prefetch_depth`` layers ahead of its use.
Its cache holds its own page range of every slot it holds: the slots
split over the batch axes (data, or pod and data with ``multi_pod``) and
the pages over the model axis, or, with one slot, the pages over the data
and model axes together (the reference's ``decode_axes``). So the decode is the
page-sharded one on each rank's slots, a prefill chunk runs on the row
that holds its slot and gathers the slot's pages there (the other rows
join its FSDP gathers), the MoE is expert-parallel and the Mamba2 layers
run the rank's heads. Every sampled token reaches every rank: a tick's
tokens are gathered over the batch axes, a prefill's first token is
broadcast from its row. The per-slot states (Mamba2 ``h`` / ``conv``,
xLSTM's cells and conv windows, the vision K/V, ``pos``, the int8
scales) go with their slot and are whole on every rank of the model axis,
as the reference's ``cache_specs`` leaves them.
A retired entry in a rank's ``HostPageStore`` is that rank's page shard,
sent to every row by the row that held the slot, so a restore can land on
any row, which writes each rank's shard into its pages. Each rank holds a
replica of the tier, charged once per operation with the whole entry's
bytes (``_WholeEntryCharges``), so the tier, the stats and the
scheduling are those of the reference's one process, on every rank.

Not ported: the legacy host path (``ServeConfig`` raises for it), and
the MoE family over the data and model axes at once (the reference's
raises too).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import deterministic_store as ds
from repro_torch.core.hdm import HDMStore
from repro_torch.core.qos import QoSController
from repro_torch.core.tier import CxlTier
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as M
from repro_torch.parallel import sharding
from repro_torch.serving import scheduler as sched
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.stats import EngineStats


@dataclasses.dataclass
class Request:
    """One serving request: prompt tokens in, generated tokens out.

    ``restore_stall_ns`` is the simulated CXL demand-fetch stall (ns)
    charged when the request was served via a cold-tier prefix restore
    (0.0 otherwise or without an attached tier). ``priority`` orders
    admission (higher first, FIFO among equals) and marks preemption
    victims; ``state`` walks the scheduler's lifecycle (QUEUED ->
    RESTORING -> RUNNING -> PREEMPTED/SWAPPED -> RETIRED, see
    ``repro_torch.serving.scheduler``).
    """

    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    priority: int = 0
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    slot: Optional[int] = None
    state: str = sched.QUEUED
    restored: bool = False
    restore_stall_ns: float = 0.0
    recoveries: int = 0
    # SLO timestamps on the engine's simulated clock
    arrival_ns: Optional[float] = None
    first_token_ns: Optional[float] = None
    finish_ns: Optional[float] = None
    # device-resident bookkeeping: the sampled first token (a 0-d device
    # tensor) plus this request's tick range in the engine trace
    _first_tok: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False)
    _start_tick: int = 0
    _n_gen: int = 0
    _n_dec: int = 0


class RequestHandle:
    """What ``ServingEngine.submit`` returns: one request's progress view.

    Callers poll :meth:`done` / read :meth:`result` instead of fishing
    retired ``Request`` objects out of ``run()``'s return list (which
    still returns them, as the deprecation shim for the old shape). The
    timing properties expose the per-request SLO measurements on the
    engine's simulated clock (TTFT / TPOT).
    """

    def __init__(self, request: Request, engine: "ServingEngine"):
        self._req = request
        self._engine = engine

    @property
    def rid(self) -> int:
        """The submitted request's id."""
        return self._req.rid

    @property
    def request(self) -> Request:
        """The underlying ``Request`` (escape hatch for tests/tools)."""
        return self._req

    def done(self) -> bool:
        """True once the request retired (its token stream is final)."""
        return self._req.done

    def result(self) -> List[int]:
        """The generated token stream; raises while still pending."""
        if not self._req.done:
            raise RuntimeError(f"request {self._req.rid} is still "
                               f"{self._req.state}; call done() first")
        return list(self._req.generated)

    def tokens(self) -> List[int]:
        """Tokens materialized so far (empty until retirement on the
        device-resident path — the stream lives on device mid-flight)."""
        return list(self._req.generated)

    @property
    def ttft_ns(self) -> Optional[float]:
        """Time to first token (simulated ns), None until it exists."""
        if self._req.first_token_ns is None or self._req.arrival_ns is None:
            return None
        return self._req.first_token_ns - self._req.arrival_ns

    @property
    def tpot_ns(self) -> Optional[float]:
        """Mean time per output token after the first (simulated ns)."""
        if self._req.finish_ns is None or self._req.first_token_ns is None:
            return None
        span = self._req.finish_ns - self._req.first_token_ns
        return span / max(len(self._req.generated) - 1, 1)

    @property
    def restore_stall_ns(self) -> float:
        """Simulated ns this request stalled on cold-tier fetches."""
        return self._req.restore_stall_ns

    @property
    def recoveries(self) -> int:
        """RECOVERING re-queues this request survived (failed tier
        fetches and pages lost to a hot-removed port; 0 without faults)."""
        return self._req.recoveries


# Families whose full per-request decode state lives in the paged "kv"
# leaves — the only ones prefix restore can reconstruct a slot from.
_RESTORABLE_FAMILIES = ("dense", "moe", "audio")


def _to_host(kv: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of the pages as CPU tensors (the reference runs
    ``np.asarray`` over the leaves)."""
    return {name: t.detach().to("cpu", copy=True) for name, t in kv.items()}


class HostPageStore:
    """Cold tier for retired KV pages (the SSD-EP analogue).

    LRU-bounded by ``budget_bytes``: inserts evict the least-recently-used
    entries until the store fits; ``get`` refreshes recency. ``bytes`` and
    ``evictions`` are surfaced through the engine stats. ``on_evict`` is
    called as ``on_evict(rid, entry, reason)`` for every dropped
    (``reason="evict"``) or replaced (``reason="replace"``) entry so side
    indexes (the engine's prompt->rid alias map) stay bounded too — and so
    the engine can release a truly evicted entry's CXL-tier segments
    without freeing the pages a replacement just rewrote. ``put`` reports
    whether the entry survived admission: budget pressure can evict an
    entry during its own insert, and indexing such an entry would leak.
    A rank of a multi-rank engine stores its shard of each entry, one of
    ``shards``, and accounts the whole entry's bytes.
    """

    def __init__(self, budget_bytes: Optional[int] = None, on_evict=None,
                 shards: int = 1):
        self.pages: "collections.OrderedDict[int, Dict]" = \
            collections.OrderedDict()
        self.budget_bytes = budget_bytes
        self.on_evict = on_evict
        self.shards = shards
        self.bytes = 0
        self.evictions = 0

    def _entry_bytes(self, entry) -> int:
        # one canonical entry-size helper for the whole page path: the
        # tier charges the same byte counts this budget is accounted in
        return CxlTier.entry_bytes(entry) * self.shards

    def put(self, rid: int, entry) -> bool:
        """Insert/replace an entry (a dict whose ``"kv"`` pages are copied
        to CPU tensors); returns True iff ``rid`` survived admission."""
        entry = dict(entry)
        entry["kv"] = _to_host(entry["kv"])
        if rid in self.pages:
            old = self.pages.pop(rid)
            self.bytes -= self._entry_bytes(old)
            if self.on_evict is not None:
                self.on_evict(rid, old, "replace")
        self.pages[rid] = entry
        self.bytes += self._entry_bytes(entry)
        self._evict()
        return rid in self.pages

    def get(self, rid: int):
        """Fetch ``rid``'s entry (refreshing LRU recency), else None."""
        entry = self.pages.get(rid)
        if entry is not None:
            self.pages.move_to_end(rid)
        return entry

    def drop(self, rid: int) -> bool:
        """Remove ``rid`` outright, regardless of budget or recency (the
        fault-recovery path); fires ``on_evict`` with ``reason="evict"``.
        Returns True iff the rid was present."""
        old = self.pages.pop(rid, None)
        if old is None:
            return False
        self.bytes -= self._entry_bytes(old)
        self.evictions += 1
        if self.on_evict is not None:
            self.on_evict(rid, old, "evict")
        return True

    def _evict(self) -> None:
        if self.budget_bytes is None:
            return
        while self.bytes > self.budget_bytes and self.pages:
            rid, old = self.pages.popitem(last=False)
            self.bytes -= self._entry_bytes(old)
            self.evictions += 1
            if self.on_evict is not None:
                self.on_evict(rid, old, "evict")


def _rank_arg(req_rank) -> tuple:
    # a ``CxlTier`` (one model rank) takes no requesting rank
    return () if req_rank is None else (req_rank,)


def _real(group):
    """``group`` where it has more than one rank, else None."""
    return group if group is not None and group.size > 1 else None


class _WholeEntryCharges:
    """A rank's replica of the tier, charged with the whole entry's bytes.

    Each rank holds ``1 / n_ranks`` of every entry, and the engine and
    scheduler size each charge from the rank's own entry; the five calls
    that take a byte count scale it to the whole entry's (the shards are
    equal), so each operation is charged once, as the reference's one
    process charges its ``ShardedTier``. Every other attribute is the
    tier's own."""

    def __init__(self, tier, n_ranks: int):
        self.inner = tier
        self.n_ranks = n_ranks

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def write_entry(self, key, nbytes: int) -> float:
        return self.inner.write_entry(key, nbytes * self.n_ranks)

    def write_entry_async(self, key, nbytes: int):
        return self.inner.write_entry_async(key, nbytes * self.n_ranks)

    def read_entry(self, key, nbytes: int, req_rank=None) -> float:
        return self.inner.read_entry(key, nbytes * self.n_ranks,
                                     *_rank_arg(req_rank))

    def read_entry_async(self, key, nbytes: int, req_rank=None):
        return self.inner.read_entry_async(key, nbytes * self.n_ranks,
                                           *_rank_arg(req_rank))

    def speculative_read(self, key, nbytes: int) -> None:
        return self.inner.speculative_read(key, nbytes * self.n_ranks)


class ServingEngine:
    """Fixed-batch continuous batching with tiered page lifecycle."""

    def __init__(self, params: M.DenseModel, cfg: ModelConfig,
                 rc: RunConfig, *, config: Optional[ServeConfig] = None,
                 cxl_tier: Optional[CxlTier] = None, device="cuda",
                 group=None, **knobs):
        """Build the engine from a :class:`ServeConfig` on ``device``.

        ``params`` must already live on ``device`` (``init_model`` /
        ``bridge.params_from_jax`` put them there). ``config`` carries every
        knob; passing the keyword knobs directly (``n_slots=...``) builds
        the ServeConfig with the same validation. ``cxl_tier`` injects a
        prebuilt tier; otherwise ``config.make_tier()`` builds whatever the
        config declares. With a mesh of more than one rank
        (``config.n_world``) the engine serves as this process's rank of
        it: ``group`` is its ``launch.mesh.RankMesh`` (``spawn`` with
        ``mesh_shape``, ``init_mesh``), or for the model axis alone its
        ``RankGroup`` (``init_group``). Whole weights are cut to the
        rank's shard (``core.hdm.HDMStore.place``, as the reference places
        its parameters by ``param_specs``); a shard already cut for this
        rank is taken as it is.
        """
        if config is not None and knobs:
            raise TypeError("pass either config=ServeConfig(...) or the "
                            f"legacy keyword knobs, not both: "
                            f"{sorted(knobs)}")
        if config is None:
            config = ServeConfig(**knobs)
        self.mesh = self._rank_mesh(config, rc, cfg, group)
        self.device = resolve_device(device)
        p_dev = next(params.parameters()).device
        if p_dev.type != self.device.type or (
                self.device.index is not None and p_dev != self.device):
            raise ValueError(f"params live on {p_dev}, engine device is "
                             f"{self.device}")
        self.serve_config = config
        # int8 pages: thread the knob into the RunConfig, so that
        # cache_init emits codes + scales and every tier charge sees the
        # quantized byte counts
        if config.kv_quant != "none" and rc.kv_quant != config.kv_quant:
            rc = dataclasses.replace(rc, kv_quant=config.kv_quant)
        n_slots = config.n_slots
        # the rank groups of the steps, the slot rows and the page shards
        self.ranks = M.Ranks()
        self._rows, self._dp, page_shards = (0, 1), None, 1
        mp = rc.mesh.multi_pod
        store = HDMStore(self.mesh, tier=rc.param_tier,
                         enable_host_tier=rc.enable_host_tier,
                         multi_pod_fsdp=mp)
        if self.mesh is None and store.pinned:
            params = store.place(params)
        if self.mesh is not None:
            params = self._rank_params(params, store)
            dp = self.mesh.dp(mp)
            if n_slots == 1:       # no batch to split: pages over all axes
                pages = self.mesh.all_axes(mp)
            else:
                pages = self.mesh.model
                self._rows, self._dp = (dp.rank, dp.size), _real(dp)
                if n_slots % dp.size:
                    raise ValueError(f"{n_slots} slots do not split over "
                                     f"{dp.size} rows of the batch axes")
            page = min(rc.kv_page_size, config.max_seq)
            sharding.check_pages(max(config.max_seq // page, 1), pages.size,
                                 config.max_seq, rc.kv_page_size)
            page_shards = pages.size
            self.ranks = M.Ranks(model=_real(self.mesh.model),
                                 pages=_real(pages),
                                 fsdp=store.fsdp_group(), batch=self._dp)
        self.params = params
        self.cfg = cfg
        self.rc = rc
        # as the reference's engine: where the FSDP axes have one rank the
        # stream's prefetch slots gather nothing, and it runs without them
        # -- unless the weights live on the HOST tier, whose reads are
        # copies onto the card
        self._hot_rc = rc
        fsdp_size = 1 if self.mesh is None else (self.mesh.shape[0]
                                                 * self.mesh.shape[1])
        if rc.sr_prefetch_depth and fsdp_size == 1 and not store.pinned:
            self._hot_rc = dataclasses.replace(rc, sr_prefetch_depth=0)
        self.n_slots = n_slots
        self.max_seq = config.max_seq
        self.temperature = config.temperature
        self.prefill_chunk = max(1, min(config.prefill_chunk,
                                        config.max_seq))
        self.legacy = False           # the legacy host path is not ported
        self.sync_prefill = config.sync_prefill
        # on-device sampling draws its uniforms from this generator
        self.gen = torch.Generator(device=self.device).manual_seed(
            config.seed)
        self.cache = M.cache_init(cfg, rc, n_slots, config.max_seq,
                                  device=self.device)
        if self.mesh is not None:
            self.cache = sharding.shard_cache(
                self.cache, 0 if page_shards == 1 else pages.rank,
                page_shards, self._rows)
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.qos = QoSController()
        # CXL-timed tier: every page movement below is charged against the
        # simulated endpoint (restore stall, flush cost, SR prefetch), and
        # the EP's announced state gates the flusher's admission window.
        self.tier = cxl_tier if cxl_tier is not None else config.make_tier()
        if page_shards > 1 and self.tier is not None:
            self.tier = _WholeEntryCharges(self.tier, page_shards)
        self.tier_step_ns = config.tier_step_ns
        self.cxl_async = bool(config.cxl_async)
        self._restorable = cfg.family in _RESTORABLE_FAMILIES
        self.clock_ns = 0.0
        self._async_writes: List = []
        self.scheduler = sched.RequestScheduler(
            self, async_restore=self.cxl_async,
            preempt_policy=config.preempt_policy,
            admit_mode=config.admit_mode)
        self.store = HostPageStore(budget_bytes=config.store_budget_bytes,
                                   on_evict=self._drop_prompt_alias,
                                   shards=page_shards)
        self._prompt_index: Dict[Tuple[int, ...], int] = {}
        self.flusher = ds.StagingFlusher(
            sink=self._store_sink, qos=self.qos,
            admit=self.tier.admit_store if self.tier is not None else None)
        # device-resident tick state. ``last_tokens`` (every slot's, on
        # every rank) is replaced, never written in place: the trace keeps
        # each tick's tensor until the requests that sampled it retire.
        self.last_tokens = torch.zeros((n_slots,), dtype=torch.int32,
                                       device=self.device)
        self._pos_host = [0] * n_slots      # mirror of cache["pos"]
        self._tick = 0
        self._trace: Dict[int, torch.Tensor] = {}   # tick -> [n_slots] toks
        self._trace_np: Dict[int, np.ndarray] = {}  # memoized transfers
        self.stats = EngineStats()
        self.stats["mesh_ranks"] = config.n_ranks

    @staticmethod
    def _rank_mesh(config: ServeConfig, rc: RunConfig, cfg: ModelConfig,
                   group):
        """This process's ``RankMesh`` for ``config``'s mesh (None for one
        rank), checked against the mesh's shape; a ``RankGroup`` stands
        for a mesh of the model axis alone."""
        shape = config.resolved_mesh_shape
        if isinstance(group, mesh_lib.RankMesh):
            group_size = group.world.size
        else:
            group_size = 1 if group is None else group.size
        if config.n_world == 1:
            if group_size != 1:
                raise ValueError(f"a rank group of {group_size} for one "
                                 f"rank")
            return None
        M.check_ranks(cfg, shape, rc.mesh.multi_pod)
        want = mesh_lib.mesh_shape3(shape)
        if isinstance(group, mesh_lib.RankGroup) and want[:2] == (1, 1):
            group = mesh_lib.RankMesh.of_group(group)
        if (not isinstance(group, mesh_lib.RankMesh)
                or group.shape != want):
            raise ValueError(
                f"mesh {shape} needs this process's rank mesh of "
                f"{config.n_world} ranks (launch.mesh.init_mesh or spawn "
                f"with mesh_shape; a RankGroup for the model axis alone); "
                f"got {'none' if group is None else group_size}")
        return group

    def _rank_params(self, params, store: HDMStore):
        """This rank's shard of ``params``: cut from whole weights, or
        checked to be this rank's."""
        fsdp = store.fsdp_group()
        mine = (self.mesh.model.rank, self.mesh.model.size)
        if fsdp is not None:
            mine += (fsdp.rank, fsdp.size)
        held = getattr(params, "shard", None)
        if held is None:
            return store.place(params)
        if tuple(held) != mine:
            raise ValueError(f"params are the shard {tuple(held)}; this "
                             f"engine's is {mine} (model rank, ranks, "
                             f"and FSDP rank, ranks on the POOL tier)")
        return params

    # ------------------------------------------------------- slot rows
    def _local(self, slot: int) -> Optional[int]:
        """``slot``'s row in this rank's cache, or None where another row
        of the batch axes holds it."""
        row, n_rows = self._rows
        per = self.n_slots // n_rows
        return slot - row * per if slot // per == row else None

    def _row_of(self, slot: int) -> int:
        return slot // (self.n_slots // self._rows[1])

    def _set_pos(self, slot: int, pos: int) -> None:
        local = self._local(slot)
        if local is not None:
            self.cache["pos"][local] = pos

    # ----------------------------------------------------------- step fns
    def _uniform(self, n: int) -> torch.Tensor:
        return torch.rand((n,), generator=self.gen, device=self.device)

    def _sample(self, row: torch.Tensor,
                u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sample ``row`` [b, V]; temperature sampling takes the uniforms
        ``u`` [b], by default b drawn from the engine's generator."""
        if self.temperature > 0:
            return M.sample_tokens(
                row, self._uniform(row.shape[0]) if u is None else u,
                self.temperature)
        return M.sample_tokens(row, None, 0.0)

    def _with_token(self, slot: int, tok) -> torch.Tensor:
        """``last_tokens`` with ``slot`` set to ``tok`` (a new tensor)."""
        out = self.last_tokens.clone()
        out[slot] = tok
        return out

    def _codebooks(self, tokens: torch.Tensor) -> torch.Tensor:
        """[B, S] tokens as the model takes them: the audio family feeds
        the one sampled stream to every codebook, [B, K, S]."""
        if self.cfg.family != "audio":
            return tokens
        b, s = tokens.shape
        return tokens[:, None].expand(b, self.cfg.n_codebooks, s)

    def _decode_sample(self) -> torch.Tensor:
        """One decode tick: step this rank's slots + sample on device;
        every slot's token, gathered over the batch axes."""
        row, n_rows = self._rows
        per = self.n_slots // n_rows
        lo = row * per
        logits, self.cache = M.decode_step(
            self.params, self.cfg, self._hot_rc,
            self._codebooks(self.last_tokens[lo:lo + per, None]),
            self.cache, ranks=self.ranks)
        last = M.last_token_logits(logits)
        if self._dp is None:
            return self._sample(last)
        # every slot's uniform drawn on every rank, as one process draws
        # them, and this row's taken
        tok = (self._sample(last, self._uniform(self.n_slots)[lo:lo + per])
               if self.temperature > 0 else self._sample(last))
        return self._dp.all_gather(tok).reshape(-1)

    def _prefill_chunk(self, tokens: torch.Tensor, slot: int, pos0: int,
                       new_pos: int, sample: bool):
        """One prefill chunk for one slot, in place on its pages.

        Runs the chunked prefill on views of the slot's row of every cache
        leaf (pages, the hybrid's Mamba2 states, the VLM's vision K/V,
        xLSTM's states) with the slot position pinned to the chunk start
        (a reused slot's device pos is stale — decode advances every row
        each tick). As in the reference, the recurrent states are not
        reset at admission: the scan starts from whatever the slot's
        previous tenant and the idle ticks left there.
        Only the final chunk samples the last-position token. Other slots
        never observe the prefill. With the slots split over the batch
        axes, the row that holds the slot runs the chunk while every other
        row joins its POOL-tier gathers, and the token is broadcast from
        that row."""
        local = self._local(slot)
        ranks = dataclasses.replace(self.ranks, batch=None)
        if local is None:
            M.join_fsdp_reads(self.params, self.cfg, self._hot_rc,
                              ranks=ranks)
        else:
            cache1 = M.slot_view(self.cache, local)
            cache1["pos"] = torch.full((1,), pos0, dtype=torch.int32,
                                       device=self.device)
            logits, _ = M.prefill_step_cached(
                self.params, self.cfg, self._hot_rc, tokens, cache1,
                last_only=sample, ranks=ranks)
            self.cache["pos"][local] = new_pos
        if not sample:
            return None
        if local is None:
            tok = torch.zeros((1,), dtype=torch.int32, device=self.device)
            if self.temperature > 0:
                self._uniform(1)          # keep the generator in step
        else:
            tok = self._sample(M.last_token_logits(logits))
        if self._dp is not None:
            tok = self._dp.broadcast(tok.contiguous(), self._row_of(slot))
        tok = tok[0]
        self.last_tokens = self._with_token(slot, tok)
        return tok

    # ------------------------------------------------------------ admit
    def submit(self, req: Request, *,
               arrival_ns: Optional[float] = None) -> RequestHandle:
        """Enqueue a request (admission happens on a later tick).

        Returns a :class:`RequestHandle`. ``arrival_ns`` backdates the
        arrival timestamp onto the simulated clock (default: now).
        """
        req.arrival_ns = (self.clock_ns if arrival_ns is None
                          else float(arrival_ns))
        # Speculative read at enqueue time: if this request's pages sit in
        # the cold tier, pre-share the addresses with the EP (MemSpecRd)
        # now — admission happens ticks later, so the fill runs ahead of
        # the demand fetch the restore will stall on.
        if self.tier is not None and self._restorable:
            key = self._store_key(req.rid, tuple(req.prompt))
            if key is not None:
                self.tier.speculative_read(
                    key, CxlTier.entry_bytes(self.store.pages[key]))
        self.queue.append(req)
        return RequestHandle(req, self)

    def _prefill_slot(self, req: Request, slot: int,
                      tokens: Optional[List[int]] = None) -> None:
        """Chunked device-resident prefill: one model step per chunk.

        ``tokens`` overrides the ingested sequence (default: the
        request's prompt) — the recompute-resume path feeds the prompt
        plus the already-generated prefix through the same chunked path.
        """
        prompt = list(req.prompt) if tokens is None else list(tokens)
        if len(prompt) + 1 > self.max_seq:
            raise ValueError(f"prompt ({len(prompt)} tokens) does not fit "
                             f"a {self.max_seq}-token slot")
        c = self.prefill_chunk
        chunks = [prompt[i:i + c] for i in range(0, len(prompt), c)]
        pos0, tok = 0, None
        for i, chunk in enumerate(chunks):
            arr = self._codebooks(torch.tensor([chunk], dtype=torch.int32,
                                               device=self.device))
            final = i == len(chunks) - 1
            tok = self._prefill_chunk(arr, slot, pos0, pos0 + len(chunk),
                                      final)
            pos0 += len(chunk)
            self.stats["prefill_dispatches"] += 1
        self.stats["prefill_tokens"] += len(prompt)
        self._pos_host[slot] = len(prompt)
        req._first_tok = tok
        req._start_tick = self._tick
        req._n_gen = 1
        req._n_dec = 0
        if req.first_token_ns is None:
            req.first_token_ns = self.clock_ns
        self.stats["decode_tokens"] += 1
        if self.sync_prefill and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ----------------------------------------------------- prefix restore
    def _store_key(self, rid: int, prompt: Tuple[int, ...]) -> Optional[int]:
        """Cold-tier key holding pages for (rid, prompt), else None.

        A confirmed hit refreshes the entry's LRU recency (the queued
        request will demand-fetch exactly those pages at admission);
        mismatched probes leave recency alone."""
        entry = self.store.pages.get(rid)
        if entry is not None and entry.get("prompt") == prompt:
            self.store.get(rid)
            return rid
        alias = self._prompt_index.get(prompt)
        if alias is not None:
            entry = self.store.pages.get(alias)
            if entry is not None and entry.get("prompt") == prompt:
                self.store.get(alias)
                return alias
        return None

    def _lookup_pages(self, rid: int, prompt: Tuple[int, ...]):
        """Staging index first (latest-write-wins, the deterministic-store
        read path), then the cold tier; rid match first, then prompt.

        Returns ``(entry, store_key, source)``: "staging" (reserved GPU
        memory, nothing to charge) or "store" (a cold-tier hit whose demand
        fetch the restore stalls on)."""
        for _, entry in reversed(self.flusher.pending):
            if isinstance(entry, dict) and entry.get("prompt") == prompt:
                return entry, None, "staging"
        entry = self.store.get(rid)
        if entry is not None and entry.get("prompt") == prompt:
            return entry, rid, "store"
        alias = self._prompt_index.get(prompt)
        if alias is not None and alias != rid:
            entry = self.store.get(alias)
            if entry is not None and entry.get("prompt") == prompt:
                return entry, alias, "store"
        return None, None, None

    def _restore_lookup(self, req: Request):
        """Restorable (entry, store_key, source) for ``req``, else None
        (pure lookup; the scheduler charges the fetch)."""
        if not self._restorable:
            return None
        entry, key, source = self._lookup_pages(req.rid, tuple(req.prompt))
        if entry is None or "pos" not in entry or "first_token" not in entry:
            return None
        if int(entry["pos"]) >= self.max_seq - 1:
            return None                       # no room left to decode into
        return entry, key, source

    def _load_slot_kv(self, slot: int, kv: Dict[str, torch.Tensor]) -> None:
        """This rank's pages of an entry into ``slot``, on the row that
        holds it."""
        local = self._local(slot)
        if local is None:
            return
        for name, a in self.cache["kv"].items():
            a[:, local].copy_(kv[name])

    def _apply_restore(self, req: Request, slot: int, entry) -> None:
        """Rebuild the slot from a retired entry: its post-prefill pages
        plus the prompt's first sampled token at pos=len(prompt), so the
        restored request reproduces the prompt-conditioned continuation."""
        first = int(entry["first_token"])
        self._load_slot_kv(slot, entry["kv"])
        self._set_pos(slot, int(entry["pos"]))
        self.last_tokens = self._with_token(slot, first)
        self._pos_host[slot] = int(entry["pos"])
        req.restored = True
        req._first_tok = None
        req._start_tick = self._tick
        req.generated = req.generated + [first]
        req._n_gen = 1
        req._n_dec = 0
        if req.first_token_ns is None:
            req.first_token_ns = self.clock_ns

    # -------------------------------------------------- preemption state
    def _capture_slot_kv(self, slot: int
                         ) -> Optional[Dict[str, torch.Tensor]]:
        """A copy of this slot's KV pages ([L, P, page, Hkv, D] each, this
        rank's page shard), on the device: the cache itself keeps changing
        in place. With the slots split over the batch axes, the row that
        holds the slot sends its copy to every row. None for a cache
        without pages (xLSTM), as in the reference."""
        if "kv" not in self.cache:
            return None
        local = self._local(slot)
        if self._dp is None:
            return {name: a[:, local].clone() for name, a in
                    self.cache["kv"].items()}
        return {name: self._dp.broadcast(
                    a[:, local].clone() if local is not None
                    else torch.empty_like(a[:, 0]), self._row_of(slot))
                for name, a in self.cache["kv"].items()}

    def _capture_swap_entry(self, req: Request, slot: int) -> Dict:
        """Snapshot a running slot's mid-decode state for swap-out:
        pages (on the host; None without pages), current position and the
        last sampled token."""
        kv = self._capture_slot_kv(slot)
        return {"kv": None if kv is None else _to_host(kv),
                "pos": self._pos_host[slot],
                "last_token": req.generated[-1] if req.generated else 0,
                "prompt": tuple(req.prompt)}

    def _apply_swap_in(self, req: Request, slot: int, entry) -> None:
        """Resume a swapped-out request: pages, position and last token
        back into the slot; decode continues where it was preempted."""
        self._load_slot_kv(slot, entry["kv"])
        pos = int(entry["pos"])
        self._set_pos(slot, pos)
        self.last_tokens = self._with_token(slot, int(entry["last_token"]))
        self._pos_host[slot] = pos
        req._first_tok = None
        req._start_tick = self._tick
        req._n_gen = len(req.generated)
        req._n_dec = 0

    def _recompute_resume(self, req: Request, slot: int) -> None:
        """Resume a recompute-preempted request by re-prefilling the
        prompt plus the already-generated prefix; the re-sampled final
        token is discarded (the stream already holds it)."""
        if not req.generated:             # preempted pre-prefill: fresh
            self._prefill_slot(req, slot)
            return
        fed = list(req.prompt) + req.generated[:-1]
        self._prefill_slot(req, slot, tokens=fed)
        req._first_tok = None             # drop the re-sampled duplicate
        self.stats["decode_tokens"] -= 1
        req._n_gen = len(req.generated)
        self.last_tokens = self._with_token(slot, int(req.generated[-1]))

    # ----------------------------------------------------------- advance
    def _advance(self) -> None:
        """One decode+sample tick; tokens stay on device."""
        self.last_tokens = self._decode_sample()
        self.stats["steps"] += 1
        self.stats["decode_dispatches"] += 1
        self._trace[self._tick] = self.last_tokens
        self._tick += 1
        for slot, req in enumerate(self.slots):
            self._pos_host[slot] += 1     # decode_step advances every row
            if req is None:
                continue
            req._n_gen += 1
            req._n_dec += 1
            self.stats["decode_tokens"] += 1

    # -------------------------------------------------------------- run
    def _materialize_tokens(self, req: Request, slot: int) -> None:
        """Pull the request's sampled tokens off the device trace into
        ``req.generated``; resets the trace span so a resumed request
        appends cleanly."""
        toks: List[int] = []
        if req._first_tok is not None:
            toks.append(int(req._first_tok))
        for t in range(req._start_tick, req._start_tick + req._n_dec):
            toks.append(int(self._tok_tick(t)[slot]))
        req.generated = req.generated + toks
        req._first_tok = None
        req._start_tick = self._tick
        req._n_dec = 0

    def _retire(self, slot: int) -> None:
        """Deterministic store: release the slot immediately; its pages
        flush to the host tier in the background."""
        req = self.slots[slot]
        req.done = True
        req.state = sched.RETIRED
        req.finish_ns = self.clock_ns
        self._materialize_tokens(req, slot)
        kv_slot = self._capture_slot_kv(slot)
        if kv_slot is not None and req.generated:
            # snapshot the post-prefill state: pages + the prompt's first
            # sampled token at pos=len(prompt). Pages beyond the prompt
            # are masked by pos and overwritten as a restored slot decodes.
            self.flusher.stage(req.rid, {
                "kv": kv_slot, "pos": len(req.prompt),
                "first_token": req.generated[0],
                "prompt": tuple(req.prompt)})
        self.finished.append(req)
        self.slots[slot] = None

    def _tok_tick(self, t: int) -> np.ndarray:
        """One tick's [n_slots] sampled tokens on the host, memoized so
        co-retiring slots share a single transfer."""
        arr = self._trace_np.get(t)
        if arr is None:
            arr = self._trace[t].cpu().numpy()
            self._trace_np[t] = arr
        return arr

    def _prune_trace(self) -> None:
        """Drop trace entries no live request can still need."""
        starts = [r._start_tick for r in self.slots if r is not None]
        if not starts:
            self._trace.clear()
            self._trace_np.clear()
            return
        low = min(starts)
        for t in [t for t in self._trace if t < low]:
            self._trace.pop(t, None)
            self._trace_np.pop(t, None)

    def _drop_prompt_alias(self, rid: int, entry, reason: str) -> None:
        """Keep side state in lockstep with store evictions: drop the
        prompt alias and, for true evictions, release the entry's tier
        segments (a ``"replace"`` keeps them: they were just rewritten)."""
        if isinstance(entry, dict):
            prompt = entry.get("prompt")
            if prompt is not None and self._prompt_index.get(prompt) == rid:
                del self._prompt_index[prompt]
        if reason == "evict" and self.tier is not None:
            self.tier.free_entry(rid)

    def _store_sink(self, rid: int, entry) -> None:
        if self.tier is not None:
            # the background drain: page writes ride the deterministic-
            # store path; in async mode the flush is a background op
            nbytes = CxlTier.entry_bytes(entry)
            if self.cxl_async:
                handle = self.tier.write_entry_async(rid, nbytes)
                self._async_writes.append(handle)
                self.stats["tier_write_ns"] += handle.issue_wait_ns
                self.scheduler._note_inflight_peak()
            else:
                self.stats["tier_write_ns"] += self.tier.write_entry(
                    rid, nbytes)
        kept = self.store.put(rid, entry)
        if kept and isinstance(entry, dict) and "prompt" in entry:
            self._prompt_index[entry["prompt"]] = rid

    def _check_done(self, slot: int) -> None:
        req = self.slots[slot]
        if (req._n_gen >= req.max_new_tokens
                or self._pos_host[slot] >= self.max_seq - 1):
            self._retire(slot)

    def step(self) -> None:
        """One engine tick: schedule (activate/preempt/admit), decode,
        retire, background-flush."""
        self.scheduler.begin_tick()
        for slot in range(self.n_slots):
            if self.slots[slot] is not None:
                self._check_done(slot)   # prefill/restore may already satisfy
        active = any(s is not None for s in self.slots)
        if not active and not self.scheduler.busy():
            return
        if not active:
            # all occupied slots are RESTORING: the batch idles this tick
            self.scheduler.note_blocked_tick(self.tier_step_ns)
        else:
            self._advance()
            for slot in range(self.n_slots):
                if self.slots[slot] is not None:
                    self._check_done(slot)
        self._prune_trace()
        # QoS: occupancy = queue pressure; flushes gated by DevLoad
        occ = len(self.flusher.pending) / max(self.n_slots * 2, 1)
        dl = self.qos.classify(occupancy=min(occ, 1.0), service_ratio=1.0)
        self.qos.update(dl)
        self.stats["flushes"] += self.flusher.maybe_flush()
        self._tier_tick()
        self.stats["store_bytes"] = self.store.bytes
        self.stats["store_evictions"] = self.store.evictions

    def _tier_tick(self) -> None:
        """Advance simulated time one engine tick and surface tier +
        scheduler state.

        With a multi-port tier attached this is also the blocking-op
        drain barrier: per-port clocks (which skew freely within a tick)
        realign, while async op handles keep riding the service cursors
        until simulated time reaches their completions. All surfaced
        telemetry is live and cheap — ``tier.port_stats()`` updates its
        per-port dicts in place, so reading it every tick costs no
        allocation churn and no drain."""
        self.clock_ns += self.tier_step_ns
        self.stats["clock_ns"] = self.clock_ns
        self.stats["flush_backlog"] = len(self.flusher.pending)
        ss = self.scheduler.stats
        self.stats["preemptions"] = ss["preemptions"]
        self.stats["swap_out_bytes"] = ss["swap_out_bytes"]
        self.stats["swap_in_bytes"] = ss["swap_in_bytes"]
        self.stats["restore_inflight_ns"] = ss["restore_inflight_ns"]
        infl = ss["restore_inflight_ns"]
        self.stats["restore_overlap_ratio"] = max(
            0.0, 1.0 - ss["restore_exposed_ns"] / infl) if infl > 0 else 0.0
        self.stats["sched_inflight_peak"] = ss["inflight_peak"]
        self.stats["recoveries"] = ss["recoveries"]
        if self.tier is None:
            return
        self.tier.advance(self.tier_step_ns)
        self._fault_sweep()
        if self._async_writes:      # retire completed background flushes
            self._async_writes = [h for h in self._async_writes
                                  if not self.tier.poll(h)]
        self.stats["sim_time_ns"] = self.tier.topo.now
        self.stats["sched_inflight_ops"] = self.tier.inflight_ops()
        self.stats["tier_sr_hit_rate"] = self.tier.sr_hit_rate()
        self.stats["tier_store_occupancy"] = self.tier.store_occupancy()
        self.stats["tier_ports"] = self.tier.port_stats()
        self.stats["flushes_deferred"] = self.flusher.deferred
        tc = self.tier.counters
        self.stats["tier_promotions"] = tc["promotions"]
        self.stats["tier_demotions"] = tc["demotions"]
        self.stats["tier_migrate_ns"] = tc["migrate_ns"]
        self.stats["tier_fault_ops"] = tc["fault_ops"]
        self.stats["tier_lost_entries"] = tc["lost_entries"]
        self.stats["tier_lost_bytes"] = tc["lost_bytes"]
        self.stats["tier_fault_retries"] = sum(
            p.fault_retries for p in self.tier.topo.ports)
        self.stats["tier_fault_failures"] = sum(
            p.fault_failures for p in self.tier.topo.ports)
        self.stats["tier_ports_down"] = len(self.tier.topo.ports_down())
        if "peer_fetches" in tc:        # ShardedTier: cross-rank telemetry
            self.stats["tier_peer_fetches"] = tc["peer_fetches"]
            self.stats["tier_peer_bytes"] = tc["peer_bytes"]
            self.stats["tier_peer_fetch_ns"] = tc["peer_fetch_ns"]
            self.stats["tier_rank_remaps"] = tc["rank_remaps"]
            self.stats["tier_peer_recoveries"] = tc["peer_recoveries"]
            self.stats["tier_rehomes"] = tc["rehomes"]
            self.stats["tier_multi_source_reads"] = tc["multi_source_reads"]

    def _fault_sweep(self) -> None:
        """Fold newly-fired tier faults into serving state.

        ``tier.advance`` already invalidated every entry on a
        hot-removed port; this drains the lost keys and repairs the
        serving side: a lost store entry's host copy is dropped (the
        next lookup misses and prefills fresh — the tier copy it would
        restore from is gone), and a lost swap payload is downgraded to
        a recompute marker (only the token stream survives; resume rides
        the ``preempt_policy="recompute"`` re-prefill path). Runs after
        every simulated-time advance and always before the next tick's
        admissions, so a recovering request can never re-admit against a
        dead copy.
        """
        if self.tier is None:
            return
        for key in self.tier.take_lost_keys():
            if isinstance(key, tuple) and len(key) == 2 \
                    and key[0] == "swap":
                rid = key[1]
                if rid in self.scheduler.swapped:
                    self.scheduler.swapped[rid] = {"recompute": True}
            else:
                self.store.drop(key)

    def advance_time(self, dt_ns: float) -> None:
        """Jump the simulated clock across an idle window (no decode work).

        The open-loop driver calls this when the engine is drained but
        the next arrival is still in the future: the engine clock and the
        tier both see the gap (background flushes complete, QoS ladders
        and GC windows stay live), without charging any decode ticks.
        """
        if dt_ns <= 0:
            return
        self.clock_ns += float(dt_ns)
        self.stats["clock_ns"] = self.clock_ns
        if self.tier is not None:
            self.tier.advance(float(dt_ns))
            self._fault_sweep()
            if self._async_writes:
                self._async_writes = [h for h in self._async_writes
                                      if not self.tier.poll(h)]
            self.stats["sim_time_ns"] = self.tier.topo.now
            self.stats["sched_inflight_ops"] = self.tier.inflight_ops()
        self.stats["flushes"] += self.flusher.maybe_flush()

    def _drain_async(self, guard_ticks: int = 10_000) -> None:
        """Tick simulated time until every outstanding async tier op
        lands: in-flight restores activate (and their slots settle) and
        background flush/swap writes retire their ``TierHandle``s — so
        end-of-run stats (``restore_inflight_ns``, per-port ``inflight``
        depth) are consistent wherever the horizon fell."""
        if self.tier is None:
            return
        ticks = 0
        while (self.scheduler.busy() or self.tier.inflight_ops() > 0) \
                and ticks < guard_ticks:
            self.tier.advance(self.tier_step_ns)
            self.clock_ns += self.tier_step_ns
            self._fault_sweep()
            self.scheduler.drain()
            if self._async_writes:
                self._async_writes = [h for h in self._async_writes
                                      if not self.tier.poll(h)]
            ticks += 1

    def run(self, max_ticks: int = 1000) -> List[Request]:
        """Tick until the queue, slots and in-flight restores drain (or
        ``max_ticks``); returns the finished requests in retirement
        order (the pre-``RequestHandle`` return shape, kept as a shim —
        new callers read their handles instead).

        Whatever the horizon, outstanding async tier ops are drained
        before returning: pending flushes/swap writes complete on the
        simulated clock and in-flight restores land (their requests
        settle into slots; they still need decode ticks to finish)."""
        ticks = 0
        while (self.queue or any(s is not None for s in self.slots)
               or self.scheduler.busy()) and ticks < max_ticks:
            self.step()
            ticks += 1
        self.flusher.maybe_flush()
        self._drain_async()
        self._tier_tick()
        self.stats["store_bytes"] = self.store.bytes
        self.stats["store_evictions"] = self.store.evictions
        return self.finished
