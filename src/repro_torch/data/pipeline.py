"""Deterministic token pipeline with background prefetch.

Design constraints from the runtime:
  * determinism: batch t is a pure function of (seed, step) -- a restart
    replays the exact stream from the checkpointed step. The numpy stream
    is the reference's (``repro/data/pipeline.py``) line for line, so batch
    t equals the reference's bit for bit;
  * prefetch: a background thread keeps ``depth`` batches ahead, so host
    input never sits on the step's critical path (the data-loading face of
    the paper's speculative read);
  * placement: each batch crosses to the explicit ``device`` from pinned
    host memory with a non-blocking copy (plain tensors on the CPU);
  * sharding: on a rank mesh each rank takes its rows of the global batch
    (``rows=(r, R)``: the contiguous r-th 1/R of the leading axis), as the
    reference's ``batch_specs`` places them over the data axis (or pod and
    data); the global stream is the same whatever the mesh.

Sources: ``SyntheticLM`` (seeded zipfian tokens -- the default for the
smoke runs and tests) or a binary int32 token file (``FileLM``, np.memmap).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    n_codebooks: int = 0          # audio family
    vision_tokens: int = 0        # vlm family (stub embeddings)
    d_model: int = 0
    token_file: Optional[str] = None


class SyntheticLM:
    """Seeded zipf-ish token stream; batch t is a pure function of t."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks ** 1.1
        self._cdf = np.cumsum(probs / probs.sum())

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 20) ^ step)
        shape = (cfg.global_batch, cfg.seq_len + 1)
        if cfg.n_codebooks:
            shape = (cfg.global_batch, cfg.n_codebooks, cfg.seq_len + 1)
        u = rng.random(shape)
        toks = np.searchsorted(self._cdf, u).astype(np.int32)
        out = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
        if cfg.vision_tokens:
            out["vision_embeds"] = rng.standard_normal(
                (cfg.global_batch, cfg.vision_tokens, cfg.d_model)
            ).astype(np.float32) * 0.02
        return out


class FileLM:
    """Contiguous windows over a binary int32 token file (np.memmap)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.tokens = np.memmap(cfg.token_file, dtype=np.int32, mode="r")

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        span = cfg.seq_len + 1
        n_windows = len(self.tokens) // span
        rng = np.random.default_rng((cfg.seed << 20) ^ step)
        idx = rng.integers(0, n_windows, cfg.global_batch)
        rows = np.stack([self.tokens[i * span:(i + 1) * span] for i in idx])
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def rows_of(batch: Dict, rank: int, n: int) -> Dict:
    """Rank ``rank``'s rows of a global ``batch`` split over ``n`` ranks:
    the contiguous ``rank``-th 1/n of every leaf's leading axis."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"{k}: {v.shape[0]} rows do not split over "
                             f"{n} ranks")
        per = v.shape[0] // n
        out[k] = v[rank * per:(rank + 1) * per]
    return out


def to_device(batch: Dict[str, np.ndarray],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``: through pinned host memory
    and non-blocking copies to a card, plain tensors on the CPU."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class Pipeline:
    """Background-prefetching iterator over a deterministic source; its
    batches (this rank's ``rows`` of them) land on ``device`` (the card
    unless the caller asks for the CPU)."""

    def __init__(self, cfg: DataConfig, *, start_step: int = 0,
                 depth: int = 2, device="cuda", rows=(0, 1)):
        self.device = resolve_device(device)
        self.rows = rows
        self.cfg = cfg
        self.source = FileLM(cfg) if cfg.token_file else SyntheticLM(cfg)
        self.step = start_step
        self.depth = depth
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = rows_of(self.source.batch(step), *self.rows)
            try:
                self._q.put((step, batch), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __next__(self):
        step, batch = self._q.get()
        self.step = step + 1
        return step, to_device(batch, self.device)

    def __iter__(self) -> Iterator:
        return self

    def state(self) -> Dict:
        """Checkpointable position (next step to be consumed)."""
        return {"step": self.step}

    def close(self):
        self._stop.set()
