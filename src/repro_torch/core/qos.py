"""QoS telemetry — the DevLoad state machine and address-window control.

The CXL flit's DevLoad field (2 bits) classifies endpoint load into four
states; the paper's queue logic uses it to modulate speculative-read
granularity/volume and to gate deterministic-store flushes. This module is
shared by (a) the discrete-event simulator (cycle-level fidelity) and (b)
the JAX runtime, where the controller observes per-step telemetry and picks
among pre-compiled step variants between steps (XLA programs are static, so
adaptation is inter-step — DESIGN.md §4.4).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence, Tuple


class DevLoad(enum.IntEnum):
    """Two-bit endpoint load state, CXL r3.1 QoS telemetry."""

    LIGHT = 0      # "ll" — spare bandwidth: raise SR granularity
    OPTIMAL = 1    # "ol" — at capacity: hold
    MODERATE = 2   # "mo" — congested: lower granularity, pause DS flushes
    SEVERE = 3     # "so" — saturated: halt SR until LIGHT returns


# SR request granularity ladder (bytes) — MemSpecRd aggregates 1..4 memory
# requests via the 2 repurposed LSBs: 256B base unit up to 1KB.
SR_GRANULARITIES = (256, 512, 768, 1024)


@dataclasses.dataclass
class QoSController:
    """Maps DevLoad telemetry to SR/DS control decisions.

    Used verbatim by the simulator; the training/serving runtime feeds it
    synthesized telemetry (queue occupancy = staging-ring fill, service
    latency = step-time EWMA vs roofline expectation).
    """

    granularity: int = 512            # current MemSpecRd bytes
    sr_halted: bool = False
    flush_enabled: bool = True
    # runtime-mode knobs (layer-level analogues)
    prefetch_depth: int = 1
    max_prefetch_depth: int = 2

    ewma: float = 0.0
    ewma_alpha: float = 0.25
    _last: DevLoad = DevLoad.OPTIMAL

    # ------------------------------------------------------------ classify
    def classify(self, occupancy: float, service_ratio: float) -> DevLoad:
        """occupancy: queue/ring fill in [0,1]; service_ratio: observed
        latency / expected latency (>=1 means slower than roofline)."""
        self.ewma = (1 - self.ewma_alpha) * self.ewma \
            + self.ewma_alpha * max(occupancy, (service_ratio - 1.0))
        if occupancy >= 0.95:
            return DevLoad.SEVERE
        if self.ewma > 0.60:
            return DevLoad.MODERATE
        if self.ewma > 0.25:
            return DevLoad.OPTIMAL
        return DevLoad.LIGHT

    # -------------------------------------------------------------- update
    def update(self, devload: DevLoad) -> None:
        """Paper's control actions (OPTIMIZATION section)."""
        self._last = devload
        if devload == DevLoad.LIGHT:
            self.sr_halted = False
            self.flush_enabled = True
            self._step_granularity(+1)
            self.prefetch_depth = min(self.prefetch_depth + 1,
                                      self.max_prefetch_depth)
        elif devload == DevLoad.OPTIMAL:
            self.flush_enabled = True
        elif devload == DevLoad.MODERATE:
            self._step_granularity(-1)
            self.flush_enabled = False   # divert writes to staging (Fig. 8)
            self.prefetch_depth = max(self.prefetch_depth - 1, 1)
        else:  # SEVERE
            self.sr_halted = True
            self.flush_enabled = False
            self.granularity = SR_GRANULARITIES[0]
            self.prefetch_depth = 0

    def _step_granularity(self, d: int) -> None:
        i = SR_GRANULARITIES.index(self.granularity)
        self.granularity = SR_GRANULARITIES[
            max(0, min(len(SR_GRANULARITIES) - 1, i + d))]

    @property
    def sr_enabled(self) -> bool:
        """True while the SR engine may issue MemSpecRd (not halted)."""
        return not self.sr_halted

    @property
    def last_devload(self) -> DevLoad:
        """Most recent DevLoad sample observed (telemetry read-back)."""
        return self._last


# ---------------------------------------------------------------------------
# Address-window control (paper Fig. 7)
# ---------------------------------------------------------------------------

MEM_REQ_BYTES = 64       # CXL.mem request granularity
SR_OFFSET_UNIT = 256     # MemSpecRd offset unit


def address_window(addr: int, granularity: int,
                   memory_queue: Sequence[int],
                   sr_queue: Sequence[int]) -> Tuple[int, int]:
    """Compute the SR address window for a request at ``addr``.

    Initial window = [addr - g, addr + g). Each *past* request (memory
    queue) shifts the start up by 64B — history that already covered low
    addresses; each *future* request (SR queue) shifts the end down by 64B —
    demand that SR requests will cover anyway. The result is rounded to the
    256B offset unit. Returns (start, end) with end-start == granularity.
    """
    start = addr - granularity
    end = addr + granularity
    start += MEM_REQ_BYTES * len(memory_queue)
    end -= MEM_REQ_BYTES * len(sr_queue)
    start = max(start, 0)
    end = max(end, start + SR_OFFSET_UNIT)
    # window length is capped at the current granularity
    if end - start > granularity:
        # keep the side the queues weighted toward the access point
        if addr - start > end - addr:
            start = end - granularity
        else:
            end = start + granularity
    # finalize: round the shifted range to the 256B offset unit (window
    # length stays within the MemSpecRd granularity, itself a multiple of
    # the offset unit)
    start = (max(start, 0) // SR_OFFSET_UNIT) * SR_OFFSET_UNIT
    length = ((end - start + SR_OFFSET_UNIT - 1)
              // SR_OFFSET_UNIT) * SR_OFFSET_UNIT
    g_cap = max((granularity // SR_OFFSET_UNIT) * SR_OFFSET_UNIT,
                SR_OFFSET_UNIT)
    return start, start + max(min(length, g_cap), SR_OFFSET_UNIT)


# ---------------------------------------------------------------------------
# Runtime telemetry record (training/serving loops)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StepTelemetry:
    """One training/serving step's observed load (wall times in seconds;
    ``staging_occupancy`` is the DS ring fill fraction in [0, 1])."""

    step: int
    wall_time_s: float
    expected_time_s: float      # roofline expectation for the variant
    staging_occupancy: float    # DS ring fill fraction
    devload: Optional[DevLoad] = None


class RuntimeQoS:
    """Between-step adaptation loop: telemetry -> DevLoad -> variant choice.

    The train/serve drivers pre-compile step variants for (prefetch_depth,
    granularity) combinations; this picks the active one (DESIGN.md §4.4).
    """

    def __init__(self, variants: Sequence[Tuple[int, int]]):
        self.ctl = QoSController()
        self.variants = list(variants)  # [(depth, granularity), ...]
        self.history: List[StepTelemetry] = []

    def observe(self, t: StepTelemetry) -> Tuple[int, int]:
        """Fold one step's telemetry into the ladder; returns the
        (prefetch_depth, granularity) variant to run next."""
        ratio = (t.wall_time_s / t.expected_time_s
                 if t.expected_time_s > 0 else 1.0)
        dl = self.ctl.classify(t.staging_occupancy, ratio)
        t.devload = dl
        self.ctl.update(dl)
        self.history.append(t)
        return self.active_variant()

    def active_variant(self) -> Tuple[int, int]:
        """Pre-compiled (depth, granularity) variant closest to the
        controller's current prefetch depth."""
        depth = 0 if self.ctl.sr_halted else self.ctl.prefetch_depth
        best = min(self.variants,
                   key=lambda v: (abs(v[0] - depth),))
        return best
