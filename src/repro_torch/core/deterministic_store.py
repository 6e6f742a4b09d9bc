"""Deterministic store — the host-side staging flusher.

Paper mechanism (Fig. 8): a store to a slow EP completes immediately by
writing concurrently to GPU memory (a reserved, stack-organized staging
region indexed from SRAM) and the EP; under tail latency (GC) the write is
diverted to the staging region only and flushed in the background; reads
consult the staging index first.

Only the serving half is ported: ``StagingFlusher``, copied line for line
from the reference package. The in-graph staging ring and the gradient
specs serve training and come with the training slice.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

from repro_torch.core.qos import QoSController


class StagingFlusher:
    """Drains staged items to the backing tier between steps.

    The sink is a callable (e.g. checkpointer write, host-memory pool
    insert). Flushing is suppressed while DevLoad >= MODERATE, mirroring the
    controller's divert-on-congestion behaviour; suspended writes are kept
    (the ring keeps absorbing) and resumed when load drops — reads remain
    correct throughout because of ``read_through``.

    ``admit`` is the endpoint-side half of the same discipline: when the
    backing tier is a simulated CXL EP (``repro.core.tier.CxlTier``), the
    device pre-announces internal tasks / congestion through it and the
    flush window stays shut until the EP recovers (``deferred`` counts
    those windows); staged items keep absorbing meanwhile.
    """

    def __init__(self, sink: Callable[[int, Any], None],
                 qos: Optional[QoSController] = None,
                 admit: Optional[Callable[[], bool]] = None):
        self.sink = sink
        self.qos = qos or QoSController()
        self.admit = admit
        self.pending: List[Tuple[int, Any]] = []
        self.flushed = 0
        self.suppressed = 0
        self.deferred = 0

    def stage(self, key: int, value: Any) -> None:
        """Park one item for the next admitted flush window."""
        self.pending.append((key, value))

    def maybe_flush(self) -> int:
        """Drain pending items to the sink if QoS + admission allow;
        returns how many items were flushed (0 on a closed window)."""
        if not self.qos.flush_enabled:
            self.suppressed += 1
            return 0
        if self.pending and self.admit is not None and not self.admit():
            self.deferred += 1
            return 0
        n = len(self.pending)
        for key, value in self.pending:
            self.sink(key, value)
        self.pending.clear()
        self.flushed += n
        return n
