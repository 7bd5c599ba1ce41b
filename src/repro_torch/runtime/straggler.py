"""Straggler detection and mitigation hooks.

The port of ``repro/runtime/straggler.py``.  The detector keeps a per-step
wall-time EWMA; a step slower than ``threshold × EWMA`` (after ``warmup``
steps) raises a straggler event, to which registered policies react (the
serving tier escalates its degradation ladder once per event).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration_s: float
    ewma_s: float


class StragglerDetector:
    def __init__(self, threshold: float = 2.0, alpha: float = 0.1, warmup: int = 3):
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = warmup
        self.ewma: float | None = None
        self.seen = 0
        self.events: list[StragglerEvent] = []
        self.policies: list[Callable[[StragglerEvent], None]] = []

    def on_straggler(self, policy: Callable[[StragglerEvent], None]) -> None:
        self.policies.append(policy)

    def observe(self, step: int, duration_s: float) -> bool:
        """Record one step; returns True if it was flagged as a straggler."""
        self.seen += 1
        if self.ewma is None:
            self.ewma = duration_s
            return False
        flagged = (
            self.seen > self.warmup and duration_s > self.threshold * self.ewma
        )
        if flagged:
            ev = StragglerEvent(step, duration_s, self.ewma)
            self.events.append(ev)
            for p in self.policies:
                p(ev)
        else:
            # stragglers don't poison the baseline
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * duration_s
        return flagged


class StepTimer:
    def __init__(self, detector: StragglerDetector):
        self.detector = detector
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def finish(self, step: int) -> bool:
        return self.detector.observe(step, time.perf_counter() - self._t0)

    def __exit__(self, *exc):
        return False
