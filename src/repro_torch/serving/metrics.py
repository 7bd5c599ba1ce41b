"""Shared serving metrics: percentile summaries and per-phase breakdowns.

The port of ``repro/serving/metrics.py``.

Every serving surface in the repo reports the same latency shape — p50/p99
(and now p999) percentiles over a sample list, plus a per-phase breakdown of
where a serving loop spent its time (ingest / maintain / checkpoint / …).
Before this module the percentile math and JSON assembly lived duplicated in
``launch/cqp_serve.py``; both that CLI and the async serving tier
(:mod:`repro_torch.serving.server`) now report through here, so the two emit
field-compatible JSON.
"""

from __future__ import annotations

import numpy as np

from repro_torch.obs import metrics as obs_metrics

# the serving tier's canonical percentile set
PERCENTILES: tuple[float, ...] = (50.0, 99.0, 99.9)


def summarize_samples(
    samples, *, scale: float = 1.0, suffix: str = ""
) -> dict:
    """Percentile summary of a sample list.

    Returns ``{count, p50, p99, p999, mean, max}`` (keys carry ``suffix``;
    values are multiplied by ``scale``).  An empty sample list yields a
    zeroed summary rather than NaNs, so reports stay JSON-clean when a
    phase never ran.
    """
    arr = np.asarray(list(samples), dtype=np.float64)
    if arr.size == 0:
        vals = {"p50": 0.0, "p99": 0.0, "p999": 0.0, "mean": 0.0, "max": 0.0}
    else:
        p50, p99, p999 = (float(np.percentile(arr, q)) for q in PERCENTILES)
        vals = {
            "p50": p50,
            "p99": p99,
            "p999": p999,
            "mean": float(arr.mean()),
            "max": float(arr.max()),
        }
    out = {"count": int(arr.size)}
    out.update({k + suffix: v * scale for k, v in vals.items()})
    return out


def summarize_latency_s(samples_s) -> dict:
    """Latency summary of samples in seconds, reported in milliseconds:
    ``{count, p50_ms, p99_ms, p999_ms, mean_ms, max_ms}``."""
    return summarize_samples(samples_s, scale=1e3, suffix="_ms")


class PhaseRecorder:
    """Per-phase latency samples for one serving loop.

    Phases are free-form strings (the serving loops use ``ingest`` / ``maintain``
    / ``checkpoint`` / ``register`` / ``deregister`` / ``read``); each
    :meth:`record` appends one wall-time sample.  :meth:`summary` renders
    the per-phase percentile breakdown plus each phase's total seconds —
    the JSON block both serving front ends attach as ``"phases"``.
    """

    def __init__(self) -> None:
        self._samples: dict[str, list[float]] = {}
        # the recorder is an obs-registry consumer: every sample also lands
        # in one shared histogram (labelled by phase), so the Prometheus /
        # JSON-snapshot surfaces see the same distribution this summary
        # renders as percentiles
        self._hist = obs_metrics.get_registry().histogram(
            "serving_phase_seconds", "serving-loop phase wall time"
        )

    def record(self, phase: str, seconds: float) -> None:
        self._samples.setdefault(phase, []).append(float(seconds))
        self._hist.observe(float(seconds), phase=phase)

    def extend(self, phase: str, seconds_list) -> None:
        seconds_list = [float(s) for s in seconds_list]
        self._samples.setdefault(phase, []).extend(seconds_list)
        for s in seconds_list:
            self._hist.observe(s, phase=phase)

    def samples(self, phase: str) -> list[float]:
        return list(self._samples.get(phase, ()))

    def total_s(self, phase: str) -> float:
        return float(sum(self._samples.get(phase, ())))

    def summary(self) -> dict:
        return {
            phase: {
                **summarize_latency_s(samples),
                "total_s": float(sum(samples)),
            }
            for phase, samples in sorted(self._samples.items())
        }
