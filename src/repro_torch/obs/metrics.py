"""Typed metrics registry: Counter / Gauge / Histogram.

The port of ``repro/obs/metrics.py`` (pure Python, unchanged).

One process-wide registry (module-level default, swappable for tests)
replaces the parallel ad-hoc surfaces that grew across the repo —
``core/telemetry.py`` EWMAs, ``serving/metrics.py`` percentile blobs,
per-script JSON dicts.  Those stay as *consumers*: they publish into the
registry, and ``session.stats()`` / ``server.stats()`` read back through
it, so every exporter (JSON snapshot, Prometheus text, trace counters)
sees one coherent set of series.

Conventions:

- Metric names are ``snake_case`` with a unit suffix (``_bytes``, ``_s``,
  ``_total`` for counters), Prometheus-style.
- Labels are an optional ``dict[str, str|int]``; each distinct label set is
  its own child series.  Label cardinality is the caller's problem — the
  DC probes keep it bounded (qid × operator, ladder rung, shard).
- Histograms use fixed bucket boundaries chosen at registration;
  observations are O(#buckets) with no per-sample allocation.

Thread-safety: mutations take the registry lock (serving records from
executor threads); reads snapshot under the same lock.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Any, Iterable

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "set_registry",
]

LabelValue = Any  # coerced to str for export
Labels = tuple[tuple[str, str], ...]


def _labels_key(labels: dict[str, LabelValue] | None) -> Labels:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """Shared child-series bookkeeping for the three metric types."""

    kind = "untyped"

    def __init__(self, name: str, help: str, registry: "MetricsRegistry"):
        self.name = name
        self.help = help
        self._registry = registry
        self._children: dict[Labels, Any] = {}

    def _child(self, labels: dict[str, LabelValue] | None) -> Any:
        key = _labels_key(labels)
        child = self._children.get(key)
        if child is None:
            child = self._new_child()
            self._children[key] = child
        return child

    def _new_child(self) -> Any:  # pragma: no cover - overridden
        raise NotImplementedError

    def series(self) -> Iterable[tuple[Labels, Any]]:
        return list(self._children.items())


class Counter(_Metric):
    """Monotonically increasing count (resets only with the registry)."""

    kind = "counter"

    def _new_child(self) -> list[float]:
        return [0.0]

    def inc(self, amount: float = 1.0, **labels: LabelValue) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment {amount}")
        with self._registry._lock:
            self._child(labels)[0] += amount

    def value(self, **labels: LabelValue) -> float:
        with self._registry._lock:
            return self._children.get(_labels_key(labels), [0.0])[0]


class Gauge(_Metric):
    """Point-in-time value, settable up or down."""

    kind = "gauge"

    def _new_child(self) -> list[float]:
        return [0.0]

    def set(self, value: float, **labels: LabelValue) -> None:
        with self._registry._lock:
            self._child(labels)[0] = float(value)

    def inc(self, amount: float = 1.0, **labels: LabelValue) -> None:
        with self._registry._lock:
            self._child(labels)[0] += amount

    def value(self, **labels: LabelValue) -> float:
        with self._registry._lock:
            return self._children.get(_labels_key(labels), [0.0])[0]


DEFAULT_BUCKETS = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class _HistChild:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, nbuckets: int) -> None:
        self.counts = [0] * (nbuckets + 1)  # +1 = +Inf bucket
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    """Fixed-bucket histogram (cumulative on export, Prometheus-style)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        registry: "MetricsRegistry",
        buckets: tuple[float, ...] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help, registry)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def _new_child(self) -> _HistChild:
        return _HistChild(len(self.buckets))

    def observe(self, value: float, **labels: LabelValue) -> None:
        value = float(value)
        with self._registry._lock:
            child = self._child(labels)
            child.counts[bisect_left(self.buckets, value)] += 1
            child.sum += value
            child.count += 1

    def snapshot(self, **labels: LabelValue) -> dict[str, Any]:
        with self._registry._lock:
            child = self._children.get(_labels_key(labels))
            if child is None:
                return {"count": 0, "sum": 0.0, "buckets": {}}
            cum, out = 0, {}
            for b, c in zip(self.buckets, child.counts):
                cum += c
                out[b] = cum
            return {"count": child.count, "sum": child.sum, "buckets": out}


class MetricsRegistry:
    """Name → metric map with typed registration and two export formats."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._metrics: dict[str, _Metric] = {}

    # ------------------------------------------------------------- register
    def _register(self, cls: type, name: str, help: str, **kw: Any) -> Any:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls:
                    raise ValueError(
                        f"metric {name!r} already registered as {existing.kind}"
                    )
                return existing
            metric = cls(name, help, self, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "", buckets: tuple[float, ...] = DEFAULT_BUCKETS
    ) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    # --------------------------------------------------------------- export
    def snapshot(self) -> dict[str, Any]:
        """JSON-safe snapshot: {name: {type, help, series: [...]}}."""
        out: dict[str, Any] = {}
        with self._lock:
            for name, m in sorted(self._metrics.items()):
                series = []
                for labels, child in m.series():
                    entry: dict[str, Any] = {"labels": dict(labels)}
                    if isinstance(m, Histogram):
                        cum, buckets = 0, {}
                        for b, c in zip(m.buckets, child.counts):
                            cum += c
                            buckets[repr(b)] = cum
                        entry.update(
                            count=child.count, sum=child.sum, buckets=buckets
                        )
                    else:
                        entry["value"] = child[0]
                    series.append(entry)
                out[name] = {"type": m.kind, "help": m.help, "series": series}
        return out

    def prometheus_text(self) -> str:
        """Prometheus/OpenMetrics text exposition (format 0.0.4)."""
        lines: list[str] = []
        with self._lock:
            for name, m in sorted(self._metrics.items()):
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                lines.append(f"# TYPE {name} {m.kind}")
                for labels, child in m.series():
                    lbl = _fmt_labels(labels)
                    if isinstance(m, Histogram):
                        cum = 0
                        for b, c in zip(m.buckets, child.counts):
                            cum += c
                            lines.append(
                                f"{name}_bucket{_fmt_labels(labels, le=repr(b))} {cum}"
                            )
                        lines.append(
                            f"{name}_bucket{_fmt_labels(labels, le='+Inf')} "
                            f"{child.count}"
                        )
                        lines.append(f"{name}_sum{lbl} {child.sum}")
                        lines.append(f"{name}_count{lbl} {child.count}")
                    else:
                        val = _fmt_value(child[0])
                        lines.append(f"{name}_total{lbl} {val}"
                                     if m.kind == "counter" and not name.endswith("_total")
                                     else f"{name}{lbl} {val}")
        return "\n".join(lines) + "\n"

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


def _fmt_value(v: float) -> str:
    """Integral floats render as ints (``3`` not ``3.0``) — counters and
    byte gauges read cleanly in the text exposition."""
    return str(int(v)) if float(v).is_integer() else repr(float(v))


def _fmt_labels(labels: Labels, **extra: str) -> str:
    pairs = [*labels, *sorted(extra.items())]
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in pairs)
    return "{" + body + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


# ------------------------------------------------------------------- default
_default = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default


def set_registry(registry: MetricsRegistry | None) -> MetricsRegistry:
    """Swap the process default (None → fresh empty registry); returns it."""
    global _default
    _default = registry if registry is not None else MetricsRegistry()
    return _default
