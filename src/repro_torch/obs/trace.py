"""Low-overhead span/event tracer with Chrome-trace (Perfetto) JSON export.

Design constraints, in order:

1. **Zero cost when off.**  The disabled path allocates nothing: ``span()``
   returns a module-level singleton whose ``__enter__``/``__exit__`` are
   empty, and ``instant``/``counter_event`` return before touching the
   clock.  The only per-call overhead is one attribute load and one branch.
2. **Bounded memory when on.**  Events land in a ``collections.deque`` with
   ``maxlen`` (drop-oldest).  A long-running server with tracing enabled
   holds at most ``capacity`` events; ``dropped_events`` counts the loss so
   an exported trace is honest about truncation.
3. **Monotonic time.**  ``time.perf_counter_ns`` for both timestamps and
   durations — wall-clock steps (NTP) never tear a span.

Span taxonomy (``cat`` in the exported trace; see DESIGN.md §15):

- ``update_batch``   — one host-level δE ingestion (``apply_updates[_batched]``)
- ``sweep``          — one maintenance sweep dispatch (stats in ``args``)
- ``kernel_dispatch``— one jitted chunk step inside a batched ingestion
- ``repair``         — repair-on-access work (reassembly / scratch fallback)
- ``governor``       — shed / ladder-escalation actions
- ``checkpoint``     — checkpoint write / restore
- ``admission``      — serving-tier admission decisions (instant events)

Attribution rides in ``args`` (engine / shard / tenant / query / operator)
plus the Chrome-trace ``pid``/``tid`` fields: ``pid`` is the process-level
group (engine name), ``tid`` the within-group lane (e.g. shard or qid), so
Perfetto renders one track per lane.

The exported file is the Chrome Trace Event Format JSON object form::

    {"traceEvents": [...], "displayTimeUnit": "ms"}

with ``ph: "X"`` complete events (``ts``/``dur`` in microseconds),
``ph: "i"`` instants, and ``ph: "C"`` counter samples — loadable directly
in https://ui.perfetto.dev or ``chrome://tracing``.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any

__all__ = [
    "Tracer",
    "NULL_SPAN",
    "get_tracer",
    "set_tracer",
    "span",
    "instant",
    "counter_event",
]

DEFAULT_CAPACITY = 65536


class _NullSpan:
    """Singleton no-op context manager: the disabled-tracer fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: object) -> None:
        return None

    def set(self, **kwargs: Any) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class _Span:
    """A live complete-event ('X') span.  Created only when tracing is on."""

    __slots__ = ("_tracer", "name", "cat", "pid", "tid", "args", "_t0")

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        cat: str,
        pid: str,
        tid: str | int,
        args: dict[str, Any] | None,
    ) -> None:
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.pid = pid
        self.tid = tid
        self.args = args
        self._t0 = 0

    def set(self, **kwargs: Any) -> "_Span":
        """Attach attribution after the fact (e.g. sweep stats on exit)."""
        if self.args is None:
            self.args = kwargs
        else:
            self.args.update(kwargs)
        return self

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc: object) -> None:
        t1 = time.perf_counter_ns()
        self._tracer._emit(
            {
                "name": self.name,
                "cat": self.cat,
                "ph": "X",
                "ts": (self._t0 - self._tracer._epoch_ns) / 1e3,
                "dur": (t1 - self._t0) / 1e3,
                "pid": self.pid,
                "tid": self.tid,
                "args": self.args or {},
            }
        )


class Tracer:
    """Bounded-buffer span/event recorder.

    Thread-safe: the serving tier records from executor threads; deque
    appends are atomic under the GIL but export snapshots take the lock so
    a concurrent flush never sees a torn buffer.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY, enabled: bool = True):
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self._buf: deque[dict[str, Any]] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._epoch_ns = time.perf_counter_ns()
        self.emitted_events = 0

    # ---------------------------------------------------------------- record
    def _emit(self, ev: dict[str, Any]) -> None:
        self.emitted_events += 1
        self._buf.append(ev)

    def span(
        self,
        name: str,
        cat: str = "",
        *,
        pid: str = "repro",
        tid: str | int = 0,
        **args: Any,
    ) -> _Span | _NullSpan:
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, cat, pid, tid, args or None)

    def instant(
        self,
        name: str,
        cat: str = "",
        *,
        pid: str = "repro",
        tid: str | int = 0,
        **args: Any,
    ) -> None:
        if not self.enabled:
            return
        self._emit(
            {
                "name": name,
                "cat": cat,
                "ph": "i",
                "s": "t",  # thread-scoped instant
                "ts": (time.perf_counter_ns() - self._epoch_ns) / 1e3,
                "pid": pid,
                "tid": tid,
                "args": args,
            }
        )

    def counter(
        self,
        name: str,
        values: dict[str, float],
        *,
        pid: str = "repro",
        tid: str | int = 0,
    ) -> None:
        """Chrome-trace 'C' sample: Perfetto renders a stacked counter track."""
        if not self.enabled:
            return
        self._emit(
            {
                "name": name,
                "ph": "C",
                "ts": (time.perf_counter_ns() - self._epoch_ns) / 1e3,
                "pid": pid,
                "tid": tid,
                "args": values,
            }
        )

    # ---------------------------------------------------------------- export
    @property
    def dropped_events(self) -> int:
        return self.emitted_events - len(self._buf)

    def events(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def chrome_trace(self) -> dict[str, Any]:
        """The Chrome Trace Event Format JSON-object form."""
        return {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {
                "emitted_events": self.emitted_events,
                "dropped_events": self.dropped_events,
            },
        }

    def export(self, path: str) -> int:
        """Write the Chrome-trace JSON to ``path``; returns the event count."""
        trace = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return len(trace["traceEvents"])


# ------------------------------------------------------------------- default
# Module-level default (logging-style).  Starts DISABLED so importing the
# engine costs nothing; drivers opt in with set_tracer(Tracer()).
_default = Tracer(capacity=0, enabled=False)


def get_tracer() -> Tracer:
    return _default


def set_tracer(tracer: Tracer | None) -> Tracer:
    """Install ``tracer`` as the process default (None → disabled no-op).

    Returns the installed tracer so drivers can one-line it::

        tr = obs.set_tracer(obs.Tracer())
    """
    global _default
    _default = tracer if tracer is not None else Tracer(capacity=0, enabled=False)
    return _default


def span(name: str, cat: str = "", **kw: Any) -> _Span | _NullSpan:
    """``with obs.span("sweep", "sweep", qid=3): ...`` against the default."""
    t = _default
    if not t.enabled:
        return NULL_SPAN
    return t.span(name, cat, **kw)


def instant(name: str, cat: str = "", **kw: Any) -> None:
    t = _default
    if t.enabled:
        t.instant(name, cat, **kw)


def counter_event(name: str, values: dict[str, float], **kw: Any) -> None:
    t = _default
    if t.enabled:
        t.counter(name, values, **kw)


def validate_chrome_trace(trace: dict[str, Any]) -> list[str]:
    """Structural validation of a Chrome-trace object; returns problem list.

    Used by the CI smoke (and tests) instead of an external JSON-schema
    dependency: checks the object form, required per-event fields, phase
    codes, and numeric timestamps.
    """
    problems: list[str] = []
    if not isinstance(trace, dict):
        return ["top level is not a JSON object"]
    evs = trace.get("traceEvents")
    if not isinstance(evs, list):
        return ["missing or non-list traceEvents"]
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "B", "E", "i", "I", "C", "M"):
            problems.append(f"event {i}: bad ph {ph!r}")
        if not isinstance(ev.get("name"), str):
            problems.append(f"event {i}: missing name")
        if ph != "M" and not isinstance(ev.get("ts"), (int, float)):
            problems.append(f"event {i}: missing ts")
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            problems.append(f"event {i}: complete event missing dur")
        if "pid" not in ev or "tid" not in ev:
            problems.append(f"event {i}: missing pid/tid")
    return problems
