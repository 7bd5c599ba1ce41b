"""Recompute-cost telemetry — the governor's cheap online signals.

The port of ``repro/core/telemetry.py`` (pure Python, unchanged).

The paper's memory/recompute trade-off (§5) is governed offline: a human
picks p/τ per query.  Operating it closed-loop needs an online estimate of
what dropping *costs* each query, without instrumenting the sweep beyond
what it already counts.  Three signal families ride for free:

* **per-query repairs** — the dense engine's ``repair_counts`` rows (host:
  per-slot aggregator-rerun counters): dropped-diff recomputations actually
  paid, the direct marginal cost of that query's drop policy;
* **sweep shape** — ``MaintainStats`` scalars per update batch: iterations
  run (dropped change points extend the upper-bound horizon), scheduled /
  dirty-front sizes (work breadth), repairs;
* **safety** — ``det_overflow`` deltas: DroppedVT records lost to Det-Drop
  evictions, i.e. (v, i) pairs no longer repairable.  A query whose
  escalation coincides with overflow growth is flagged, and the governor
  backs off escalating it further.

Counters arrive cumulative; :class:`RecomputeTelemetry` differences them per
observation and folds the per-update rates into EWMAs, so the governor ranks
queries by *recent* recompute pressure, not lifetime totals.
"""

from __future__ import annotations

import dataclasses

from repro_torch.obs import metrics as obs_metrics


def _ewma(old: float | None, new: float, alpha: float) -> float:
    return new if old is None else (1.0 - alpha) * old + alpha * new


@dataclasses.dataclass
class _QuerySignals:
    cost_total: int = 0  # last cumulative recompute counter seen
    cost_rate: float | None = None  # EWMA of recompute work per update
    nbytes: int = 0  # last per-query accounted bytes seen


class RecomputeTelemetry:
    """EWMA tracker over per-query recompute cost and global sweep signals.

    ``observe`` is called once per enforcement pass with the session's
    cumulative per-query counters and the last ``MaintainStats``-like
    object; ``cost_rate(qid)`` is the governor's ranking signal (recent
    recompute work per ingested update, higher = more expensive to escalate).
    """

    GLOBAL_FIELDS = ("iters_run", "scheduled", "repairs", "det_overflow")

    def __init__(self, alpha: float = 0.5) -> None:
        self.alpha = float(alpha)
        self._per_query: dict[int, _QuerySignals] = {}
        self._updates_seen = 0
        self._global: dict[str, float] = {}
        self._last_stats_id: int | None = None
        self.det_overflow_total = 0
        self.observations = 0

    # ----------------------------------------------------------- ingestion
    def observe(
        self,
        *,
        nbytes_per_query: dict[int, int],
        cost_per_query: dict[int, int],
        stats=None,
        updates_applied: int = 0,
    ) -> None:
        """Fold one enforcement pass's counters into the EWMAs.

        ``cost_per_query`` is cumulative per qid (monotone while a query
        lives); ``updates_applied`` is the session's cumulative ingested
        update count, used to normalize deltas into per-update rates.

        Enforcement passes fire after EVERY session mutation, including
        register/deregister passes that ran no new sweep: an already-seen
        ``stats`` object (identity-tracked) is not re-folded — re-counting
        it would double the per-sweep ``det_overflow`` delta — and the cost
        EWMAs only fold when new updates were actually ingested (otherwise
        a churn-heavy phase would dilute every rate toward zero).
        """
        live = set(nbytes_per_query)
        for qid in list(self._per_query):
            if qid not in live:
                del self._per_query[qid]  # deregistered
        updates_new = updates_applied > self._updates_seen
        d_updates = max(updates_applied - self._updates_seen, 1)
        self._updates_seen = max(self._updates_seen, updates_applied)
        for qid, nbytes in nbytes_per_query.items():
            sig = self._per_query.setdefault(qid, _QuerySignals())
            sig.nbytes = int(nbytes)
            if updates_new:
                cost = int(cost_per_query.get(qid, 0))
                delta = max(cost - sig.cost_total, 0)
                sig.cost_total = cost
                sig.cost_rate = _ewma(
                    sig.cost_rate, delta / d_updates, self.alpha
                )
        if stats is not None and id(stats) != self._last_stats_id:
            self._last_stats_id = id(stats)
            for field in self.GLOBAL_FIELDS:
                val = getattr(stats, field, None)
                if val is None:
                    continue
                self._global[field] = _ewma(
                    self._global.get(field), float(val), self.alpha
                )
            ovf = getattr(stats, "det_overflow", None)
            if ovf is not None:
                self.det_overflow_total += int(ovf)
        self.observations += 1
        self._publish()

    def _publish(self) -> None:
        """Mirror the EWMAs into the obs metrics registry — telemetry is a
        *consumer* of the unified registry, not a parallel surface."""
        reg = obs_metrics.get_registry()
        g = reg.gauge(
            "cqp_telemetry_ewma", "recompute-telemetry EWMAs, by signal"
        )
        for field, val in self._global.items():
            g.set(val, signal=field)
        rate = reg.gauge(
            "cqp_recompute_cost_rate",
            "EWMA recompute work per ingested update, per (query, operator)",
        )
        for key, sig in self._per_query.items():
            if sig.cost_rate is None:
                continue
            if isinstance(key, tuple):
                rate.set(sig.cost_rate, qid=key[0], op=key[1])
            else:
                rate.set(sig.cost_rate, qid=key)
        reg.gauge(
            "cqp_det_overflow_total",
            "DroppedVT records lost to Det-Drop evictions (unrepairable)",
        ).set(self.det_overflow_total)

    # ----------------------------------------------------------------- api
    def cost_rate(self, qid: int) -> float:
        sig = self._per_query.get(qid)
        return 0.0 if sig is None or sig.cost_rate is None else sig.cost_rate

    def global_ewma(self, field: str, default: float = 0.0) -> float:
        """Sweep-shape EWMA (``GLOBAL_FIELDS``) — the planner's cost model
        reads ``iters_run``/``scheduled`` to price recompute strategies."""
        return float(self._global.get(field, default))

    def bytes_held(self, qid: int) -> int:
        sig = self._per_query.get(qid)
        return 0 if sig is None else sig.nbytes

    # ------------------------------------------------------------ durability
    def state_dict(self) -> dict:
        """JSON-able full state (EWMAs as exact float reprs via JSON doubles)."""
        return {
            "alpha": self.alpha,
            "updates_seen": self._updates_seen,
            "global": dict(self._global),
            "det_overflow_total": self.det_overflow_total,
            "observations": self.observations,
            "per_query": [
                {
                    "key": list(k) if isinstance(k, tuple) else k,
                    "cost_total": sig.cost_total,
                    "cost_rate": sig.cost_rate,
                    "nbytes": sig.nbytes,
                }
                for k, sig in self._per_query.items()
            ],
        }

    def load_state(self, state: dict) -> None:
        self.alpha = float(state["alpha"])
        self._updates_seen = int(state["updates_seen"])
        self._global = {k: float(v) for k, v in state["global"].items()}
        self.det_overflow_total = int(state["det_overflow_total"])
        self.observations = int(state["observations"])
        self._per_query = {}
        for entry in state["per_query"]:
            k = entry["key"]
            key = tuple(k) if isinstance(k, list) else k
            self._per_query[key] = _QuerySignals(
                cost_total=int(entry["cost_total"]),
                cost_rate=(
                    None if entry["cost_rate"] is None else float(entry["cost_rate"])
                ),
                nbytes=int(entry["nbytes"]),
            )
        # the stats object identity from the saved process is meaningless
        # here; None means the next observe() folds its stats exactly once —
        # the same thing the uninterrupted run would have done next
        self._last_stats_id = None

    def snapshot(self) -> dict:
        """JSON-friendly view for serving telemetry."""

        def fmt(key) -> str:
            # the governor meters (qid, op_id) keys; legacy callers use qids
            return "/".join(str(p) for p in key) if isinstance(key, tuple) else str(key)

        return {
            "observations": self.observations,
            "det_overflow_total": self.det_overflow_total,
            "global_ewma": {k: round(v, 3) for k, v in self._global.items()},
            "per_query": {
                fmt(qid): {
                    "nbytes": sig.nbytes,
                    "cost_rate": round(sig.cost_rate or 0.0, 3),
                }
                for qid, sig in sorted(self._per_query.items(), key=lambda kv: fmt(kv[0]))
            },
        }
