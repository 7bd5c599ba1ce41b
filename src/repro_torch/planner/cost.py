"""Cost model: when does a rewrite pay?

The port of ``repro/planner/cost.py`` (pure Python, unchanged but for the
package it imports).

Signals, in order of preference:

* **per-operator byte accounting** — the session's live
  ``_nbytes_per_query_map`` gives the actual marginal bytes of one more
  differentially-maintained query row (the landmark index costs 2·L such
  rows: L forward fields on G plus L reverse fields on Gᵀ);
* **RecomputeTelemetry EWMAs** — ``iters_run``/``scheduled`` price the
  scratch recompute a rewrite would add (or remove), per ingested update;
* **static plan shape** — ``max_iters``·V bounds the scratch sweep when no
  telemetry has accumulated yet (cold session).

The model is deliberately coarse: rewrite decisions are reversible (the
governor can shed a landmark index it regrets), so the gate only needs to
be directionally right, and every estimate is logged on the planner's
decision trail for inspection.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """One gate decision with the numbers behind it (JSON-able)."""

    pays: bool
    reason: str
    sharers: int = 0  # queries that would share the rewrite's state
    index_rows: int = 0  # diff-maintained rows the shared state costs
    bytes_per_row: float = 0.0  # marginal bytes of one maintained row
    scratch_rate: float = 0.0  # EWMA scratch work per update (pruned away)

    def to_dict(self) -> dict:
        return {
            "pays": self.pays,
            "reason": self.reason,
            "sharers": self.sharers,
            "index_rows": self.index_rows,
            "bytes_per_row": round(self.bytes_per_row, 1),
            "scratch_rate": round(self.scratch_rate, 3),
        }


class CostModel:
    """Decides when a rewrite pays (``optimize="auto"``).

    ``margin`` scales the break-even point: a landmark index on a
    diff-maintaining engine must expect at least ``margin × 2L`` sharing
    queries before its rows cost less than the rows it replaces.
    """

    def __init__(self, *, margin: float = 1.0):
        self.margin = float(margin)

    # ------------------------------------------------------------- signals
    def _telemetry(self, session):
        gov = getattr(session, "_governor", None)
        return None if gov is None else gov.telemetry

    def bytes_per_row(self, session) -> float:
        """Marginal bytes of one maintained query row: the mean over live
        rows' accounted bytes (0.0 when nothing is live yet)."""
        per = session._nbytes_per_query_map()
        vals = [b for b in per.values() if b > 0]
        return float(sum(vals)) / len(vals) if vals else 0.0

    def scratch_rate(self, session) -> float:
        """EWMA scratch work per ingested update: scheduled vertex slots per
        sweep × iterations (falls back to 0.0 on a cold session)."""
        tele = self._telemetry(session)
        if tele is None:
            return 0.0
        return tele.global_ewma("scheduled") * max(
            tele.global_ewma("iters_run"), 1.0
        )

    # ---------------------------------------------------------------- gates
    def landmark(self, plan, session, *, num_landmarks: int, sharers: int) -> CostEstimate:
        """Gate for the landmark hub-cut (paper §6.6).

        * SCRATCH sessions re-run every query per batch — the index prunes
          that work directly (Fig. 9's 43–83% cut), so the rewrite pays for
          any number of sharers.
        * Diff-maintaining engines (dense/host) trade bytes: the rewrite
          replaces ``sharers`` maintained rows with ``2L`` index rows plus
          per-batch pruned-scratch recompute.  It pays once enough queries
          share the index: ``sharers ≥ margin × 2L`` (byte break-even, with
          live per-row byte accounting and the scratch-rate EWMA logged for
          the decision trail).
        """
        index_rows = 2 * int(num_landmarks)
        rate = self.scratch_rate(session)
        if session.engine_kind == "scratch":
            return CostEstimate(
                pays=True,
                reason="scratch engine: pruning cuts per-batch recompute",
                sharers=sharers,
                index_rows=index_rows,
                scratch_rate=rate,
            )
        bpr = self.bytes_per_row(session)
        need = self.margin * index_rows
        if sharers >= need:
            return CostEstimate(
                pays=True,
                reason=f"{sharers} sharers amortize {index_rows} index rows",
                sharers=sharers,
                index_rows=index_rows,
                bytes_per_row=bpr,
                scratch_rate=rate,
            )
        return CostEstimate(
            pays=False,
            reason=(
                f"{sharers} sharers < break-even {need:g} "
                f"(2L rows would cost more than they free)"
            ),
            sharers=sharers,
            index_rows=index_rows,
            bytes_per_row=bpr,
            scratch_rate=rate,
        )
