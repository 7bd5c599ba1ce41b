"""DC-specific observability probes.

The port of ``repro/obs/probes.py``.  The probes that read the dense
engine's state reduce it on the device and move one ``[Q]`` result to the
host (the Bloom fill per row, the Det records per row).

The gauges no generic APM gives you — they read the engine's differential-
computation state directly:

* per-operator diff-store occupancy (accounted bytes) and dropped-diff
  record counts,
* Bloom fill ratio + estimated false-positive rate — the direct predictor
  of wasted repair work for the paper's probabilistic DroppedVT: a Bloom
  false positive makes the sweep "repair" a vertex that never dropped,
* per-sweep iteration series (frontier/scheduled sizes, from
  ``MaintainStats``),
* governor ladder-level timeline,
* checkpoint/restore byte + latency accounting (published by
  ``runtime.recovery``).

``publish_session_metrics`` pushes the full set into a
:class:`~repro_torch.obs.metrics.MetricsRegistry`; it is the single scrape
surface ``CQPSession.stats()``, ``CQPServer`` and ``cqp_serve
--metrics-out`` share.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import bloom as bloom_lib
from repro_torch.obs.metrics import Counter, MetricsRegistry, get_registry

__all__ = [
    "maintain_stats_dict",
    "bloom_fp_rate",
    "bloom_stats",
    "dropped_diff_counts",
    "publish_session_metrics",
]


def maintain_stats_dict(stats: Any) -> dict:
    """JSON-safe dict view of a ``MaintainStats`` (any engine's).

    Scalar counters become ints; the per-iteration probe vectors become
    lists trimmed to the iterations actually run (bounded by the trace
    depth), so ``session.stats()["last_maintain"]`` reads directly as a
    size-per-iteration series.
    """
    out: dict[str, Any] = {}
    n = None
    for k, v in zip(stats._fields, stats):
        if getattr(v, "ndim", 0):
            if n is None:
                n = min(max(int(out.get("iters_run", 0)), 0), len(np.asarray(v)))
            out[k] = [int(x) for x in np.asarray(v)[:n]]
        else:
            out[k] = int(v)
    return out


def bloom_fp_rate(fill: float, num_hashes: int) -> float:
    """Analytic false-positive rate from the observed fill fraction.

    A membership query probes ``k = num_hashes`` bits; with fraction ``f``
    of the filter set, a never-inserted key passes all probes with
    probability ≈ ``f^k`` (the standard Bloom estimate, using the observed
    fill rather than the insert count — exact under independent probes).
    """
    f = min(max(float(fill), 0.0), 1.0)
    return f ** int(num_hashes)


def _dense_impl(session) -> Any | None:
    """The dense engine's ``DiffIFE`` behind a session, or None."""
    impl = getattr(session, "_impl", None)
    inner = getattr(impl, "impl", None)
    return inner if inner is not None and hasattr(inner, "states") else None


def bloom_stats(session) -> dict[int, dict]:
    """qid → Bloom filter health for sessions on the probabilistic
    DroppedVT representation: fill fraction, analytic FP rate, bit/hash
    geometry.  Empty for det-mode, host and scratch engines."""
    eng = _dense_impl(session)
    if eng is None:
        return {}
    flt = eng.states[0].drop.flt  # replicated on every shard
    if flt is None:
        return {}
    fill = np.atleast_1d(bloom_lib.fill_fraction(flt).cpu().numpy())
    out: dict[int, dict] = {}
    for qid, slot in getattr(session, "_handles", {}).items():
        if slot >= fill.shape[0]:
            continue
        f = float(fill[slot])
        out[qid] = {
            "fill_fraction": f,
            "fp_rate": bloom_fp_rate(f, flt.num_hashes),
            "num_bits": int(flt.num_bits),
            "num_hashes": int(flt.num_hashes),
        }
    return out


def dropped_diff_counts(session) -> dict[int, int]:
    """qid → DroppedVT records currently held in the Det-Drop store (the
    countable representation).  Bloom-mode sessions have no record count —
    their loss signal is :func:`bloom_stats`' FP rate."""
    eng = _dense_impl(session)
    if eng is None:
        return {}
    if eng.states[0].drop.det is None:
        return {}
    # [Q], summed over the shards' vertex blocks
    counts = sum(st.drop.det.count.sum(dim=1, dtype=torch.int64).cpu() for st in eng.states).numpy()
    out: dict[int, int] = {}
    for qid, slot in getattr(session, "_handles", {}).items():
        if slot < counts.shape[0]:
            out[qid] = int(counts[slot])
    return out


def _counter_to(c: Counter, value: float, **labels) -> None:
    """Advance a monotone counter to an absolute value (idempotent scrape)."""
    cur = c.value(**labels)
    if value > cur:
        c.inc(value - cur, **labels)


def publish_session_metrics(
    session, registry: MetricsRegistry | None = None
) -> MetricsRegistry:
    """Scrape one session into the registry; returns the registry.

    Safe to call at any cadence: counters advance monotonically (absolute
    session counters → deltas), gauges overwrite.  This is the bridge that
    makes ``stats()``'s JSON view and the Prometheus exposition read the
    same numbers.
    """
    reg = registry if registry is not None else get_registry()

    # ----- session lifetime counters / point-in-time gauges
    _counter_to(
        reg.counter("cqp_updates_applied_total", "δE updates ingested"),
        session.updates_applied,
    )
    _counter_to(
        reg.counter("cqp_queries_registered_total", "query registrations"),
        session.registered_total,
    )
    _counter_to(
        reg.counter("cqp_queries_deregistered_total", "query deregistrations"),
        session.deregistered_total,
    )
    _counter_to(
        reg.counter("cqp_bytes_freed_total", "bytes released by deregister"),
        session.bytes_freed_total,
    )
    _counter_to(
        reg.counter("cqp_bytes_shed_total", "bytes released by policy sheds"),
        session.bytes_shed_total,
    )
    reg.gauge("cqp_active_queries", "registered queries").set(
        session.num_queries
    )
    reg.gauge(
        "cqp_nbytes", "accounted difference bytes (paper's memory metric)"
    ).set(session.nbytes())

    # ----- per-operator diff-store occupancy (the governor's victim table)
    occ = reg.gauge(
        "cqp_diffstore_bytes", "accounted bytes per (query, operator) store"
    )
    for (qid, op), nbytes in session._nbytes_per_op_map().items():
        occ.set(nbytes, qid=qid, op=op)

    # ----- last sweep (uniform MaintainStats schema across engines)
    ls = session.last_stats
    if ls is not None and hasattr(ls, "_fields"):
        g = reg.gauge(
            "cqp_last_sweep", "last maintenance sweep counters, by field"
        )
        for k, v in zip(ls._fields, ls):
            if not getattr(v, "ndim", 0):
                g.set(int(v), field=k)

    # ----- DroppedVT health
    dropped = dropped_diff_counts(session)
    if dropped:
        g = reg.gauge(
            "cqp_droppedvt_records", "Det-Drop store records per query"
        )
        for qid, n in dropped.items():
            g.set(n, qid=qid)
    bl = bloom_stats(session)
    if bl:
        gf = reg.gauge("cqp_bloom_fill_ratio", "Bloom filter fill fraction")
        gp = reg.gauge(
            "cqp_bloom_fp_rate",
            "estimated Bloom false-positive rate (wasted-repair predictor)",
        )
        for qid, b in bl.items():
            gf.set(b["fill_fraction"], qid=qid)
            gp.set(b["fp_rate"], qid=qid)

    # ----- plan optimizer: rewrites + shared-index health
    planner = getattr(session, "_planner", None)
    if planner is not None:
        snap = planner.snapshot()
        _counter_to(
            reg.counter("cqp_planner_rewrites_total", "plans rewritten"),
            snap["rewrites_total"],
        )
        reg.gauge(
            "cqp_planner_managed_queries", "queries answering through rewrites"
        ).set(len(snap["managed_queries"]))
        lmk = snap.get("landmark")
        if lmk:
            reg.gauge(
                "cqp_landmark_index_nbytes",
                "landmark index bytes held outside engine qids (Gᵀ twin)",
            ).set(lmk["index_nbytes"])
            reg.gauge(
                "cqp_landmark_index_live",
                "1 while the shared landmark index is materialized",
            ).set(1 if lmk["live"] else 0)
            _counter_to(
                reg.counter(
                    "cqp_landmark_sheds_total", "governor index sheds"
                ),
                lmk["sheds_total"],
            )
            _counter_to(
                reg.counter(
                    "cqp_landmark_remats_total", "index re-materializations"
                ),
                lmk["remats_total"],
            )
            _counter_to(
                reg.counter(
                    "cqp_landmark_pruned_work_total",
                    "cumulative live-vertex slots swept by pruned scratch",
                ),
                lmk["pruned_work_total"],
            )

    # ----- governor ladder timeline
    gov = getattr(session, "governor", None)
    if gov is not None:
        lvl = reg.gauge(
            "cqp_governor_level", "policy-ladder rung per (query, operator)"
        )
        for (qid, op), level in gov.op_levels.items():
            lvl.set(level, qid=qid, op=op)
        reg.gauge("cqp_governor_budget_bytes", "memory budget").set(
            gov.budget_bytes
        )
        try:
            reg.gauge(
                "cqp_governor_headroom_bytes", "budget minus accounted bytes"
            ).set(gov.headroom(session))
        except Exception:
            pass
    return reg
