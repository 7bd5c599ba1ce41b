"""Multi-tenant open-loop load generator for the CQP serving tier.

The port of ``repro/serving/loadgen.py``.

Open-loop: each tenant's submission times are drawn up front from a seeded
Poisson process (exponential inter-arrivals at ``rate_per_s``) and scheduled
against the wall clock — arrivals do NOT wait for earlier ones to finish, so
an overloaded server sees the offered rate, not its own throughput echoed
back (the closed-loop trap).  Every arrival submits one batch of δE updates
and then issues a read-your-writes read; the generator records per-tenant
read latency, freshness lag, and rejection counts.

``python -m repro_torch.serving.loadgen`` drives a synthetic powerlaw
workload (on the CUDA device; ``--device cpu`` for the plain versions) and
writes the per-tenant JSON under ``reports/serving/``.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import os
import time

import numpy as np

from repro_torch.serving.metrics import summarize_latency_s
from repro_torch.serving.server import CQPServer
from repro_torch.serving.tenants import TenantSpec


@dataclasses.dataclass(frozen=True)
class TenantLoad:
    """One tenant's offered load."""

    spec: TenantSpec
    arrival_rate_per_s: float  # submissions/sec (open-loop)
    updates_per_arrival: int = 8
    arrivals: int = 32

    def __post_init__(self):
        if self.arrival_rate_per_s <= 0:
            raise ValueError("arrival_rate_per_s must be positive")
        if self.updates_per_arrival < 1 or self.arrivals < 1:
            raise ValueError("updates_per_arrival and arrivals must be >= 1")


def tenant_update_streams(
    initial: list,
    num_vertices: int,
    tenants: int,
    *,
    num_batches: int,
    batch_size: int,
    delete_fraction: float = 0.1,
    insert_pool: list | None = None,
    seed: int = 0,
) -> dict[str, list]:
    """Per-tenant δE streams that stay valid under ANY interleaving which
    preserves each tenant's own submission order.

    ``update_stream`` assumes in-order application: its deletions target
    currently-present edges, including edges inserted *earlier in the same
    stream*.  Round-robin-splitting one stream across concurrently
    submitting tenants can therefore reorder a delete ahead of its insert —
    an invalid stream the differential engines make no promises about.
    Here each tenant instead gets a disjoint edge universe: its own slice
    of the initial edges for deletions plus a private, globally-fresh
    insert pool.  No cross-tenant interleaving can then violate the
    insert-absent / delete-present contract.
    """
    rng = np.random.default_rng(seed)
    taken = {(int(e[0]), int(e[1])) for e in initial}
    need = num_batches * batch_size  # upper bound: a stream of all inserts
    if tenants * need > num_vertices * (num_vertices - 1) - len(taken):
        raise ValueError("vertex-pair space too small for disjoint pools")
    pools: list[list] = [[] for _ in range(tenants)]
    for j, e in enumerate(insert_pool or []):
        key = (int(e[0]), int(e[1]))
        if key in taken:
            continue
        taken.add(key)
        pools[j % tenants].append(e)
    short = [i for i in range(tenants) if len(pools[i]) < need]
    while short:
        u, v = (int(x) for x in rng.integers(0, num_vertices, 2))
        if u == v or (u, v) in taken:
            continue
        taken.add((u, v))
        i = short[0]
        pools[i].append((u, v, float(rng.integers(1, 11))))
        if len(pools[i]) >= need:
            short.pop(0)
    from repro_torch.data.graphgen import update_stream

    return {
        f"tenant{i}": update_stream(
            initial[i::tenants],
            num_vertices,
            num_batches=num_batches,
            batch_size=batch_size,
            delete_fraction=delete_fraction,
            insert_pool=pools[i],
            seed=seed + 101 * i + 1,
        )
        for i in range(tenants)
    }


def arrival_schedule(load: TenantLoad, seed: int) -> np.ndarray:
    """Absolute arrival offsets (seconds) for one tenant — exponential
    inter-arrivals, deterministic under the seed."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / load.arrival_rate_per_s, size=load.arrivals)
    return np.cumsum(gaps)


async def _drive_tenant(
    server: CQPServer,
    load: TenantLoad,
    ticket,
    updates: list,
    t_start: float,
    schedule: np.ndarray,
    read_timeout_s: float | None,
) -> dict:
    tid = load.spec.tenant_id
    n = load.updates_per_arrival
    submitted = admitted = rejected = 0
    for i, offset in enumerate(schedule):
        delay = (t_start + float(offset)) - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        batch = updates[(i * n) % max(len(updates), 1) :][:n]
        if not batch:
            break
        res = server.submit(tid, batch)
        submitted += len(batch)
        if res.admitted:
            admitted += len(batch)
        else:
            rejected += len(batch)
        await server.read(ticket, timeout_s=read_timeout_s)
    return {
        "tenant": tid,
        "submitted_updates": submitted,
        "admitted_updates": admitted,
        "rejected_updates": rejected,
        "rejection_rate": rejected / submitted if submitted else 0.0,
    }


async def run_load(
    server: CQPServer,
    loads: list[TenantLoad],
    tickets: dict[str, object],
    updates_by_tenant: dict[str, list],
    *,
    seed: int = 0,
    read_timeout_s: float | None = None,
) -> dict:
    """Run every tenant's open-loop schedule concurrently; returns the
    per-tenant report (generator counters merged with the server's
    latency/freshness meters)."""
    t_start = time.perf_counter()
    results = await asyncio.gather(
        *(
            _drive_tenant(
                server,
                load,
                tickets[load.spec.tenant_id],
                updates_by_tenant[load.spec.tenant_id],
                t_start,
                arrival_schedule(load, seed + 7919 * i),
                read_timeout_s,
            )
            for i, load in enumerate(loads)
        )
    )
    await server.drain()
    wall_s = time.perf_counter() - t_start
    stats = server.stats()
    per_tenant = {}
    for r in results:
        tid = r["tenant"]
        per_tenant[tid] = {
            **r,
            "read_latency": stats["tenants"][tid]["read_latency"],
            "freshness_lag_updates": stats["tenants"][tid][
                "freshness_lag_updates"
            ],
            "stale_reads": stats["tenants"][tid]["stale_reads"],
            "degrade_level": stats["tenants"][tid]["level"],
        }
    return {
        "wall_s": wall_s,
        "offered_updates_per_s": sum(
            ld.arrival_rate_per_s * ld.updates_per_arrival for ld in loads
        ),
        "tenants": per_tenant,
        "admission": stats["admission"],
        "actions": stats["actions"],
        "read_latency": summarize_latency_s(
            server.metrics.samples("read")
        ),
        "epochs": stats["epochs"],
        "covered_updates": stats["covered_updates"],
    }


# ---------------------------------------------------------------------- CLI
def main(argv=None) -> int:
    from repro_torch.core import plan
    from repro_torch.core.governor import GovernorConfig
    from repro_torch.core.graph import DynamicGraph
    from repro_torch.data.graphgen import powerlaw_graph, split_90_10
    from repro_torch.serving.server import (
        ServerConfig,
        SLOConfig,
        build_serving_session,
    )

    ap = argparse.ArgumentParser(
        description="Open-loop multi-tenant CQP load generator"
    )
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--v", type=int, default=256)
    ap.add_argument("--e", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--arrivals", type=int, default=24)
    ap.add_argument("--rate", type=float, default=20.0,
                    help="per-tenant submissions/sec")
    ap.add_argument("--budget-bytes", type=int, default=None,
                    help="per-tenant isolated byte budget")
    ap.add_argument("--quota-rate", type=float, default=None,
                    help="per-tenant admitted-updates/sec token-bucket rate")
    ap.add_argument("--engine", default="dense", choices=["dense", "host"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--max-iters", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-admission", action="store_true")
    ap.add_argument("--out", default=os.path.join("reports", "serving"),
                    help="output directory for the JSON report")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    if args.smoke:
        args.v, args.e = min(args.v, 64), min(args.e, 256)
        args.arrivals = min(args.arrivals, 8)
        args.max_iters = min(args.max_iters, 16)

    edges = powerlaw_graph(args.v, args.e, seed=args.seed)
    initial, pool = split_90_10(edges, seed=args.seed)
    streams = tenant_update_streams(
        initial, args.v, args.tenants,
        num_batches=args.arrivals, batch_size=args.batch,
        insert_pool=pool, delete_fraction=0.1, seed=args.seed + 1,
    )
    updates_by_tenant = {
        tid: [u for b in batches for u in b]
        for tid, batches in streams.items()
    }

    ladder = GovernorConfig(representation="prob")
    session = build_serving_session(
        DynamicGraph(args.v, initial, capacity=len(edges) * 4 + 64),
        ladder=ladder,
        engine=args.engine,
        batch_capacity=args.batch,
        min_slots=args.tenants,
        device=args.device,
    )
    server = CQPServer(
        session,
        config=ServerConfig(
            chunk_updates=args.batch,
            admission=not args.no_admission,
            slo=SLOConfig(backlog_high_updates=8 * args.batch),
            drop_ladder=ladder,
        ),
    )

    async def run() -> dict:
        async with server:
            loads, tickets = [], {}
            for i in range(args.tenants):
                tid = f"tenant{i}"
                spec = TenantSpec(
                    tenant_id=tid,
                    priority=i + 1,
                    budget_bytes=args.budget_bytes,
                    rate_per_s=args.quota_rate,
                )
                server.add_tenant(spec)
                tickets[tid] = await server.register_query(
                    tid, plan.sssp(i % args.v, max_iters=args.max_iters)
                )
                loads.append(
                    TenantLoad(
                        spec=spec,
                        arrival_rate_per_s=args.rate,
                        updates_per_arrival=args.batch,
                        arrivals=args.arrivals,
                    )
                )
            return await run_load(
                server, loads, tickets, updates_by_tenant, seed=args.seed
            )

    report = asyncio.run(run())
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "loadgen.json")
    with open(path, "w") as fh:
        json.dump(report, fh, indent=2, default=str)
    print("loadgen JSON:", json.dumps({
        "wall_s": round(report["wall_s"], 3),
        "epochs": report["epochs"],
        "covered_updates": report["covered_updates"],
        "rejection_rates": {
            t: round(r["rejection_rate"], 4)
            for t, r in report["tenants"].items()
        },
        "read_p99_ms": report["read_latency"]["p99_ms"],
    }))
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
