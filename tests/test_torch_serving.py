"""Port parity: the async multi-tenant serving tier and ``cqp_serve``.

Every case of the reference's ``tests/test_serving.py`` and
``tests/test_serving_runtime.py`` whose result does not hang on wall-clock
pacing runs on both packages (``repro.serving`` and ``repro_torch.serving``,
the port's sessions with ``device="cpu"``) and the two must agree: reads,
action logs, faults, answers.  Every server here runs on an injected clock
whose time advances only in the ``delay_injector`` (a wall-clock spike on a
loaded machine would otherwise raise a straggler event, and a degradation,
in one package's run alone); the paced cases (stragglers, the 2× overload)
charge their delays to it, and the overload's chunk folds are released by
the test, so none can flake as its reference can.  Then the scripted server scenario and
``cqp_serve.serve`` of both packages on the same arguments, with and
without a fault, and one subprocess run of the port's CLI.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import subprocess
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import repro.launch.cqp_serve as r_cli
import repro.serving.server as r_server
import repro_torch.launch.cqp_serve as t_cli
import repro_torch.serving.server as t_server
from repro.core import plan as rplan
from repro.core.governor import GovernorConfig as RGov
from repro.core.graph import DynamicGraph as RGraph
from repro.core.session import CQPSession as RSession
from repro.runtime.fault import InjectedFault as RFault
from repro.serving import admission as r_adm
from repro.serving import loadgen as r_loadgen
from repro.serving.tenants import TenantSpec as RTenant
from repro_torch.core import plan as tplan
from repro_torch.core.governor import GovernorConfig as TGov
from repro_torch.core.graph import DynamicGraph as TGraph
from repro_torch.core.session import CQPSession as TSession
from repro_torch.data.graphgen import powerlaw_graph, split_90_10
from repro_torch.runtime.fault import InjectedFault as TFault
from repro_torch.serving import admission as t_adm
from repro_torch.serving import loadgen as t_loadgen
from repro_torch.serving.tenants import TenantSpec as TTenant

V, E, BATCH, MAX_ITERS = 64, 256, 8, 16
CPU = "cpu"

PKGS = {
    "ref": SimpleNamespace(
        plan=rplan, Gov=RGov, Graph=RGraph, Session=RSession, Fault=RFault, server=r_server,
        adm=r_adm, Tenant=RTenant, kw={},
    ),
    "port": SimpleNamespace(
        plan=tplan, Gov=TGov, Graph=TGraph, Session=TSession, Fault=TFault, server=t_server,
        adm=t_adm, Tenant=TTenant, kw={"device": CPU},
    ),
}


def _workload(tenants: int = 2, num_batches: int = 6, seed: int = 0):
    edges = powerlaw_graph(V, E, seed=seed)
    initial, pool = split_90_10(edges, seed=seed)
    streams = t_loadgen.tenant_update_streams(
        initial, V, tenants, num_batches=num_batches, batch_size=BATCH,
        delete_fraction=0.1, insert_pool=pool, seed=seed + 1,
    )
    return initial, streams


def _session(pk, initial, engine="host", **kw):
    graph = pk.Graph(V, initial, capacity=len(initial) * 8 + 1024)
    return pk.server.build_serving_session(graph, ladder=pk.Gov(representation="prob"), engine=engine,
                                           **{**pk.kw, **kw})


class VirtualClock:
    """The servers' clock: time moves only when a chunk fold is charged its
    injected delay (no sleeping), so every latency the loop sees is exact."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def injector(self, seconds, gate: threading.Semaphore | None = None):
        def inject(k: int) -> float:
            if gate is not None:
                gate.acquire()  # the test releases each fold
            self.t += seconds(k)
            return 0.0

        return inject


def _server(pk, initial, *, engine="host", config=None, clock=None, **kw):
    """A server on an injected clock (a fresh ``VirtualClock`` unless one is
    given): no wall-clock spike can raise a straggler event and walk the
    ladder in one package's run and not the other's."""
    ladder = pk.Gov(representation="prob")
    return pk.server.CQPServer(
        _session(pk, initial, engine),
        config=config or pk.server.ServerConfig(chunk_updates=BATCH, drop_ladder=ladder),
        clock=clock or VirtualClock(),
        **kw,
    )


def _config(pk, **kw):
    slo = kw.pop("slo", {})
    return pk.server.ServerConfig(chunk_updates=BATCH, drop_ladder=pk.Gov(representation="prob"),
                                  slo=pk.adm.SLOConfig(**slo), **kw)


def _oracle_answers(initial, plans, applied):
    oracle = TSession(TGraph(V, initial, capacity=len(initial) * 8 + 1024), engine="scratch", device=CPU)
    handles = [oracle.register(p) for p in plans]
    if applied:
        oracle.apply_updates_batched(applied)
    return [oracle.answers(h) for h in handles]


def _both(fn):
    """Run ``fn(pk)`` for the reference and the port; returns both results."""
    return fn(PKGS["ref"]), fn(PKGS["port"])


def test_tenant_update_streams_match_the_reference():
    initial, pool = split_90_10(powerlaw_graph(V, E, seed=4), seed=4)
    kw = dict(num_batches=5, batch_size=BATCH, delete_fraction=0.1, insert_pool=pool, seed=5)
    assert (t_loadgen.tenant_update_streams(initial, V, 3, **kw)
            == r_loadgen.tenant_update_streams(initial, V, 3, **kw))


# ------------------------------------------------------------------ reads
def test_read_your_writes_and_epoch_snapshot_consistency():
    """Every read is fresh and equals a scratch replay of exactly its
    covered prefix; the port's reads equal the reference's."""
    initial, streams = _workload()
    order = sorted(streams)

    def run(pk):
        plans = [pk.plan.sssp(0, max_iters=MAX_ITERS), pk.plan.sssp(7, max_iters=MAX_ITERS)]

        async def main():
            server = _server(pk, initial)
            reads = []
            async with server:
                tickets = {}
                for i, tid in enumerate(order):
                    server.add_tenant(pk.Tenant(tenant_id=tid, priority=i + 1))
                    tickets[tid] = await server.register_query(tid, plans[i])
                for round_batches in zip(*(streams[t] for t in order)):
                    for tid, batch in zip(order, round_batches):
                        res = server.submit(tid, batch)
                        assert res.admitted
                        r = await server.read(tickets[tid], timeout_s=30.0)
                        assert r.fresh and r.covered >= res.watermark
                        reads.append((tid, r.covered, np.array(r.values)))
                await server.drain()
                chunks = [list(c) for c in server._chunk_log]
            return reads, chunks

        return asyncio.run(main())

    (r_reads, r_chunks), (t_reads, t_chunks) = _both(run)
    assert t_chunks == r_chunks
    assert [(t, c) for t, c, _ in t_reads] == [(t, c) for t, c, _ in r_reads]
    for (_, _, a), (_, _, b) in zip(t_reads, r_reads):
        np.testing.assert_array_equal(a, b)
    plans = [tplan.sssp(0, max_iters=MAX_ITERS), tplan.sssp(7, max_iters=MAX_ITERS)]
    flat = [u for c in t_chunks for u in c]
    for tid, covered, values in t_reads:
        want = _oracle_answers(initial, plans, flat[:covered])[order.index(tid)]
        np.testing.assert_array_equal(values, want)


# ---------------------------------------------------------------- admission
def test_rate_quota_rejects_and_recovers():
    """A tenant's token bucket rejects beyond its quota; the co-tenant is
    untouched; rejected submissions do not advance the watermark."""
    initial, streams = _workload()

    def run(pk):
        async def main():
            server = _server(pk, initial)
            async with server:
                server.add_tenant(pk.Tenant(tenant_id="limited", rate_per_s=1.0, burst=BATCH))
                server.add_tenant(pk.Tenant(tenant_id="free"))
                t_lim = await server.register_query("limited", pk.plan.sssp(0, max_iters=MAX_ITERS))
                await server.register_query("free", pk.plan.sssp(1, max_iters=MAX_ITERS))
                batches = streams["tenant0"]
                subs = [server.submit("limited", batches[0]), server.submit("limited", batches[1]),
                        server.submit("free", batches[2])]
                await server.drain()
                r = await server.read(t_lim, timeout_s=30.0)
                stats = server.stats()
            return [(s.admitted, s.reason, s.watermark) for s in subs], r.fresh, stats["tenants"]

        return asyncio.run(main())

    ref, port = _both(run)
    subs, fresh, tenants = port
    assert subs[0][0] and not subs[1][0] and subs[1][1] == "rate quota" and subs[2][0]
    assert subs[1][2] == subs[0][2] and fresh
    assert tenants["limited"]["rejected_updates"] == BATCH and tenants["free"]["rejected_updates"] == 0
    assert (subs, fresh) == ref[:2]
    for tid in tenants:
        for k in ("submitted_updates", "admitted_updates", "rejected_updates", "watermark", "level", "nbytes"):
            assert tenants[tid][k] == ref[2][tid][k], (tid, k)


def test_overload_degrades_every_rung_before_first_shed_rejection():
    """An overloaded tier degrades one rung per epoch until every tenant is
    at the top rung, and only then rejects: the full ladder (low priority
    first) precedes the first 'overload shed', in both packages."""
    initial, streams = _workload()

    def run(pk):
        cfg = _config(pk, slo=dict(backlog_high_updates=0, cooldown_epochs=10**6))
        ladder = pk.Gov(representation="prob")

        async def main():
            server = _server(pk, initial, config=cfg)
            async with server:
                for i, tid in enumerate(sorted(streams)):
                    server.add_tenant(pk.Tenant(tenant_id=tid, priority=i + 1))
                    await server.register_query(tid, pk.plan.sssp(i, max_iters=MAX_ITERS))
                rejected, k = [], 0
                all_batches = [b for t in sorted(streams) for b in streams[t]]
                while not rejected and k < 500:
                    for _ in range(4):
                        res = server.submit("tenant0", all_batches[k % len(all_batches)])
                        if not res.admitted:
                            rejected.append(res.reason)
                        k += 1
                    await asyncio.sleep(0.001)
                await server.drain()
                stats = server.stats()
            return rejected, stats["actions"], ladder.top_level

        return asyncio.run(main())

    for rejected, actions, top in _both(run):
        assert rejected and rejected[0] == "overload shed"
        degrades = [a for a in actions if a["kind"] == "degrade"]
        assert len(degrades) == 2 * top
        assert not any(a["kind"] == "restore" for a in actions)
        first_t1 = next(i for i, a in enumerate(degrades) if a["tenant"] == "tenant1")
        assert all(a["tenant"] == "tenant0" for a in degrades[:first_t1])
    (_, r_actions, _), (_, t_actions, _) = _both(run)
    assert ([(a["tenant"], a["level_from"], a["level_to"]) for a in t_actions]
            == [(a["tenant"], a["level_from"], a["level_to"]) for a in r_actions])


def test_register_rejected_while_shedding_raises():
    initial, _ = _workload()

    def run(pk):
        async def main():
            server = _server(pk, initial)
            async with server:
                server.add_tenant(pk.Tenant(tenant_id="t"))
                server.admission.shedding = True
                with pytest.raises(pk.adm.AdmissionRejected):
                    await server.register_query("t", pk.plan.sssp(0, max_iters=MAX_ITERS))
                server.admission.shedding = False
                ticket = await server.register_query("t", pk.plan.sssp(0, max_iters=MAX_ITERS))
                r = await server.read(ticket, timeout_s=30.0)
            return r.fresh, np.array(r.values)

        return asyncio.run(main())

    (r_fresh, r_vals), (t_fresh, t_vals) = _both(run)
    assert r_fresh and t_fresh
    np.testing.assert_array_equal(t_vals, r_vals)


def test_admission_reject_is_not_a_runtime_error():
    """The serving loop recovers from RuntimeErrors; a policy rejection must
    never look like one."""
    assert not issubclass(t_adm.AdmissionRejected, RuntimeError)


# ------------------------------------------------------------------ budgets
def test_tenant_budget_isolation():
    """A tenant over its own byte budget walks down the ladder; the
    co-tenant stays at level 0; the action logs are the reference's."""
    initial, streams = _workload(num_batches=8)

    def run(pk):
        cfg = _config(pk, slo=dict(backlog_high_updates=10**9, cooldown_epochs=10**9))

        async def main():
            server = _server(pk, initial, config=cfg)
            async with server:
                server.add_tenant(pk.Tenant(tenant_id="tenant0", budget_bytes=64))
                server.add_tenant(pk.Tenant(tenant_id="tenant1"))
                for tid in sorted(streams):
                    await server.register_query(tid, pk.plan.sssp(0 if tid == "tenant0" else 1,
                                                                   max_iters=MAX_ITERS))
                for b0, b1 in zip(streams["tenant0"], streams["tenant1"]):
                    server.submit("tenant0", b0)
                    server.submit("tenant1", b1)
                await server.drain()
                return server.stats()

        return asyncio.run(main())

    ref, port = _both(run)
    assert port["tenants"]["tenant0"]["level"] > 0 and port["tenants"]["tenant1"]["level"] == 0
    budget = [a for a in port["actions"] if a["reason"] == "tenant budget"]
    assert budget and all(a["tenant"] == "tenant0" for a in budget)
    assert port["actions"] == ref["actions"]


# ------------------------------------------------------------- paced cases
def test_overload_admission_keeps_reads_fresh_and_exact():
    """The reference's overload case on an injected clock: the test offers
    three batches a round and releases the folds of 1 or 2 chunks (2×
    overload).  With admission the tier degrades, then sheds, and every
    read of the last quarter is fresh and every final answer exact; the
    control run admits everything and its late reads go stale.  Both
    packages take the same decisions at the same epochs."""
    rounds = 40
    initial, streams = _workload(tenants=3, num_batches=rounds)
    order = sorted(streams)

    def run(pk, admission: bool):
        cfg = _config(pk, admission=admission, read_timeout_s=0.15,
                      slo=dict(backlog_high_updates=BATCH, cooldown_epochs=10**6))
        clock, gate = VirtualClock(), threading.Semaphore(0)

        async def main():
            server = _server(pk, initial, config=cfg, clock=clock,
                             delay_injector=clock.injector(lambda k: 0.01, gate))
            plans, round_reads, released, admitted = {}, [], 0, 0
            async with server:
                tickets = {}
                for i, tid in enumerate(order):
                    server.add_tenant(pk.Tenant(tenant_id=tid, priority=i + 1))
                    plans[tid] = pk.plan.sssp(i * 11, max_iters=MAX_ITERS)
                    tickets[tid] = await server.register_query(tid, plans[tid])
                for rnd, round_batches in enumerate(zip(*(streams[t] for t in order))):
                    for tid, batch in zip(order, round_batches):
                        admitted += server.submit(tid, batch).admitted
                    n = 1 + rnd % 2
                    gate.release(n)
                    released += n
                    while len(server._chunk_log) < min(released, admitted):
                        await asyncio.sleep(0)
                    for tid in order:
                        r = await server.read(tickets[tid], timeout_s=1e-3)
                        round_reads.append((rnd, tid, r.fresh))
                stats = server.stats()
                gate.release(10**6)
                await server.drain()
                final = {tid: await server.read(t, timeout_s=30.0) for tid, t in tickets.items()}
                applied = server.applied_updates()
            return round_reads, stats, final, applied, plans

        return asyncio.run(main())

    results = {}
    for name, pk in PKGS.items():
        results[name] = (run(pk, True), run(pk, False))
    (reads, stats, final, applied, plans), (c_reads, c_stats, *_rest) = results["port"]
    assert stats["admission"]["rejected_updates"] > 0
    steady = [f for rnd, _t, f in reads if rnd >= 3 * rounds // 4]
    assert steady and all(steady)
    oracle = _oracle_answers(initial, [plans[t] for t in order], applied)
    for tid, want in zip(order, oracle):
        assert final[tid].fresh
        np.testing.assert_array_equal(final[tid].values, want)
    assert c_stats["admission"]["rejected_updates"] == 0
    assert not all(f for rnd, _t, f in c_reads if rnd >= 3 * rounds // 4)
    for (p_run, r_run) in zip(results["port"], results["ref"]):
        assert p_run[0] == r_run[0]  # every round's freshness
        assert p_run[1]["actions"] == r_run[1]["actions"]
        assert p_run[1]["admission"] == r_run[1]["admission"]
        assert p_run[3] == r_run[3]  # the applied log
        for tid in order:
            np.testing.assert_array_equal(p_run[2][tid].values, r_run[2][tid].values)


def test_straggler_shedding_fires_exactly_once_per_event():
    """One slow chunk in a steady stream gives exactly one straggler event,
    one force-shed and one ladder action, in both packages."""
    initial, streams = _workload(tenants=1, num_batches=10, seed=3)
    spike_at = 6

    def run(pk):
        cfg = _config(pk, slo=dict(backlog_high_updates=10**9, cooldown_epochs=10**9),
                      straggler_threshold=4.0, straggler_warmup=3)
        clock = VirtualClock()

        async def main():
            server = _server(pk, initial, config=cfg, clock=clock,
                             delay_injector=clock.injector(lambda k: 0.1 if k == spike_at else 0.01))
            async with server:
                server.add_tenant(pk.Tenant(tenant_id="t"))
                ticket = await server.register_query("t", pk.plan.sssp(0, max_iters=MAX_ITERS))
                for batch in streams["tenant0"]:
                    server.submit("t", batch)
                    await server.drain()
                r = await server.read(ticket, timeout_s=30.0)
                return r.fresh, server.stats()

        return asyncio.run(main())

    ref, port = _both(run)
    fresh, stats = port
    assert fresh and stats["straggler_events"] == 1
    assert stats["admission"]["straggler_sheds"] == 1
    assert [a["reason"] for a in stats["actions"]] == [f"straggler@{spike_at}"]
    assert stats["actions"][0]["kind"] == "degrade"
    assert stats["actions"] == ref[1]["actions"]
    assert stats["session"]["runtime"]["straggler"] == ref[1]["session"]["runtime"]["straggler"]


def test_straggler_detection_disabled_without_spike():
    initial, streams = _workload(tenants=1, num_batches=8, seed=3)

    def run(pk):
        clock = VirtualClock()

        async def main():
            server = _server(pk, initial, config=_config(pk, slo=dict(backlog_high_updates=10**9)),
                             clock=clock, delay_injector=clock.injector(lambda k: 0.005))
            async with server:
                server.add_tenant(pk.Tenant(tenant_id="t"))
                await server.register_query("t", pk.plan.sssp(0, max_iters=MAX_ITERS))
                for batch in streams["tenant0"]:
                    server.submit("t", batch)
                    await server.drain()
                return server.stats()

        return asyncio.run(main())

    for stats in _both(run):
        assert stats["straggler_events"] == 0 and stats["admission"]["straggler_sheds"] == 0


# ----------------------------------------------------------------- recovery
@pytest.mark.parametrize("engine", ["host", "dense"])
@pytest.mark.parametrize("checkpoint", [False, True], ids=["genesis", "checkpoint"])
def test_fault_recovery_preserves_tenants(engine, checkpoint, tmp_path):
    """A mid-stream fault restores the latest checkpoint (or rebuilds from
    genesis when there is none), replays, and keeps every ticket live: the
    port's reads equal the reference's (host engine, uninterrupted) and a
    scratch replay of the applied log; faults, restores and replayed chunks
    are the reference's on the same drill."""
    initial, streams = _workload()
    fault_at = 3 if checkpoint else 2

    def run(pk, engine, with_fault, d):
        plans = {"tenant0": pk.plan.sssp(0, max_iters=MAX_ITERS), "tenant1": pk.plan.sssp(3, max_iters=MAX_ITERS)}
        fired = {"done": False}

        def injector(k):
            if with_fault and k == fault_at and not fired["done"]:
                fired["done"] = True
                raise pk.Fault(f"scripted fault at chunk {k}")

        async def main():
            server = pk.server.CQPServer(
                _session(pk, initial, engine),
                config=_config(pk, checkpoint_every=2 if checkpoint else 0),
                session_factory=lambda: _session(pk, initial, engine),
                checkpoint_dir=str(d) if checkpoint else None,
                fault_injector=injector,
                clock=VirtualClock(),
            )
            async with server:
                tickets = {}
                for tid in sorted(streams):
                    server.add_tenant(pk.Tenant(tenant_id=tid))
                    tickets[tid] = await server.register_query(tid, plans[tid])
                for round_batches in zip(*(streams[t] for t in sorted(streams))):
                    for tid, batch in zip(sorted(streams), round_batches):
                        server.submit(tid, batch)
                await server.drain()
                reads = {tid: await server.read(t, timeout_s=30.0) for tid, t in tickets.items()}
                return reads, server.stats(), server.applied_updates()

        return asyncio.run(main())

    port, p_stats, applied = run(PKGS["port"], engine, True, tmp_path / "port")
    ref, r_stats, r_applied = run(PKGS["ref"], "host", True, tmp_path / "ref")
    clean, _, _ = run(PKGS["ref"], "host", False, tmp_path / "clean")
    assert p_stats["faults"] == r_stats["faults"] == 1 and applied == r_applied
    oracle = _oracle_answers(initial, [tplan.sssp(0, max_iters=MAX_ITERS), tplan.sssp(3, max_iters=MAX_ITERS)],
                             applied)
    for tid, want in zip(sorted(port), oracle):
        assert port[tid].fresh
        np.testing.assert_array_equal(port[tid].values, ref[tid].values)
        np.testing.assert_array_equal(port[tid].values, clean[tid].values)
        np.testing.assert_array_equal(port[tid].values, want)
    if checkpoint:
        pm, rm = p_stats["recovery"], r_stats["recovery"]
        assert pm["history"] == rm["history"] and pm["replayed_chunks"] == rm["replayed_chunks"]
        assert len(pm["restores"]) == 1


def test_restart_exhaustion_surfaces_the_fault():
    """A fault that survives every genesis rebuild exhausts max_restarts
    and surfaces; the loop is dead afterwards (restarts + 1 faults)."""
    initial, streams = _workload(tenants=1, num_batches=2, seed=3)

    def run(pk):
        def always_fail(k):
            raise pk.Fault("unrecoverable scripted fault")

        async def main():
            server = pk.server.CQPServer(
                _session(pk, initial), config=_config(pk, max_restarts=2),
                session_factory=lambda: _session(pk, initial), fault_injector=always_fail,
                clock=VirtualClock(),
            )
            await server.start()
            server.add_tenant(pk.Tenant(tenant_id="t"))
            await server.register_query("t", pk.plan.sssp(0, max_iters=MAX_ITERS))
            server.submit("t", streams["tenant0"][0])
            with pytest.raises(pk.Fault):
                await server.drain()
            with pytest.raises(pk.Fault):
                server.submit("t", streams["tenant0"][1])
            faults = server.faults
            with pytest.raises(pk.Fault):
                await server.stop()
            return faults

        return asyncio.run(main())

    assert _both(run) == (3, 3)


def test_admission_rejects_do_not_leak_query_slots():
    """register → shed-reject → re-register leaves the slot pool as a
    straight registration would."""
    initial, streams = _workload(tenants=1, num_batches=4, seed=3)

    def run(pk):
        async def main():
            server = _server(pk, initial)
            async with server:
                server.add_tenant(pk.Tenant(tenant_id="t"))
                first = await server.register_query("t", pk.plan.sssp(0, max_iters=MAX_ITERS))
                for _ in range(3):
                    server.admission.shedding = True
                    with pytest.raises(pk.adm.AdmissionRejected):
                        await server.register_query("t", pk.plan.sssp(1, max_iters=MAX_ITERS))
                    server.admission.shedding = False
                mid = server.stats()
                assert server.session.stats()["active_queries"] == 1
                assert mid["tenants"]["t"]["queries"] == 1 and mid["tenants"]["t"]["rejected_registers"] == 3
                second = await server.register_query("t", pk.plan.sssp(1, max_iters=MAX_ITERS))
                assert server.session.stats()["active_queries"] == 2
                for batch in streams["tenant0"]:
                    server.submit("t", batch)
                await server.drain()
                r1 = await server.read(first, timeout_s=30.0)
                r2 = await server.read(second, timeout_s=30.0)
                assert r1.fresh and r2.fresh
                freed = [await server.deregister_query(second), await server.deregister_query(first)]
                assert server.session.stats()["active_queries"] == 0
                return freed, server.stats()["tenants"]["t"]["queries"], np.array(r2.values)

        return asyncio.run(main())

    ref, port = _both(run)
    assert port[:2] == ref[:2] and port[1] == 0
    np.testing.assert_array_equal(port[2], ref[2])


# ----------------------------------------------------- scenario and CLI
def _capture_reads(monkeypatch, server_mod):
    """Record every read's values; the scenario's servers get an injected
    clock (a wall-clock spike would raise a straggler event and a
    degradation in one package's run alone)."""
    got = []
    real = server_mod.CQPServer.read
    real_init = server_mod.CQPServer.__init__

    def init(self, *args, **kw):
        real_init(self, *args, **{**kw, "clock": VirtualClock()})

    monkeypatch.setattr(server_mod.CQPServer, "__init__", init)

    async def read(self, ticket, **kw):
        r = await real(self, ticket, **kw)
        got.append((ticket.ticket_id, np.array(r.values)))
        return r

    monkeypatch.setattr(server_mod.CQPServer, "read", read)
    return got


@pytest.mark.parametrize("fault", [False, True], ids=["clean", "fault"])
def test_scripted_scenario_matches_the_reference(fault, monkeypatch, tmp_path):
    """``_scripted_scenario`` of both packages on the same arguments (dense
    engine, 3 tenants, a checkpoint every 2 chunks, a fault before chunk 3):
    the same reads bit for bit, faults, restores, replayed chunks,
    degradation actions and history; the port's own check is bit for bit."""
    out = {}
    for name, pk in PKGS.items():
        reads = _capture_reads(monkeypatch, pk.server)
        args = argparse.Namespace(
            v=64, e=256, updates=48, batch=8, max_iters=16, seed=0, tenants=3, engine="dense",
            mesh="none", shards=None, checkpoint_dir=str(tmp_path / name) if fault else None,
            checkpoint_every=2 if fault else 0, inject_fault_at=3 if fault else None,
            no_admission=False, trace_out=None, metrics_out=None, device=CPU,
        )
        out[name] = (pk.server._scripted_scenario(args), reads)
    (rs, r_reads), (ts, t_reads) = out["ref"], out["port"]
    assert ts["ok"] and ts["exact"] and rs["ok"]
    assert [t for t, _ in t_reads] == [t for t, _ in r_reads]
    for (_, a), (_, b) in zip(t_reads, r_reads):
        np.testing.assert_array_equal(a, b)
    for key in ("faults", "epochs", "covered_updates", "chunks_applied", "actions"):
        assert ts[key] == rs[key], key
    if fault:
        tr, rr = ts["recovery"], rs["recovery"]
        assert tr["history"] == rr["history"] and "fault@3:InjectedFault" in tr["history"]
        assert tr["replayed_chunks"] == rr["replayed_chunks"]
        assert [r["resumed_chunk"] for r in tr["restores"]] == [r["resumed_chunk"] for r in rr["restores"]]


def _cli_args(**kw) -> argparse.Namespace:
    """``cqp_serve``'s arguments at its ``--smoke`` size."""
    base = dict(
        v=64, e=256, queries=4, updates=32, batch=8, max_iters=24, delete_fraction=0.2, query="sssp",
        optimize="none", plan_file=None, engine="dense", backend="coo", seed=0, register_at=None,
        deregister_at=None, budget_bytes=None, governor="prob", governor_bloom_bits=1 << 9, smoke=True,
        mesh="none", shards=None, emulate_devices=0, checkpoint_dir=None, checkpoint_every=4,
        checkpoint_keep=3, restore=False, inject_fault_at=None, max_restarts=5, backoff_s=0.0,
        trace_out=None, metrics_out=None, json=False, device=CPU,
    )
    base.update(kw)
    return argparse.Namespace(**base)


def _serve(cli, session_cls, monkeypatch, **kw):
    """Run ``cli.serve``; returns its report and the final session's
    answers (the last session asked for its per-query bytes)."""
    seen = []
    real = session_cls.nbytes_per_query

    def spy(self):
        seen.append(self)
        return real(self)

    monkeypatch.setattr(session_cls, "nbytes_per_query", spy)
    out = cli.serve(_cli_args(**kw))
    monkeypatch.setattr(session_cls, "nbytes_per_query", real)
    final = seen[-1]
    return out, [final.answers(h) for h in final.handles()]


def test_cqp_serve_governor_and_churn_match_the_reference(monkeypatch):
    """A governed run with churn: equal per-query and per-operator bytes,
    answers and the governor's whole report (actions, levels, telemetry)."""
    kw = dict(budget_bytes=2048, register_at=[2], deregister_at=[3])
    (r_out, r_ans), (t_out, t_ans) = (_serve(r_cli, RSession, monkeypatch, **kw),
                                      _serve(t_cli, TSession, monkeypatch, **kw))
    for key in ("final_queries", "updates_served", "nbytes_per_query", "nbytes_per_operator",
                "peak_diff_bytes", "bytes_freed", "registers", "deregisters"):
        assert t_out[key] == r_out[key], key
    assert t_out["governor"] == r_out["governor"]
    assert t_out["governor"]["actions"]
    for a, b in zip(t_ans, r_ans):
        np.testing.assert_array_equal(a, b)


def test_cqp_serve_fault_drill_matches_the_reference(monkeypatch, tmp_path):
    """The durability drill: checkpoint every 2 chunks, a fault before chunk
    3, restore and replay — the port (``fused``) ends with the reference's
    (``coo``) bytes, answers and recovery history; then each package
    resumes from the OTHER's checkpoint directory (``--restore``) to the
    same bytes and answers, as the uninterrupted run."""
    base, base_ans = _serve(r_cli, RSession, monkeypatch)
    runs = {}
    for name, cli, cls, backend in (("ref", r_cli, RSession, "coo"), ("port", t_cli, TSession, "fused")):
        runs[name] = _serve(cli, cls, monkeypatch, backend=backend, checkpoint_dir=str(tmp_path / name),
                            checkpoint_every=2, inject_fault_at=[3])
    (r_out, r_ans), (t_out, t_ans) = runs["ref"], runs["port"]
    rec, r_rec = t_out["recovery"], r_out["recovery"]
    assert rec["restarts"] == 1 and "fault@3:InjectedFault" in rec["history"]
    for key in ("history", "checkpoints", "checkpoint_bytes", "replayed_chunks"):
        assert rec[key] == r_rec[key], key
    assert t_out["runtime"]["straggler"]["observed"] == r_out["runtime"]["straggler"]["observed"]
    assert t_out["nbytes_per_query"] == r_out["nbytes_per_query"] == base["nbytes_per_query"]
    for a, b, c in zip(t_ans, r_ans, base_ans):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    t_res, t_res_ans = _serve(t_cli, TSession, monkeypatch, checkpoint_dir=str(tmp_path / "ref"), restore=True)
    r_res, r_res_ans = _serve(r_cli, RSession, monkeypatch, checkpoint_dir=str(tmp_path / "port"), restore=True)
    assert t_res["nbytes_per_query"] == r_res["nbytes_per_query"] == base["nbytes_per_query"]
    for a, b, c in zip(t_res_ans, r_res_ans, base_ans):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)


def test_cqp_serve_cli_subprocess(tmp_path):
    """``python -m repro_torch.launch.cqp_serve --smoke --json --device cpu``
    with the fault drill: the JSON line's recovery block and answer
    digests; ``--query spsp --optimize auto`` runs, and its target answers
    equal an un-rewritten SCRATCH run's."""
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    cmd = [sys.executable, "-m", "repro_torch.launch.cqp_serve", "--smoke", "--json", "--device", "cpu"]
    proc = subprocess.run(cmd + ["--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2",
                                 "--inject-fault-at", "3", "--backend", "fused"],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["recovery"]["restarts"] == 1 and len(out["answers_sha256"]) == out["final_queries"] == 4
    assert out["runtime"]["fault"]["history"][1] == "fault@3:InjectedFault"
    spsp = {}
    for name, extra in (("auto", ["--optimize", "auto", "--engine", "scratch"]),
                        ("always", ["--optimize", "always", "--backend", "fused"]),
                        ("scratch", ["--engine", "scratch"])):
        run = subprocess.run(cmd + ["--query", "spsp"] + extra, capture_output=True, text=True, env=env,
                             timeout=300)
        assert run.returncode == 0, run.stderr
        spsp[name] = json.loads(run.stdout.strip().splitlines()[-1])
    assert "planner" not in spsp["scratch"]
    for name in ("auto", "always"):
        lmk = spsp[name]["planner"]["landmark"]
        assert spsp[name]["planner"]["rewrites_total"] == 4 and lmk["live"] and lmk["queries"] == 4
        assert spsp[name]["aggregates"] == spsp["scratch"]["aggregates"]
    assert all(a["agg"] == "target" for a in spsp["scratch"]["aggregates"])
