"""Port parity: the memory governor, its telemetry and the shed primitive.

A governed ``CQPSession`` of the port (``device="cpu"``) and one of the
reference take the same churny stream under the same budget: their
``GovernorAction`` logs (as dicts), ladder levels, telemetry snapshots and
accounted bytes must be equal after every step, and every answer must equal
the SCRATCH oracle.  The reference's hypothesis property (budget held,
answers exact on random streams) runs as a plain seeded loop.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import diffstore as rds
from repro.core import dropping as rdr
from repro.core import plan as rplan
from repro.core.governor import GovernorConfig as RGovCfg
from repro.core.graph import DynamicGraph as RGraph
from repro.core.session import CQPSession as RSession
from repro_torch.core import diffstore as tds
from repro_torch.core import dropping as tdr
from repro_torch.core import plan as tplan
from repro_torch.core.governor import GovernorConfig as TGovCfg
from repro_torch.core.graph import DynamicGraph as TGraph
from repro_torch.core.session import CQPSession as TSession
from repro_torch.core.telemetry import RecomputeTelemetry
from repro_torch.obs import metrics as obs_metrics
from test_torch_engine import random_workload

V = 16
CPU = "cpu"
MAX_ITERS = 16


def _pair(initial, *, gov: dict | None = None, drop: dict | None = None, v=V, **kw):
    """(reference, port) dense sessions on copies of one graph."""
    out = []
    for sess, graph, gcls, dmod, extra in ((RSession, RGraph, RGovCfg, rdr, {}),
                                           (TSession, TGraph, TGovCfg, tdr, {"device": CPU})):
        k = dict(kw, **extra)
        if gov is not None:
            k["governor"] = gcls(**gov)
        if drop is not None:
            k["drop"] = dmod.DropConfig(**drop)
        out.append(sess(graph(v, initial, capacity=256), engine="dense", **k))
    return tuple(out)


def _same_governor(ref, port):
    rg, tg = ref.governor, port.governor
    assert [a.to_dict() for a in tg.actions] == [a.to_dict() for a in rg.actions]
    assert tg.op_levels == rg.op_levels
    assert tg.state_dict() == rg.state_dict()
    assert port.stats()["governor"] == ref.stats()["governor"]
    assert port.nbytes_per_query() == ref.nbytes_per_query()


@pytest.mark.parametrize("representation", ["det", "prob"])
def test_budget_closed_loop_matches_the_reference(representation):
    """Register, stream, register mid-stream, deregister under a budget
    below the ungoverned peak: equal action logs, levels, telemetry and
    bytes; the budget holds after one settling batch; answers equal
    SCRATCH."""
    initial, batches = random_workload(7, v=V, e=48, num_batches=6)
    plans = lambda mod: [mod.sssp(i, max_iters=MAX_ITERS) for i in range(3)]  # noqa: E731
    static = TSession(TGraph(V, initial, capacity=256), engine="dense", device=CPU)
    static.register_many(plans(tplan))
    peak = static.nbytes()
    for b in batches:
        static.apply_updates(b)
        peak = max(peak, static.nbytes())
    bloom_bits = 1 << 7
    floor = 4 * (bloom_bits // 8 + tdr.PARAMS_ROW_NBYTES)
    budget = max(int(peak * 0.5), floor + 48)
    assert budget < peak
    gov = dict(representation=representation, bloom_bits=bloom_bits)
    ref, port = _pair(initial, gov=gov, budget_bytes=budget)
    rh, th = ref.register_many(plans(rplan)), port.register_many(plans(tplan))
    _same_governor(ref, port)
    for j, b in enumerate(batches):
        ref.apply_updates(b)
        port.apply_updates(b)
        if j == 1:
            rh.append(ref.register(rplan.sssp(9, max_iters=MAX_ITERS)))
            th.append(port.register(tplan.sssp(9, max_iters=MAX_ITERS)))
        if j == 3:
            assert port.deregister(th.pop(0)) == ref.deregister(rh.pop(0))
        _same_governor(ref, port)
        if j >= 1 and representation == "prob":
            assert port.nbytes() <= budget, (j, port.nbytes(), budget)
    assert any(a.kind == "escalate" for a in port.governor.actions)
    oracle = TSession(TGraph(V, initial, capacity=256), engine="scratch", device=CPU)
    oh = oracle.register_many(plans(tplan)[1:] + [tplan.sssp(9, max_iters=MAX_ITERS)])
    oracle.apply_updates([u for b in batches for u in b])
    for h, o in zip(th, oh):
        np.testing.assert_array_equal(port.answers(h), oracle.answers(o))
    json.dumps(port.stats()["governor"])


def test_budget_property_seeded_streams():
    """The reference's hypothesis property as a plain seeded loop: under a
    tight budget the dense and host engines stay at or below
    max(budget, Bloom floor) after settling and answer as SCRATCH."""
    v, rng = 12, np.random.default_rng(23)
    for _ in range(3):
        edges = {}
        for _k in range(int(rng.integers(8, 20))):
            u, w = (int(x) for x in rng.integers(0, v, 2))
            if u != w:
                edges[(u, w)] = (u, w, float(rng.integers(1, 10)))
        present, ops = set(edges), []
        for _k in range(int(rng.integers(4, 12))):
            if present and rng.random() < 0.5:
                u, w = sorted(present)[int(rng.integers(0, len(present)))]
                ops.append((u, w, 0, 1.0, -1))
                present.discard((u, w))
            else:
                u, w = (int(x) for x in rng.integers(0, v, 2))
                if u != w:
                    ops.append((u, w, 0, float(rng.integers(1, 10)), +1))
                    present.add((u, w))
        plans = [tplan.sssp(0, max_iters=12), tplan.sssp(v // 2, max_iters=12)]
        oracle = TSession(TGraph(v, list(edges.values()), capacity=128), engine="scratch", device=CPU)
        oh = oracle.register_many(plans)
        oracle.apply_updates(ops)
        for engine in ("dense", "host"):
            s = TSession(TGraph(v, list(edges.values()), capacity=128), engine=engine, device=CPU,
                         budget_bytes=96, governor=TGovCfg(representation="prob", bloom_bits=1 << 8))
            hs = s.register_many(plans)
            half = len(ops) // 2
            s.apply_updates(ops[:half])
            s.apply_updates(ops[half:])
            for a, b in zip(hs, oh):
                np.testing.assert_array_equal(s.answers(a), oracle.answers(b))
            assert s.nbytes() <= max(96, 2 * (32 + 17)), (engine, s.nbytes())


def test_set_drop_policy_sheds_and_stays_exact():
    """Escalating one query sheds ITS stored diffs (bytes fall at once, as
    in the reference), leaves the other query's bytes, and answers stay
    exact; stepping back to a weaker policy sheds nothing."""
    initial, batches = random_workload(11, v=V, e=48, num_batches=3)
    ref, port = _pair(initial, drop=dict(mode="det"))
    r = [ref.register(rplan.sssp(s, max_iters=MAX_ITERS)) for s in (0, 5)]
    t = [port.register(tplan.sssp(s, max_iters=MAX_ITERS)) for s in (0, 5)]
    ref.apply_updates(batches[0])
    port.apply_updates(batches[0])
    before = port.nbytes_per_query()
    freed = port.set_drop_policy(t[0], tdr.DropConfig(mode="det", p=1.0, seed=2))
    assert freed == ref.set_drop_policy(r[0], rdr.DropConfig(mode="det", p=1.0, seed=2)) > 0
    after = port.nbytes_per_query()
    assert after == [before[0] - freed, before[1]]
    assert port.bytes_shed_total == freed
    host = TSession(TGraph(V, initial, capacity=256), engine="host", device=CPU)
    h = [host.register(tplan.sssp(s, max_iters=MAX_ITERS)) for s in (0, 5)]
    host.apply_updates(batches[0])
    for b in batches[1:]:
        for s in (ref, port, host):
            s.apply_updates(b)
    for a, b, c in zip(r, t, h):
        np.testing.assert_array_equal(port.answers(b), host.answers(c))
        np.testing.assert_array_equal(port.answers(b), ref.answers(a))
    assert port.set_drop_policy(t[0], tdr.DropConfig(mode="det", p=0.3, seed=2)) == 0


def test_governor_deescalates_after_headroom():
    """Hysteresis: once deregistrations open headroom under the low-water
    mark, the governor walks the survivor back to its registered policy,
    with the reference's action log."""
    initial, batches = random_workload(13, v=V, e=48, num_batches=6)
    gov = dict(representation="prob", bloom_bits=1 << 8, cooldown_passes=0)
    ref, port = _pair(initial, gov=gov, budget_bytes=400)
    rh = ref.register_many([rplan.sssp(i, max_iters=MAX_ITERS) for i in range(3)])
    th = port.register_many([tplan.sssp(i, max_iters=MAX_ITERS) for i in range(3)])
    ref.apply_updates(batches[0])
    port.apply_updates(batches[0])
    assert any(lvl > 0 for lvl in port.governor.levels.values())
    for _ in range(2):
        ref.deregister(rh.pop(0))
        port.deregister(th.pop(0))
    for b in batches[1:]:
        ref.apply_updates(b)
        port.apply_updates(b)
        _same_governor(ref, port)
    assert any(a.kind == "deescalate" for a in port.governor.actions)
    assert port.governor.levels == {2: 0}
    assert port.nbytes() <= 400


def test_shed_evictions_surface_and_block_only_the_culprit():
    """A shed that evicts Det records surfaces the loss and bars only the
    culprit from escalating, as in the reference."""
    initial, batches = random_workload(19, v=V, e=48, num_batches=4)
    ref, port = _pair(initial, gov=dict(representation="det", det_capacity=1), budget_bytes=64)
    ref.register_many([rplan.sssp(i, max_iters=MAX_ITERS) for i in range(3)])
    port.register_many([tplan.sssp(i, max_iters=MAX_ITERS) for i in range(3)])
    for b in batches:
        ref.apply_updates(b)
        port.apply_updates(b)
    _same_governor(ref, port)
    gov = port.stats()["governor"]
    assert gov["det_overflow_shed"] > 0 and gov["overflow_blocked"]


def test_telemetry_and_metrics_registry():
    """RecomputeTelemetry folds cumulative counters into per-update EWMAs
    and publishes them; a session's metrics scrape matches its stats."""
    t = RecomputeTelemetry(alpha=0.5)
    t.observe(nbytes_per_query={0: 100, 1: 50}, cost_per_query={0: 10, 1: 0}, updates_applied=10)
    assert t.cost_rate(0) == pytest.approx(1.0)
    t.observe(nbytes_per_query={0: 80}, cost_per_query={0: 30}, updates_applied=20)
    assert t.cost_rate(0) == pytest.approx(1.5)
    assert t.cost_rate(1) == 0.0 and t.bytes_held(0) == 80
    assert "1" not in t.snapshot()["per_query"]
    initial, batches = random_workload(3, v=V, e=48, num_batches=1)
    s = TSession(TGraph(V, initial, capacity=256), engine="dense", device=CPU,
                 drop=tdr.DropConfig(mode="prob", bloom_bits=1 << 8))
    s.register_many([tplan.sssp(i, max_iters=MAX_ITERS, drop=tdr.DropConfig(mode="prob", p=0.5))
                     for i in range(2)])
    s.apply_updates(batches[0])
    reg = s.publish_metrics(obs_metrics.MetricsRegistry())
    snap = reg.snapshot()
    assert snap["cqp_nbytes"]["series"][0]["value"] == s.nbytes()
    fills = [x["value"] for x in snap["cqp_bloom_fill_ratio"]["series"]]
    want = s._impl.impl.state.drop.flt.bits.to(torch.float32).mean(dim=-1)
    assert fills == pytest.approx(want[list(s._handles.values())].tolist())
    assert "cqp_bloom_fill_ratio" in reg.prometheus_text()


def test_select_stored_to_drop_matches_the_sweep_coin_and_the_reference():
    """The shed audit reuses the sweep's stateless coin, never selects
    padding, equals the reference's, and one slot's row audited alone
    (``q_ids``) equals that row of the whole audit."""
    rng = np.random.default_rng(5)
    q, v, s = 3, 7, 4
    iters = np.sort(rng.integers(1, 20, (q, v, s)), axis=-1).astype(np.int32)
    iters[rng.random((q, v, s)) < 0.3] = tds.IMAX
    iters = np.sort(iters, axis=-1)
    degree = rng.integers(0, 9, v).astype(np.float32)
    rows = [dict(mode="det", p=0.5, seed=3), dict(mode="det", selection="degree", p=0.4,
                                                   tau_min=2.0, tau_max=6.0, seed=8),
            dict(mode="det", p=0.9, seed=4294967295)]
    tp = tdr.make_params([tdr.DropConfig(**r) for r in rows])
    rp = rdr.make_params([rdr.DropConfig(**r) for r in rows])
    got = tdr.select_stored_to_drop(tp, torch.from_numpy(degree), torch.from_numpy(iters), tds.IMAX)
    want = rdr.select_stored_to_drop(rp, jnp.asarray(degree), jnp.asarray(iters), rds.IMAX)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[torch.from_numpy(iters) == tds.IMAX].any()
    q_ids = torch.arange(q, dtype=torch.int32)[:, None]
    for vi in range(v):
        for si in range(s):
            coin = tdr.select_to_drop(tp, torch.from_numpy(degree)[None, :], q_ids,
                                      torch.full((q, v), vi, dtype=torch.int32),
                                      torch.from_numpy(iters[:, vi, si]).expand(v, q).T)[:, vi]
            live = torch.from_numpy(iters[:, vi, si] != tds.IMAX)
            np.testing.assert_array_equal(got[:, vi, si].numpy(), (coin & live).numpy())
    for slot in range(q):
        one = tdr.DropParams(*(x[slot : slot + 1] for x in tp))
        row = tdr.select_stored_to_drop(one, torch.from_numpy(degree),
                                        torch.from_numpy(iters[slot : slot + 1]), tds.IMAX, q_ids=slot)
        np.testing.assert_array_equal(row[0].numpy(), got[slot].numpy())
