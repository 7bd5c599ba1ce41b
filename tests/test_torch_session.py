"""Port parity: ``CQPSession`` on the ``"dense"``, ``"host"`` and
``"scratch"`` engines against the reference session on the same stream.

The same seeded streams (register, update, register mid-stream, deregister)
go through ``repro.core.session.CQPSession`` (Pallas kernels in interpret
mode) and ``repro_torch.core.session.CQPSession`` with ``device="cpu"``:
every query's answers, ``nbytes_per_query``, ``nbytes_per_operator`` and
the lifetime counters must be equal.  The reference's hypothesis property
(mid-stream registration converges to from-start, on every engine) runs as
a plain seeded loop: ``hypothesis`` is not installed here.
"""

import numpy as np
import pytest
import torch

from repro.core import dropping as rdr
from repro.core import plan as rplan
from repro.core.graph import DynamicGraph as RGraph
from repro.core.session import CQPSession as RSession
from repro_torch.core import dropping as tdr
from repro_torch.core import plan as tplan
from repro_torch.core import queries as tq
from repro_torch.core.graph import DynamicGraph as TGraph
from repro_torch.core.session import ENGINES, CQPSession as TSession
from repro_torch.launch.mesh import make_data_mesh
from test_torch_engine import random_workload

V = 16
CPU = "cpu"
MAX_ITERS = 16


def _sessions(initial, engine, v=V, **kw):
    """(reference, port) sessions on copies of one graph."""
    rkw = {k: (x[0] if isinstance(x, tuple) else x) for k, x in kw.items()}
    tkw = {k: (x[1] if isinstance(x, tuple) else x) for k, x in kw.items()}
    return (RSession(RGraph(v, initial, capacity=256), engine=engine, **rkw),
            TSession(TGraph(v, initial, capacity=256), engine=engine, device=CPU, **tkw))


def _same_views(ref, port, rh, th):
    for a, b in zip(rh, th):
        assert a.qid == b.qid
        np.testing.assert_array_equal(port.answers(b), ref.answers(a))
    assert port.nbytes_per_query() == ref.nbytes_per_query()
    assert port.nbytes_per_operator() == ref.nbytes_per_operator()
    assert port.nbytes() == ref.nbytes()
    rs, ts = ref.stats(), port.stats()
    for k in ("active_queries", "registered_total", "deregistered_total", "updates_applied",
              "bytes_freed_total", "bytes_shed_total", "query_qids", "slot_capacity"):
        assert ts.get(k) == rs.get(k), k


STREAMS = [("dense", "coo", None), ("dense", "fused", "det"), ("host", "coo", None),
           ("scratch", "coo", None)]


@pytest.mark.parametrize("engine,backend,drop", STREAMS)
def test_session_churn_matches_the_reference(engine, backend, drop):
    """register_many, updates, a mid-stream register, a deregister and a
    batched tail: equal answers and byte maps after every step."""
    initial, batches = random_workload(11, v=V, e=48, num_batches=4)
    kw = {"backend": backend}
    if drop:
        kw["drop"] = (rdr.DropConfig(mode=drop), tdr.DropConfig(mode=drop))
    ref, port = _sessions(initial, engine, **kw)

    def plans(mod, dmod, sources):
        pol = dmod.DropConfig(mode=drop, p=0.5, seed=3) if drop else dmod.DropConfig()
        return [mod.sssp(s, max_iters=MAX_ITERS, drop=pol) for s in sources]

    rh = ref.register_many(plans(rplan, rdr, [0, 7]))
    th = port.register_many(plans(tplan, tdr, [0, 7]))
    _same_views(ref, port, rh, th)
    for j, b in enumerate(batches[:3]):
        ref.apply_updates(b)
        port.apply_updates(b)
        if j == 1:
            rh += ref.register_many(plans(rplan, rdr, [3]))
            th += port.register_many(plans(tplan, tdr, [3]))
        _same_views(ref, port, rh, th)
    assert port.deregister(th.pop(0)) == ref.deregister(rh.pop(0))
    _same_views(ref, port, rh, th)
    ref.apply_updates_batched(batches[3], batch_size=2)
    port.apply_updates_batched(batches[3], batch_size=2)
    _same_views(ref, port, rh, th)
    if engine == "dense":
        assert port.stats()["last_maintain"] == ref.stats()["last_maintain"]


def test_pagerank_and_aggregates_match_the_reference():
    """A PageRank session (rtol 1e-6) and an SSSP plan's top-k and
    histogram aggregates."""
    initial, batches = random_workload(12, v=V, e=48, num_batches=2)
    ref, port = _sessions(initial, "dense")
    a, b = ref.register(rplan.pagerank(iters=8)), port.register(tplan.pagerank(iters=8))
    for batch in batches:
        ref.apply_updates(batch)
        port.apply_updates(batch)
    np.testing.assert_allclose(port.answers(b), ref.answers(a), rtol=1e-6)
    ref, port = _sessions(initial, "dense")
    for agg in ("topk", "histogram"):
        a = ref.register(rplan.sssp(2, max_iters=MAX_ITERS).with_aggregate(agg, k=4, bins=4))
        b = port.register(tplan.sssp(2, max_iters=MAX_ITERS).with_aggregate(agg, k=4, bins=4))
        ref.apply_updates(batches[0])
        port.apply_updates(batches[0])
        assert port.aggregate(b) == ref.aggregate(a)


def test_rpq_session_churn_matches_the_reference():
    """RPQ plans (NFA product graph) through the lifecycle, and the
    ``queries.RPQ`` wrapper."""
    edges = [(i, (i + 1) % V, 1.0, 1 + (i % 2)) for i in range(V)]
    nfas = (rplan.NFA.concat_star(1, 2), tplan.NFA.concat_star(1, 2))
    sessions = (RSession(RGraph(V, edges, capacity=128), engine="dense"),
                TSession(TGraph(V, edges, capacity=128), engine="dense", device=CPU))
    got = []
    for s, mod, nfa in zip(sessions, (rplan, tplan), nfas):
        h0 = s.register(mod.rpq(0, nfa, max_iters=MAX_ITERS))
        s.apply_updates([(0, 5, 1, 1.0, +1)])
        h1 = s.register(mod.rpq(4, nfa, max_iters=MAX_ITERS))  # mid-stream
        s.apply_updates([(5, 9, 2, 1.0, +1), (3, 4, 2, 1.0, -1)])
        got.append((s.reachable(h0), s.reachable(h1), s.deregister(h0), s.nbytes()))
    for x, y in zip(*got):
        np.testing.assert_array_equal(x, y)
    rpq = tq.RPQ(TGraph(V, edges, capacity=128), nfas[1], [0, 4], max_iters=MAX_ITERS, device=CPU)
    rpq.apply_updates([(0, 5, 1, 1.0, +1)])
    assert rpq.reachable().shape == (2, V)
    assert rpq.pgraph.num_vertices == V * nfas[1].num_states


@pytest.mark.parametrize("engine", ENGINES)
def test_midstream_register_equals_from_start_seeded_streams(engine):
    """The reference's property (``test_session_lifecycle.py``) as a plain
    seeded loop: on random insert/delete streams with a random split, a
    query registered mid-stream answers as one registered from the start,
    and the three engines agree."""
    rng = np.random.default_rng(17)
    for _ in range(4):
        n = int(rng.integers(6, 24))
        edges = {}
        for _k in range(n):
            u, w = (int(x) for x in rng.integers(0, V, 2))
            if u != w:
                edges[(u, w)] = (u, w, float(rng.integers(1, 10)))
        present, ops = set(edges), []
        for _k in range(int(rng.integers(2, 10))):
            if present and rng.random() < 0.5:
                u, w = sorted(present)[int(rng.integers(0, len(present)))]
                ops.append((u, w, 0, 1.0, -1))
                present.discard((u, w))
            else:
                u, w = (int(x) for x in rng.integers(0, V, 2))
                if u != w:
                    ops.append((u, w, 0, float(rng.integers(1, 10)), +1))
                    present.add((u, w))
        cut, src = int(rng.integers(0, len(ops) + 1)), int(rng.integers(0, V))
        rows = {}
        for eng in ENGINES:
            a = TSession(TGraph(V, list(edges.values()), capacity=256), engine=eng, device=CPU)
            ha = a.register(tplan.sssp(src, max_iters=MAX_ITERS))
            a.apply_updates(ops)
            b = TSession(TGraph(V, list(edges.values()), capacity=256), engine=eng, device=CPU)
            b.apply_updates(ops[:cut])
            hb = b.register(tplan.sssp(src, max_iters=MAX_ITERS))
            b.apply_updates(ops[cut:])
            np.testing.assert_array_equal(a.answers(ha), b.answers(hb))
            rows[eng] = a.answers(ha)
        if engine == "dense":
            ref = RSession(RGraph(V, list(edges.values()), capacity=256), engine="dense")
            hr = ref.register(rplan.sssp(src, max_iters=MAX_ITERS))
            ref.apply_updates(ops)
            np.testing.assert_array_equal(rows["dense"], ref.answers(hr))
        np.testing.assert_array_equal(rows[engine], rows["scratch"])


def test_failed_register_batch_leaves_the_session_untouched():
    """A rejected opening batch commits nothing: the session then takes a
    clean batch, and pre-engine updates land on the base graph."""
    initial, batches = random_workload(13, v=V, e=48, num_batches=2)
    log = batches[0] + batches[1]
    s = TSession(TGraph(V, initial, capacity=256), engine="dense", device=CPU)
    nfa = tplan.NFA.star(1)
    with pytest.raises(ValueError, match="family"):
        s.register_many([tplan.rpq(0, nfa, max_iters=MAX_ITERS), tplan.sssp(1, max_iters=MAX_ITERS)])
    assert s.num_queries == 0 and s._impl is None
    s.apply_updates(log[:2])  # pre-engine: applies to the base graph
    h = s.register(tplan.sssp(0, max_iters=MAX_ITERS))
    s.apply_updates(log[2:])
    ref = RSession(RGraph(V, initial, capacity=256), engine="host")
    rh = ref.register(rplan.sssp(0, max_iters=MAX_ITERS))
    ref.apply_updates(log)
    np.testing.assert_array_equal(s.answers(h), ref.answers(rh))

    s2 = TSession(TGraph(V, initial, capacity=256), engine="dense", device=CPU)
    with pytest.raises(ValueError, match="drop mode"):
        s2.register_many([
            tplan.sssp(0, max_iters=MAX_ITERS, drop=tdr.DropConfig(mode="det", p=0.5)),
            tplan.sssp(1, max_iters=MAX_ITERS, drop=tdr.DropConfig(mode="prob", p=0.5)),
        ])
    assert s2.num_queries == 0
    s2.register(tplan.sssp(0, max_iters=MAX_ITERS, drop=tdr.DropConfig(mode="prob", p=0.5)))

    s3 = TSession(TGraph(V, initial, capacity=256), engine="host", device=CPU)
    with pytest.raises(ValueError, match="min-family"):
        s3.register(tplan.pagerank())
    h3 = s3.register(tplan.sssp(0, max_iters=MAX_ITERS))  # not bricked
    assert s3.answers(h3).shape == (V,)


def test_validation_errors_and_unported_pieces(tmp_path):
    """The reference's validation errors; a mesh that is not a DataMesh is
    refused with TypeError (also on restore), and a 2-shard CPU mesh runs
    the sharded sweep, with the optimizer too, and restores onto a mesh; a
    restore from an empty directory finds nothing; the default device is
    the GPU."""
    initial, _ = random_workload(14, v=V, e=48, num_batches=1)
    s = TSession(TGraph(V, initial, capacity=256), engine="dense", device=CPU)
    h = s.register(tplan.sssp(0, max_iters=MAX_ITERS))
    with pytest.raises(ValueError, match="family"):
        s.register(tplan.khop(1, k=4))
    with pytest.raises(ValueError, match="drop mode"):
        s.register(tplan.sssp(1, max_iters=MAX_ITERS, drop=tdr.DropConfig(mode="det", p=0.5)))
    rpq = TSession(TGraph(V, initial, capacity=256), engine="dense", device=CPU)
    rpq.register(tplan.rpq(0, tplan.NFA.star(0), max_iters=MAX_ITERS))
    with pytest.raises(ValueError, match="materializes the Join"):
        rpq.register(tplan.rpq(1, tplan.NFA.star(0), max_iters=MAX_ITERS, join_store="materialize"))
    s.deregister(h)
    with pytest.raises(ValueError, match="not registered"):
        s.deregister(h)
    with pytest.raises(ValueError, match="not registered"):
        s.set_drop_policy(h, tdr.DropConfig(mode="det", p=0.5))
    graph = TGraph(V, initial, capacity=256)
    with pytest.raises(ValueError, match="unknown engine"):
        TSession(graph, engine="tpu", device=CPU)
    with pytest.raises(ValueError, match="mesh"):
        TSession(graph, engine="host", mesh=object(), device=CPU)
    with pytest.raises(ValueError, match="budget_bytes"):
        TSession(graph, engine="dense", governor=object(), device=CPU)
    with pytest.raises(TypeError, match="DataMesh"):
        TSession(graph, engine="dense", mesh=object(), device=CPU)
    with pytest.raises(TypeError, match="DataMesh"):
        TSession(graph, engine="dense", mesh=object(), optimize="always", device=CPU)
    mesh = make_data_mesh(2, device=CPU, emulate=True)
    for optimize in ("none", "always"):
        sharded = TSession(TGraph(V, initial, capacity=256), engine="dense", mesh=mesh,
                           optimize=optimize, device=CPU)
        hs = sharded.register(tplan.sssp(0, max_iters=MAX_ITERS))
        assert sharded.num_shards == 2 and sharded.stats()["shards"] == 2
        assert sum(sharded.nbytes_per_device()) == sharded.nbytes()
    # the plan optimizer runs: a session in auto mode owns a planner, and a
    # plan no rule matches (no Aggregate) registers into an engine slot
    assert TSession(graph, engine="dense", optimize="auto", device=CPU)._planner.mode == "auto"
    h1 = s.register(tplan.sssp(1, max_iters=MAX_ITERS), optimize="always")
    assert h1.plan.provenance == () and not s._planner.owns(h1.qid) and s._planner.decisions == []
    with pytest.raises(FileNotFoundError):
        TSession.restore(str(tmp_path / "none"), device=CPU)
    s.checkpoint(str(tmp_path / "ckpt"))
    with pytest.raises(TypeError, match="DataMesh"):
        TSession.restore(str(tmp_path / "ckpt"), mesh=object(), device=CPU)
    on_mesh = TSession.restore(str(tmp_path / "ckpt"), mesh=mesh)
    assert on_mesh.num_shards == 2 and on_mesh.device == torch.device("cpu")
    sharded.checkpoint(str(tmp_path / "sharded"))
    back = TSession.restore(str(tmp_path / "sharded"), device=CPU)
    np.testing.assert_array_equal(back.answers(back.handles()[0]), sharded.answers(hs))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TSession(graph, engine="dense")
