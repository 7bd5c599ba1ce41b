"""Port parity: the plan optimizer (``planner/*``, ``CQPSession(optimize=)``).

Every case of ``tests/test_planner.py`` runs on both packages: the same
graph and stream, made from a numpy seed, go through the reference's
session and the port's (``device="cpu"``).  Min-plus is held bit for bit:
SPSP target answers and the whole pruned fields, ``iters`` and ``work``,
``stats()["planner"]`` (but the wall-clock ``scratch_seconds``), the byte
and cost maps the governor reads, and the governor's shed and
re-materialise counters.  Checkpoints with planner state cross the
packages both ways.  The sharded case runs on a 2-shard CPU mesh and
equals the unsharded session.
"""

from __future__ import annotations

import types

import numpy as np
import pytest

from repro.core import dropping as rdr
from repro.core import plan as rplan
from repro.core.graph import DynamicGraph as RGraph
from repro.core.session import CQPSession as RSession
from repro import planner as rplanner
from repro_torch.core import dropping as tdr
from repro_torch.core import plan as tplan
from repro_torch.core.graph import DynamicGraph as TGraph
from repro_torch.core.session import CQPSession as TSession
from repro_torch import planner as tplanner
from repro_torch.launch.mesh import make_data_mesh

REF = types.SimpleNamespace(name="ref", S=RSession, G=RGraph, qp=rplan, dr=rdr, planner=rplanner, kw={})
PORT = types.SimpleNamespace(name="port", S=TSession, G=TGraph, qp=tplan, dr=tdr, planner=tplanner,
                             kw={"device": "cpu"})
PKGS = (REF, PORT)

V = 48
E = 240
SEED = 11
QUERIES = [(0, 17), (5, 40), (7, 3), (23, 30)]


def workload(seed=SEED, n_updates=24):
    """``tests/test_planner.py``'s weighted edges and non-colliding insert
    stream."""
    rng = np.random.default_rng(seed)
    seen, edges, ups = set(), [], []
    while len(edges) < E:
        u, w = int(rng.integers(V)), int(rng.integers(V))
        if (u, w) not in seen:
            seen.add((u, w))
            edges.append((u, w, float(rng.integers(1, 9))))
    while len(ups) < n_updates:
        u, w = int(rng.integers(V)), int(rng.integers(V))
        if (u, w) not in seen:
            seen.add((u, w))
            ups.append((u, w, 0, float(rng.integers(1, 9)), 1))
    return edges, ups


EDGES, UPS = workload()


def session(pkg, edges=EDGES, **kw):
    return pkg.S(pkg.G(V, edges, capacity=1024, weighted=True), **kw, **pkg.kw)


def restore(pkg, path):
    return pkg.S.restore(path, **pkg.kw)


def spsp_plans(pkg, drop=None):
    return [pkg.qp.spsp(s, t, drop=drop) for s, t in QUERIES]


def targets(sess, handles):
    return np.array([sess.answers(h)[t] for h, (_, t) in zip(handles, QUERIES)], np.float32)


def reference_targets(ups):
    """Exact target distances via un-rewritten scratch SSSP (the port's)."""
    ref = session(PORT, engine="scratch")
    handles = ref.register_many([tplan.sssp(s) for s, _ in QUERIES])
    ref.apply_updates(list(ups))
    return np.array([ref.answers(h)[t] for h, (_, t) in zip(handles, QUERIES)], np.float32)


def lmk(sess) -> dict:
    """The landmark rule's snapshot without its wall clock."""
    out = dict(sess.stats()["planner"]["landmark"])
    del out["scratch_seconds"]
    return out


def planner_stats(sess) -> dict:
    out = dict(sess.stats()["planner"])
    out["landmark"] = lmk(sess)
    return out


def same_sessions(port, ref, handles_p, handles_r):
    """Pruned fields (not just targets), the planner's snapshot and the
    maps the governor reads are equal across the packages."""
    for hp, hr in zip(handles_p, handles_r):
        np.testing.assert_array_equal(port.answers(hp), np.asarray(ref.answers(hr)))
        assert port.aggregate(hp) == ref.aggregate(hr)
    assert planner_stats(port) == planner_stats(ref)
    assert port._nbytes_per_op_map() == ref._nbytes_per_op_map()
    assert port._recompute_cost_op_map() == ref._recompute_cost_op_map()
    assert port.nbytes() == ref.nbytes()
    assert port.nbytes_per_query() == ref.nbytes_per_query()
    assert port.num_queries == ref.num_queries
    assert port._internal == ref._internal
    s_p, s_r = port.stats(), ref.stats()
    for key in ("active_queries", "registered_total", "deregistered_total", "bytes_freed_total",
                "bytes_shed_total", "query_qids", "nbytes_per_operator"):
        assert s_p[key] == s_r[key], key
    if "governor" in s_r:
        for key in ("escalations", "deescalations", "levels"):
            assert s_p["governor"][key] == s_r["governor"][key], key


# ------------------------------------------------------------------ builders
@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_spsp_builder_shares_sssp_family(pkg):
    assert pkg.qp.spsp(0, 17).family_key() == pkg.qp.sssp(0).family_key()


def test_spsp_aggregate_validates_target():
    from repro_torch.core import dataflow as df

    p = tplan.spsp(3, 9)
    assert p.aggregate.agg == "target" and p.aggregate.vertex == 9
    assert p.to_json() == rplan.spsp(3, 9).to_json()
    with pytest.raises(ValueError, match="target vertex"):
        df.validate(df.canonical(semiring=p.semiring, init=p.init, max_iters=p.max_iters,
                                 aggregate=df.Aggregate(agg="target")))


# ------------------------------------------------------------------- parity
@pytest.mark.parametrize("engine", ["dense", "host", "scratch"])
@pytest.mark.parametrize("drop_mode", ["none", "prob"])
def test_rewrite_parity_engines_and_drop(engine, drop_mode):
    out = {}
    for pkg in PKGS:
        drop = None if drop_mode == "none" else pkg.dr.DropConfig(mode="prob", p=0.25, seed=3, bloom_bits=1 << 10)
        sess = session(pkg, engine=engine, optimize="always")
        handles = sess.register_many(spsp_plans(pkg, drop))
        sess.apply_updates(UPS[:12])
        sess.apply_updates(UPS[12:])
        out[pkg.name] = sess, handles
    (ref, hr), (port, hp) = out["ref"], out["port"]
    # exact at the target even under dropping: the pruned subquery re-runs
    # from scratch, gated only by triangle bounds
    np.testing.assert_array_equal(targets(port, hp), reference_targets(UPS))
    same_sessions(port, ref, hp, hr)
    stats = lmk(port)
    assert stats["queries"] == len(QUERIES) and stats["live"] and stats["pruned_work_total"] > 0
    for h, (_, t) in zip(hp, QUERIES):
        agg = port.aggregate(h)
        assert agg["agg"] == "target" and agg["vertex"] == t


def test_rewrite_parity_sharded_dense_raises_naming_item_4():
    """``test_rewrite_parity_sharded_dense``'s counterpart on a 2-shard CPU
    mesh: the rewritten SPSP targets equal un-rewritten scratch SSSP, and
    every field and the planner's snapshot equal the unsharded session's
    (the landmark twin stays unsharded); a mesh that is not a DataMesh is
    refused with TypeError."""
    mesh = make_data_mesh(2, device="cpu", emulate=True)
    for optimize in ("always", "auto"):
        with pytest.raises(TypeError, match="DataMesh"):
            session(PORT, engine="dense", mesh=object(), optimize=optimize)
        sharded = session(PORT, engine="dense", mesh=mesh, optimize=optimize)
        flat = session(PORT, engine="dense", optimize=optimize)
        hs, hf = sharded.register_many(spsp_plans(PORT)), flat.register_many(spsp_plans(PORT))
        sharded.apply_updates(UPS)
        flat.apply_updates(UPS)
        assert sharded.num_shards == 2
        np.testing.assert_array_equal(targets(sharded, hs), reference_targets(UPS))
        for a, b in zip(hs, hf):
            np.testing.assert_array_equal(sharded.answers(a), flat.answers(b))
        assert planner_stats(sharded) == planner_stats(flat)
        twins = [r.rev_session for r in sharded._planner.rules if getattr(r, "rev_session", None)]
        assert all(t.num_shards == 1 for t in twins) and (optimize == "auto" or twins)


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_optimize_none_is_identity(pkg):
    sess = session(pkg, engine="host")
    handles = sess.register_many(spsp_plans(pkg))
    assert all(h.plan.provenance == () for h in handles)
    assert sess._planner is None and sess._internal == set()
    assert sess.state_dict()[1]["optimize"] == "none"


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_per_call_override_beats_session_mode(pkg):
    sess = session(pkg, engine="host", optimize="always")
    h_plain = sess.register(pkg.qp.sssp(1))  # no aggregate → no match
    h_off = sess.register(pkg.qp.spsp(2, 9), optimize="none")
    h_on = sess.register(pkg.qp.spsp(3, 11))
    assert h_plain.plan.provenance == () and h_off.plan.provenance == ()
    assert h_on.plan.provenance[0].rule == "landmark"
    assert sess._planner.owns(h_on.qid) and not sess._planner.owns(h_off.qid)
    assert [h.qid for h in sess.handles()] == [0, 1, 2]
    assert sess._internal == {3, 4, 5, 6}  # the index rows, registered at its admit


# ---------------------------------------------------------------- cost model
def test_cost_gate_auto_dense_single_query_declines():
    got = []
    for pkg in PKGS:
        sess = session(pkg, engine="dense", optimize="auto")
        h = sess.register(pkg.qp.spsp(0, 17))
        # 1 sharer < 2L break-even on a diff-maintaining engine → untouched
        assert h.plan.provenance == ()
        assert not sess._planner.owns(h.qid)
        assert sess._planner.decisions and not sess._planner.decisions[-1]["applied"]
        got.append(sess._planner.decisions)
    assert got[0] == got[1]


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_cost_gate_auto_scratch_always_pays(pkg):
    sess = session(pkg, engine="scratch", optimize="auto")
    h = sess.register(pkg.qp.spsp(0, 17))
    assert h.plan.provenance and h.plan.provenance[0].rule == "landmark"


def test_cost_estimate_break_even_math():
    got = []
    for pkg in PKGS:
        sess = session(pkg, engine="dense")
        sess.register(pkg.qp.sssp(2))  # a live row: bytes_per_row reads it
        model = pkg.planner.CostModel()
        est_lo = model.landmark(pkg.qp.spsp(0, 1), sess, num_landmarks=4, sharers=3)
        est_hi = model.landmark(pkg.qp.spsp(0, 1), sess, num_landmarks=4, sharers=8)
        assert not est_lo.pays and est_hi.pays
        assert est_lo.to_dict()["index_rows"] == 8 and est_lo.bytes_per_row > 0
        got.append((est_lo.to_dict(), est_hi.to_dict()))
    assert got[0] == got[1]


# ------------------------------------------------------------- refcounting
def test_midstream_register_deregister_refcounts_index():
    out = {}
    for pkg in PKGS:
        sess = session(pkg, engine="dense", optimize="always")
        h0 = sess.register(pkg.qp.spsp(0, 17))
        rule = sess._planner.rules[0]
        assert rule._live and len(sess._internal) == rule.num_landmarks
        sess.apply_updates(UPS[:8])
        h1 = sess.register(pkg.qp.spsp(5, 40))  # mid-stream admit shares the index
        assert len(sess._internal) == rule.num_landmarks  # not rebuilt
        sess.apply_updates(UPS[8:16])
        assert sess.deregister(h0) == 0  # index survives: one sharer left
        assert rule._live and rule.queries == {h1.qid: (5, 40)}
        sess.apply_updates(UPS[16:])
        answers = sess.answers(h1)
        assert answers[40] == reference_targets(UPS)[1]
        freed = sess.deregister(h1)  # last sharer → teardown
        assert freed > 0 and not rule._live
        assert sess._internal == set() and sess._plans == {}
        assert rule.rev_session is None
        out[pkg.name] = np.asarray(answers), freed, lmk(sess)
    np.testing.assert_array_equal(out["port"][0], out["ref"][0])
    assert out["port"][1:] == out["ref"][1:]


def test_internal_qids_hidden_from_public_views():
    out = {}
    for pkg in PKGS:
        sess = session(pkg, engine="dense", optimize="always")
        h = sess.register(pkg.qp.spsp(0, 17))
        assert sess.num_queries == 1
        assert [x.qid for x in sess.handles()] == [h.qid]
        assert set(sess.answers_snapshot()) == {h.qid}
        assert len(sess.nbytes_per_query()) == 1
        assert sess.stats()["query_qids"] == [h.qid]
        # internal rows are real engine citizens: bytes live under their qids
        per_op = sess._nbytes_per_op_map()
        assert sum(b for (q, _op), b in per_op.items() if q in sess._internal) > 0
        assert (pkg.planner.PLANNER_QID, pkg.planner.INDEX_OP) in per_op
        with pytest.raises(ValueError, match="internal"):
            sess.deregister(type(h)(qid=next(iter(sess._internal)), plan=h.plan))
        out[pkg.name] = sess, [h]
    same_sessions(out["port"][0], out["ref"][0], out["port"][1], out["ref"][1])
    np.testing.assert_array_equal(out["port"][0].answers_snapshot()[0], out["ref"][0].answers_snapshot()[0])


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_rewritten_query_rejects_engine_drop_policy(pkg):
    sess = session(pkg, engine="dense", optimize="always")
    h = sess.register(pkg.qp.spsp(0, 17))
    with pytest.raises(ValueError, match="planner rewrite"):
        sess.set_drop_policy(h, pkg.dr.DropConfig(mode="prob", p=0.5))


# ---------------------------------------------------------------- governor
def _calm_until_remat(sess, passes=8) -> int:
    """Empty batches drain the hysteresis cooldown; returns how many ran."""
    n = 0
    while n < passes and not sess.stats()["planner"]["landmark"]["remats_total"]:
        sess.apply_updates([])
        n += 1
    return n


def test_governor_sheds_and_rematerializes_index():
    out = {}
    for pkg in PKGS:
        sess = session(pkg, engine="dense", optimize="always", budget_bytes=1)
        handles = sess.register_many(spsp_plans(pkg))
        rule = sess._planner.rules[0]
        sess.apply_updates(UPS[:12])
        stats = lmk(sess)
        assert stats["shed"] and stats["sheds_total"] >= 1
        assert not rule._live and sess._internal == set()
        assert sess.stats()["bytes_shed_total"] > 0
        # shed answers stay exact (pruned scratch degrades to plain BF)
        np.testing.assert_array_equal(targets(sess, handles), reference_targets(UPS[:12]))
        shed = planner_stats(sess), sess.stats()["governor"]["levels"]
        # relief: calm passes under the raised budget re-materialize the index
        sess.governor.budget_bytes = 1 << 24
        sess.apply_updates(UPS[12:])
        calm = _calm_until_remat(sess)
        stats = lmk(sess)
        assert stats["remats_total"] >= 1 and stats["live"]
        np.testing.assert_array_equal(targets(sess, handles), reference_targets(UPS))
        out[pkg.name] = sess, handles, shed, calm
    (port, hp, shed_p, calm_p), (ref, hr, shed_r, calm_r) = out["port"], out["ref"]
    assert shed_p == shed_r and calm_p == calm_r
    same_sessions(port, ref, hp, hr)


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_scratch_session_index_never_governed(pkg):
    sess = session(pkg, engine="scratch", optimize="always", budget_bytes=1)
    sess.register_many(spsp_plans(pkg))
    sess.apply_updates(UPS[:8])
    # scratch rows account 0 bytes → the zero-byte filter never picks the
    # landmark pseudo-op (an index shed would reclaim nothing)
    stats = lmk(sess)
    assert stats["sheds_total"] == 0 and stats["live"]


def test_empty_batch_keeps_the_index_fields_where_the_reference_resets_them():
    """An empty batch on a live index: the targets still match SCRATCH on
    both sides, but the reference's dense sweep with nothing dirty returns
    D_0 (ROADMAP Queue 3), so its forward index fields read as init rows and
    its triangle bounds change; the port keeps the last fields.  The work
    meter differs by exactly that."""
    out = {}
    for pkg in PKGS:
        sess = session(pkg, engine="dense", optimize="always")
        handles = sess.register_many(spsp_plans(pkg))
        sess.apply_updates(UPS[:12])
        targets(sess, handles)
        work0 = lmk(sess)["pruned_work_total"]
        sess.apply_updates([])
        np.testing.assert_array_equal(targets(sess, handles), reference_targets(UPS[:12]))
        rule = sess._planner.rules[0]
        fwd = np.stack([sess._impl.answers_row(sess._handles[q]) for q in rule.fwd_qids])
        out[pkg.name] = lmk(sess)["pruned_work_total"] - work0, fwd, rule.landmarks
    (work_p, fwd_p, lms), (work_r, fwd_r, _) = out["port"], out["ref"]
    init = np.full_like(fwd_r, np.inf)
    init[np.arange(len(lms)), lms] = 0.0
    np.testing.assert_array_equal(fwd_r, init)  # the reference's reset
    assert np.isfinite(fwd_p).sum() > np.isfinite(fwd_r).sum()  # the port's kept fields
    assert work_p < work_r  # the kept bounds still prune


# --------------------------------------------------------------- durability
def test_checkpoint_restore_replay_parity(tmp_path):
    """Each package restores its own checkpoint and the other's; all four
    replay the rest of the stream to equal pruned fields."""
    live = {}
    for pkg in PKGS:
        sess = session(pkg, engine="dense", optimize="always")
        handles = sess.register_many(spsp_plans(pkg))
        sess.apply_updates(UPS[:12])
        sess.checkpoint(str(tmp_path / pkg.name))
        live[pkg.name] = sess, handles
    expect = reference_targets(UPS)
    runs = []
    for saver in PKGS:
        for loader in PKGS:
            restored = restore(loader, str(tmp_path / saver.name))
            sess, handles = live[loader.name]
            assert lmk(restored)["landmarks"] == lmk(sess)["landmarks"]
            assert lmk(restored)["queries"] == lmk(sess)["queries"]
            restored.apply_updates(UPS[12:])
            np.testing.assert_array_equal(targets(restored, handles), expect)
            runs.append((restored, handles))
    for sess, handles in live.values():
        sess.apply_updates(UPS[12:])
        np.testing.assert_array_equal(targets(sess, handles), expect)
    # full pruned fields match bit for bit, not just the targets
    (ref, hr), (port, hp) = live["ref"], live["port"]
    for restored, handles in runs:
        for h, h0 in zip(handles, hp):
            np.testing.assert_array_equal(np.asarray(restored.answers(h)), port.answers(h0))
    same_sessions(port, ref, hp, hr)
    same_sessions(runs[1][0], runs[0][0], hp, hr)  # the port and the reference on the reference's checkpoint


def test_restore_while_shed_then_rematerialize(tmp_path):
    out = {}
    for pkg in PKGS:
        sess = session(pkg, engine="dense", optimize="always", budget_bytes=1)
        handles = sess.register_many(spsp_plans(pkg))
        sess.apply_updates(UPS[:8])
        assert sess.stats()["planner"]["landmark"]["shed"]
        sess.checkpoint(str(tmp_path / pkg.name))
    for saver, loader in ((REF, PORT), (PORT, REF), (REF, REF)):
        restored = restore(loader, str(tmp_path / saver.name))
        stats = lmk(restored)
        assert stats["shed"] and not stats["live"]
        restored.governor.budget_bytes = 1 << 24
        restored.apply_updates(UPS[8:])
        calm = _calm_until_remat(restored)
        assert restored.stats()["planner"]["landmark"]["live"]
        np.testing.assert_array_equal(targets(restored, handles), reference_targets(UPS))
        out[(saver.name, loader.name)] = restored, calm
    port, calm_p = out[("ref", "port")]
    ref, calm_r = out[("ref", "ref")]
    assert calm_p == calm_r
    same_sessions(port, ref, port.handles(), ref.handles())
    assert planner_stats(out[("port", "ref")][0]) == planner_stats(port)


def test_planner_metrics_published():
    from repro.obs.metrics import MetricsRegistry as RRegistry
    from repro_torch.obs.metrics import MetricsRegistry as TRegistry

    snaps = {}
    for pkg, registry in ((REF, RRegistry), (PORT, TRegistry)):
        sess = session(pkg, engine="dense", optimize="always")
        sess.register_many(spsp_plans(pkg))
        sess.apply_updates(UPS[:8])
        snaps[pkg.name] = sess.publish_metrics(registry()).snapshot()
    assert {"cqp_planner_rewrites_total", "cqp_landmark_index_nbytes"} <= set(snaps["port"])
    planner_keys = {k for k in snaps["ref"] if k.startswith(("cqp_planner", "cqp_landmark"))}
    assert planner_keys and {k: snaps["port"][k] for k in planner_keys} == {k: snaps["ref"][k] for k in planner_keys}


# --------------------------------------------------------------- provenance
def test_provenance_roundtrip_json():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    keys = st.text(alphabet="abcdefghijklmnopqrstuvwxyz_", min_size=1, max_size=8)
    vals = st.one_of(st.integers(-(2**31), 2**31), st.text(max_size=12), st.booleans())

    @settings(max_examples=40, deadline=None)
    @given(rule=keys, kind=st.sampled_from(["spsp", "sssp", "khop"]),
           params=st.dictionaries(keys, vals, max_size=4))
    def check(rule, kind, params):
        prov = tplan.Provenance(rule=rule, original_kind=kind, params=tuple(params.items()))
        plan = tplan.spsp(1, 2).with_provenance(prov)
        back = tplan.QueryPlan.from_json(plan.to_json())
        assert back.provenance == plan.provenance
        assert back.provenance[-1].params == tuple(sorted(params.items()))
        assert tplan.Provenance.from_dict(prov.to_dict()) == prov
        # the JSON crosses to the reference and back unchanged
        assert rplan.QueryPlan.from_json(plan.to_json()).to_json() == plan.to_json()

    check()


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_rewrite_stamps_provenance(pkg):
    sess = session(pkg, engine="scratch", optimize="always")
    h = sess.register(pkg.qp.spsp(4, 31))
    (prov,) = h.plan.provenance
    assert prov.rule == "landmark" and prov.original_kind == "spsp"
    assert dict(prov.params)["source"] == 4
    assert dict(prov.params)["target"] == 31
    # the session's stored plan is the rewritten one (checkpoint carries it)
    assert sess._plans[h.qid].provenance == h.plan.provenance


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_planner_rejects_unknown_mode(pkg):
    with pytest.raises(ValueError, match="optimize"):
        session(pkg, optimize="sometimes")
    sess = session(pkg, engine="host")
    with pytest.raises(ValueError, match="optimize"):
        sess.register(pkg.qp.spsp(0, 1), optimize="sometimes")
    with pytest.raises(ValueError):
        pkg.planner.Planner(sess, "sometimes")


# ----------------------------------------------------------------- fig9 smoke
def test_fig9_smoke_cell_work_cut():
    """fig9's smoke cell (``paper_workload(v=96, e=384, num_batches=4)``, 12
    SPSP queries, L = 3): the port's pruned work equals the reference's to
    the unit, the targets equal un-pruned SCRATCH, and the cut against
    ``iters × Q × V`` is at least 40%."""
    from benchmarks.common import paper_workload

    v, num_q, num_l = 96, 12, 3
    initial, stream = paper_workload(v=v, e=384, num_batches=4)
    rng = np.random.default_rng(7)
    queries = [(int(rng.integers(v)), int(rng.integers(v))) for _ in range(num_q)]
    cap = len(initial) * 4 + 64
    work, answers = {}, {}
    for pkg in PKGS:
        plans = [pkg.qp.spsp(s, t, max_iters=48) for s, t in queries]
        base = pkg.S(pkg.G(v, initial, capacity=cap), engine="scratch", **pkg.kw)
        bh = base.register_many(plans)
        base_work = int(base.last_stats.iters_run) * num_q * v
        opt = pkg.S(pkg.G(v, initial, capacity=cap), engine="dense", optimize="always", **pkg.kw)
        opt._planner = pkg.planner.Planner(opt, "always", rules=[pkg.planner.LandmarkRule(num_l)])
        oh = opt.register_many(plans)
        opt.answers(oh[0])  # registration read (one pruned sweep)
        for batch in stream:
            base_work += int(base.apply_updates(batch).iters_run) * num_q * v
            opt.apply_updates(batch)
            opt.answers(oh[0])  # one pruned sweep a batch
        d_base = np.array([base.answers(h)[t] for h, (_, t) in zip(bh, queries)])
        d_opt = np.array([opt.answers(h)[t] for h, (_, t) in zip(oh, queries)])
        np.testing.assert_array_equal(d_opt, d_base)
        work[pkg.name] = base_work, lmk(opt)["pruned_work_total"]
        answers[pkg.name] = d_opt
    assert work["port"] == work["ref"]
    np.testing.assert_array_equal(answers["port"], answers["ref"])
    base_work, opt_work = work["port"]
    assert 1.0 - opt_work / base_work >= 0.40
