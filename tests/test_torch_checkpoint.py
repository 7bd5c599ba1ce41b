"""Port parity: the checkpoint store and ``CQPSession`` checkpoint/restore.

The store writes the reference's format (``step_XXXXXXXX/``,
``manifest.json``, ``shard_0.npz`` with ``/`` as ``__``, the ``.tmp``
rename), so a checkpoint written by either package loads in the other.
Sessions: the same seeded streams go through the reference's uninterrupted
``repro.core.session.CQPSession`` (its Pallas kernels in interpret mode) and
through the port (``device="cpu"``) checkpointed mid-stream, mutated
further (the progress a crash destroys), dropped, restored from disk and
replayed — the restored answers must equal the uninterrupted run bit for
bit (min family), and so must the byte accounting.  The reference's
hypothesis property over random streams runs as a seeded loop in one
process.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro.checkpoint import store as rstore
from repro.core import dropping as rdr
from repro.core import plan as rplan
from repro.core.graph import DynamicGraph as RGraph
from repro.core.session import CQPSession as RSession
from repro_torch.checkpoint import store as tstore
from repro_torch.core import dropping as tdr
from repro_torch.core import plan as tplan
from repro_torch.core.graph import DynamicGraph as TGraph
from repro_torch.core.session import CQPSession as TSession
from repro_torch.launch.mesh import Sharding, make_data_mesh

V = 16
CPU = "cpu"
MAX_ITERS = 16


# ------------------------------------------------------------------- store
def _tree():
    return {
        "w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": {"b": np.ones((5,), np.int32), "seq": [np.zeros(2), (torch.ones(1, dtype=torch.int64),)]},
    }


def _zeros_like(tree):
    return {
        "w": torch.zeros(3, 4),
        "nested": {"b": np.zeros((5,), np.int32),
                   "seq": [np.ones(2), (torch.zeros(1, dtype=torch.int64),)]},
    }


def test_store_roundtrip_keys_and_types(tmp_path):
    """Tensor and array leaves round-trip under the reference's key strings;
    a tensor target leaf comes back as a tensor."""
    d = str(tmp_path)
    tstore.save_checkpoint(d, 7, _tree())
    got, step = tstore.restore_checkpoint(d, _zeros_like(_tree()))
    assert step == 7
    want = _tree()
    assert isinstance(got["w"], torch.Tensor) and isinstance(got["nested"]["b"], np.ndarray)
    torch.testing.assert_close(got["w"], want["w"], rtol=0, atol=0)
    np.testing.assert_array_equal(got["nested"]["b"], want["nested"]["b"])
    assert got["nested"]["seq"][1][0].dtype == torch.int64
    arrays, manifest, _ = tstore.load_checkpoint(d)
    assert set(manifest["leaves"]) == {"w", "nested/b", "nested/seq/0", "nested/seq/1/0"}
    assert manifest["leaves"]["w"] == {"shape": [3, 4], "dtype": "float32"}


def test_store_atomic_no_tmp_left(tmp_path):
    d = str(tmp_path)
    tstore.save_checkpoint(d, 1, _tree())
    tstore.save_checkpoint(d, 2, _tree())
    assert not any(e.endswith(".tmp") for e in os.listdir(d))
    assert tstore.latest_step(d) == 2


def test_manager_keep_n_and_async_writes_never_overlap(tmp_path, monkeypatch):
    """Keep-N GC under async writes; a save waits for the in-flight write,
    so at most one runs at a time; each save's wait and each write's time
    are recorded; stale ``.tmp`` dirs are swept."""
    live = {"n": 0, "max": 0}
    real = tstore.save_checkpoint

    def tracked(directory, step, tree, **kw):
        live["n"] += 1
        live["max"] = max(live["max"], live["n"])
        try:
            return real(directory, step, tree, **kw)
        finally:
            live["n"] -= 1

    monkeypatch.setattr(tstore, "save_checkpoint", tracked)
    os.makedirs(tmp_path / "step_00000000.tmp")
    m = tstore.CheckpointManager(str(tmp_path), keep=2, async_write=True)
    for s in range(1, 6):
        m.save(s, _tree())
    m.wait()
    assert live["max"] == 1
    assert sorted(os.listdir(str(tmp_path))) == ["step_00000004", "step_00000005"]
    assert len(m.wait_s) == 5 and len(m.write_s) == 5


def test_manager_snapshots_a_tensor_before_the_writer_runs(tmp_path):
    """A tensor leaf edited in place right after ``save`` returns must not
    reach the checkpoint (the host copy is taken synchronously)."""
    x = torch.zeros(1000)
    m = tstore.CheckpointManager(str(tmp_path), keep=1, async_write=True)
    m.save(1, {"x": x})
    x.fill_(7.0)
    m.wait()
    arrays, _, _ = tstore.load_checkpoint(str(tmp_path))
    assert not arrays["x"].any()


def test_restore_validates_manifest(tmp_path):
    d = str(tmp_path)
    tstore.save_checkpoint(d, 3, _tree())
    bad_shape = _zeros_like(_tree())
    bad_shape["w"] = torch.zeros(2, 2)
    with pytest.raises(ValueError, match="shape"):
        tstore.restore_checkpoint(d, bad_shape)
    bad_dtype = _zeros_like(_tree())
    bad_dtype["nested"]["b"] = np.zeros((5,), np.float32)
    with pytest.raises(ValueError, match="dtype"):
        tstore.restore_checkpoint(d, bad_dtype)
    with pytest.raises(ValueError, match="extra"):
        tstore.restore_checkpoint(d, {"extra": np.zeros(1), **_zeros_like(_tree())})
    with pytest.raises(ValueError, match="Sharding at every leaf"):
        tstore.restore_checkpoint(d, _zeros_like(_tree()), shardings={})
    # shardings place every leaf on a 2-shard CPU mesh: split along an axis, or replicated
    mesh = make_data_mesh(2, device=CPU, emulate=True)
    rep = Sharding(mesh)
    specs = {"w": Sharding(mesh, 1), "nested": {"b": rep, "seq": [Sharding(mesh, 0), (rep,)]}}
    placed, _ = tstore.restore_checkpoint(d, _zeros_like(_tree()), shardings=specs)
    want = _tree()
    assert [p.tolist() for p in placed["w"]] == [want["w"][:, :2].tolist(), want["w"][:, 2:].tolist()]
    assert len(placed["nested"]["b"]) == 2
    assert all(np.array_equal(p.numpy(), want["nested"]["b"]) for p in placed["nested"]["b"])
    assert [p.tolist() for p in placed["nested"]["seq"][0]] == [[0.0], [0.0]]
    assert [p.tolist() for p in placed["nested"]["seq"][1][0]] == [[1], [1]]
    with pytest.raises(FileNotFoundError):
        tstore.load_checkpoint(str(tmp_path / "empty"))


def test_load_checkpoint_meta_roundtrip(tmp_path):
    d = str(tmp_path)
    tstore.save_checkpoint(d, 11, _tree(), meta={"next_chunk": 4, "note": "hi"})
    arrays, manifest, step = tstore.load_checkpoint(d)
    assert step == 11 and manifest["meta"] == {"next_chunk": 4, "note": "hi"}
    np.testing.assert_array_equal(arrays["w"], _tree()["w"].numpy())


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_store_checkpoints_load_across_packages(writer, tmp_path):
    """A checkpoint of either package loads in the other: equal manifests
    and arrays, and ``restore_checkpoint`` into the other's target tree."""
    d = str(tmp_path)
    host = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
            "nested": {"b": np.ones((5,), np.int32), "seq": [np.zeros(2), (np.arange(3),)]}}
    save, load = ((rstore.save_checkpoint, tstore.load_checkpoint) if writer == "reference"
                  else (tstore.save_checkpoint, rstore.load_checkpoint))
    save(d, 5, host, meta={"k": [1, 2]})
    arrays, manifest, step = load(d)
    other = (rstore if writer == "port" else tstore).load_checkpoint
    want_arrays, want_manifest, _ = other(d)
    assert manifest == want_manifest and step == 5
    for key, arr in want_arrays.items():
        assert arrays[key].dtype == arr.dtype
        np.testing.assert_array_equal(arrays[key], arr)
    restore = (tstore if writer == "reference" else rstore).restore_checkpoint
    got, _ = restore(d, {"w": np.zeros((3, 4), np.float32),
                         "nested": {"b": np.zeros(5, np.int32), "seq": [np.ones(2), (np.zeros(3, int),)]}})
    np.testing.assert_array_equal(got["nested"]["seq"][1][0], np.arange(3))


# ------------------------------------------------------------------ session
def workload(seed: int = 5, label: int = 0, steps: int = 12):
    """(initial edges, update log) over one edge label (the reference
    suite's ``tests/test_checkpoint_recovery.py`` generator)."""
    rng = np.random.default_rng(seed)
    seen = {}
    while len(seen) < 40:
        u, w = int(rng.integers(0, V)), int(rng.integers(0, V))
        if u != w:
            seen[(u, w)] = (u, w, float(rng.integers(1, 9)), label)
    edges = list(seen.values())
    initial, pool = edges[:30], edges[30:]
    present = {(u, w) for (u, w, _x, _l) in initial}
    log = []
    for _ in range(steps):
        if present and rng.random() < 0.35:
            u, w = sorted(present)[int(rng.integers(0, len(present)))]
            log.append((u, w, label, 1.0, -1))
            present.discard((u, w))
        elif pool:
            u, w, x, lbl = pool.pop()
            log.append((u, w, lbl, x, +1))
            present.add((u, w))
    return initial, log


def labeled_workload(seed: int = 9):
    """A cycle over labels {1, 2} plus a mixed-label update log (for RPQ)."""
    initial = [(i, (i + 1) % V, 1.0, 1 + (i % 2)) for i in range(V)]
    rng = np.random.default_rng(seed)
    log = []
    for t in range(10):
        u, w = int(rng.integers(0, V)), int(rng.integers(0, V))
        if u != w:
            log.append((u, w, 1 + (t % 2), 1.0, +1))
    log.append((0, 1, 1, 1.0, -1))  # delete a cycle edge mid-stream
    return initial, log


def _plans(plan_mod, dr_mod, policy):
    if policy == "join-drop":
        nfa = plan_mod.NFA.concat_star(1, 2)
        return [
            plan_mod.rpq(0, nfa, max_iters=MAX_ITERS, join_store="materialize"),
            plan_mod.rpq(4, nfa, max_iters=MAX_ITERS, join_store="drop"),
        ]
    drop = (dr_mod.DropConfig(mode="prob", selection="random", p=0.4, seed=7, bloom_bits=1 << 12)
            if policy == "prob" else None)
    return [plan_mod.sssp(0, max_iters=MAX_ITERS, drop=drop), plan_mod.sssp(7, max_iters=MAX_ITERS)]


def _ref(initial, engine, **kw):
    return RSession(RGraph(V, initial, capacity=256), engine=engine, **kw)


def _port(initial, engine, **kw):
    return TSession(TGraph(V, initial, capacity=256), engine=engine, device=CPU, **kw)


# the reference suite's one-shard cells (its tests/test_checkpoint_recovery.py
# CELLS, pruned the same way), the dense ones on coo and fused
CELLS = [
    pytest.param(engine, backend, policy, id=f"{engine}-{backend}-{policy}")
    for engine in ("dense", "host", "scratch")
    for backend in (("coo", "fused") if engine == "dense" else ("coo",))
    for policy in ("none", "prob", "join-drop")
    if not (engine != "dense" and policy == "join-drop")
    if not (engine == "scratch" and policy != "none")
]


@pytest.mark.parametrize("engine,backend,policy", CELLS)
def test_restore_and_replay_equal_the_reference_uninterrupted_run(engine, backend, policy, tmp_path):
    """checkpoint → crash → restore → replay the suffix, on the port, equal
    to the reference's run that never crashed: answers, bytes, qids."""
    initial, log = labeled_workload() if policy == "join-drop" else workload()
    cut = len(log) // 2
    ref = _ref(initial, engine)
    rh = ref.register_many(_plans(rplan, rdr, policy))
    ref.apply_updates(log)

    s = _port(initial, engine, backend=backend)
    sh = s.register_many(_plans(tplan, tdr, policy))
    s.apply_updates(log[:cut])
    s.checkpoint(str(tmp_path))
    s.apply_updates(log[cut:])  # progress the crash destroys
    crashed = [s.answers(h) for h in sh]
    del s

    r = TSession.restore(str(tmp_path), device=CPU)
    assert r.restore_info["step"] == r.updates_applied
    assert set(r.restore_info["timings"]) == {"load_s", "graph_s", "engine_s", "import_s"}
    rhandles = r.handles()
    assert [h.qid for h in rhandles] == [h.qid for h in rh]
    r.apply_updates(log[cut:])
    for h_ref, h_r, crash in zip(rh, rhandles, crashed):
        want = ref.answers(h_ref)
        np.testing.assert_array_equal(r.answers(h_r), want)
        np.testing.assert_array_equal(crash, want)
    assert r.nbytes() == ref.nbytes()
    assert r.nbytes_per_operator() == ref.nbytes_per_operator()
    assert r.updates_applied == ref.updates_applied


def _leaf_equal(a: RSession | TSession, b: RSession | TSession) -> None:
    (aa, am), (ba, bm) = a.state_dict(), b.state_dict()
    assert set(aa) == set(ba)
    for k in aa:
        x, y = np.asarray(aa[k]), np.asarray(ba[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert json.loads(json.dumps(am)) == json.loads(json.dumps(bm))


@pytest.mark.parametrize("engine,backend,drop", [("dense", "fused", "det"), ("host", "coo", None)])
def test_checkpoints_restore_across_packages(engine, backend, drop, tmp_path):
    """The reference restores a port checkpoint and the port restores a
    reference checkpoint; after one more chunk every session — both
    originals and both cross restores — is leaf-equal (arrays, dtypes and
    meta of ``state_dict``)."""
    initial, log = workload(seed=6)
    cut = len(log) // 2
    rkw = dict(backend=backend, drop=None if drop is None else rdr.DropConfig(mode=drop))
    tkw = dict(backend=backend, drop=None if drop is None else tdr.DropConfig(mode=drop))
    ref, port = _ref(initial, engine, **rkw), _port(initial, engine, **tkw)

    def plans(mod, dmod):
        pol = dmod.DropConfig(mode=drop, p=0.5, seed=3) if drop else dmod.DropConfig()
        return [mod.sssp(s, max_iters=MAX_ITERS, drop=pol) for s in (0, 5)]

    ref.register_many(plans(rplan, rdr))
    port.register_many(plans(tplan, tdr))
    ref.apply_updates(log[:cut])
    port.apply_updates(log[:cut])
    _leaf_equal(ref, port)
    ref.checkpoint(str(tmp_path / "ref"), extra={"next_chunk": 1})
    port.checkpoint(str(tmp_path / "port"), extra={"next_chunk": 1})
    port_from_ref = TSession.restore(str(tmp_path / "ref"), device=CPU)
    ref_from_port = RSession.restore(str(tmp_path / "port"))
    assert port_from_ref.restore_info["extra"] == ref_from_port.restore_info["extra"] == {"next_chunk": 1}
    for s in (ref, port, port_from_ref, ref_from_port):
        s.apply_updates_batched(log[cut:])
    _leaf_equal(ref, port)
    _leaf_equal(ref, port_from_ref)
    _leaf_equal(ref, ref_from_port)


@pytest.mark.parametrize("engine", ["dense", "host", "scratch"])
def test_churn_between_checkpoint_and_crash(engine, tmp_path):
    """register/deregister after the checkpoint are lost in the crash; the
    replay re-issues them and ends equal to the reference's run."""
    initial, log = workload()
    cut = len(log) // 2

    def churn_and_finish(sess, handles, plan_mod):
        handles = list(handles)
        handles.append(sess.register(plan_mod.sssp(3, max_iters=MAX_ITERS)))
        sess.deregister(handles.pop(0))  # retire the oldest query
        sess.apply_updates(log[cut:])
        return handles

    ref = _ref(initial, engine)
    rh = ref.register_many(_plans(rplan, rdr, "none"))
    ref.apply_updates(log[:cut])
    rh = churn_and_finish(ref, rh, rplan)

    s = _port(initial, engine)
    sh = s.register_many(_plans(tplan, tdr, "none"))
    s.apply_updates(log[:cut])
    s.checkpoint(str(tmp_path))
    churn_and_finish(s, sh, tplan)  # lost in the crash
    del s

    r = TSession.restore(str(tmp_path), device=CPU)
    rhand = churn_and_finish(r, r.handles(), tplan)
    assert [h.qid for h in rhand] == [h.qid for h in rh]
    for h_ref, h_r in zip(rh, rhand):
        np.testing.assert_array_equal(r.answers(h_r), ref.answers(h_ref))
    assert r.nbytes_per_operator() == ref.nbytes_per_operator()


def test_governor_escalations_survive_restore(tmp_path):
    """A budget-governed session checkpointed mid-escalation: the restored
    governor continues from the saved levels and EWMAs and lands where the
    reference's uninterrupted run does (levels, actions, bytes, answers)."""
    edges = [(i, (i + 1) % V, 1.0) for i in range(V)]
    log = [((3 * k) % V, (5 * k + 1) % V, 0, 1.0, +1) for k in range(10)
           if (3 * k) % V != (5 * k + 1) % V]

    def build(cls, graph_cls, plan_mod, budget, **kw):
        s = cls(graph_cls(V, edges, capacity=128), engine="dense", budget_bytes=budget, **kw)
        s.register_many([plan_mod.sssp(i, max_iters=16) for i in range(3)])
        return s

    probe = build(TSession, TGraph, tplan, 10**9, device=CPU)
    for u in log[:5]:
        probe.apply_updates([u])
    budget = int(probe.nbytes() * 0.6)  # forces escalations before the cut

    ref = build(RSession, RGraph, rplan, budget)
    for u in log:
        ref.apply_updates([u])
    s = build(TSession, TGraph, tplan, budget, device=CPU)
    for u in log[:5]:
        s.apply_updates([u])
    assert any(v > 0 for v in s.governor._levels.values())
    s.checkpoint(str(tmp_path))
    del s
    r = TSession.restore(str(tmp_path), device=CPU)
    for u in log[5:]:
        r.apply_updates([u])
    for h_ref, h_r in zip(ref.handles(), r.handles()):
        np.testing.assert_array_equal(r.answers(h_r), ref.answers(h_ref))
    assert r.nbytes() == ref.nbytes()
    assert r.governor._levels == ref.governor._levels
    assert [a.to_dict() for a in r.governor.actions] == [a.to_dict() for a in ref.governor.actions]


def test_restore_refuses_bad_meta(tmp_path):
    """A foreign checkpoint (no session meta), an unknown format, a bad
    reference knob and a ``mesh=`` that is not a DataMesh are refused by
    name (a 2-shard CPU mesh restores); plan-optimizer state restores."""
    tstore.save_checkpoint(str(tmp_path / "foreign"), 0, {"x": np.zeros(3)})
    with pytest.raises(ValueError, match="no session meta"):
        TSession.restore(str(tmp_path / "foreign"), device=CPU)
    initial, log = workload()
    s = _port(initial, "dense")
    s.register(tplan.sssp(0, max_iters=MAX_ITERS))
    arrays, meta = s.state_dict()
    assert list(meta["kw"]) == ["mode", "backend", "store_capacity", "jstore_capacity",
                                "ell_block_v", "interpret", "batch_capacity", "min_slots"]
    assert meta["kw"]["ell_block_v"] == 128 and meta["kw"]["interpret"] is None
    assert "device" not in json.dumps(meta)
    for bad, err, match in [
        ({"format": 2}, ValueError, "format"),
        ({"kw": {**meta["kw"], "ell_block_v": 0}}, ValueError, "ell_block_v"),
        ({"kw": {**meta["kw"], "interpret": "yes"}}, ValueError, "interpret"),
    ]:
        with pytest.raises(err, match=match):
            TSession._from_state(arrays, {**meta, **bad}, device=CPU)
    ok = TSession._from_state(arrays, {**meta, "kw": {**meta["kw"], "ell_block_v": 64, "interpret": True}},
                              device=CPU)
    assert ok.num_queries == 1
    planned = TSession._from_state(arrays, {**meta, "optimize": "auto", "planner": {
        "mode": "always", "rewrites_total": 3, "owned": {}, "rules": {}}}, device=CPU)
    assert planned._planner.mode == "always" and planned._planner.rewrites_total == 3
    assert planned.num_queries == 1 and planned._internal == set()
    with pytest.raises(ValueError, match="live plans but no engine"):
        TSession._from_state(arrays, {**meta, "engine_state": False}, device=CPU)
    s.checkpoint(str(tmp_path / "ok"))
    with pytest.raises(TypeError, match="DataMesh"):
        TSession.restore(str(tmp_path / "ok"), mesh=object(), device=CPU)
    on_mesh = TSession.restore(str(tmp_path / "ok"), mesh=make_data_mesh(2, device=CPU, emulate=True))
    assert on_mesh.num_shards == 2 and on_mesh.num_queries == 1


# the reference's hypothesis property shrank to this stream (V = 16, source
# 0, cut 7: checkpointed after every op, nothing replayed)
SHRUNK = ([(0, 14, 4.0)],
          [(1, 0, 0, 1.0, +1), (0, 15, 0, 1.0, +1), (0, 14, 0, 1.0, -1), (0, 14, 0, 1.0, +1),
           (0, 14, 0, 1.0, -1), (0, 15, 0, 1.0, +1), (0, 14, 0, 1.0, +1)],
          7, 0)


def random_stream(rng):
    """One draw of the reference property's strategy: 6–24 edges, 2–10
    inserts/deletes (duplicate inserts allowed), a cut, a source."""
    edges = [(int(u), int(w), float(x)) for u, w, x in
             zip(rng.integers(0, V, 24), rng.integers(0, V, 24), rng.integers(1, 10, 24))][: int(rng.integers(6, 25))]
    edges = list({(u, w): (u, w, x) for (u, w, x) in edges if u != w}.values())
    present = {(u, w) for (u, w, _x) in edges}
    ops = []
    for _ in range(int(rng.integers(2, 11))):
        if present and rng.random() < 0.5:
            u, w = sorted(present)[int(rng.integers(0, len(present)))]
            ops.append((u, w, 0, 1.0, -1))
            present.discard((u, w))
        else:
            u, w = int(rng.integers(0, V)), int(rng.integers(0, V))
            if u == w:
                continue
            ops.append((u, w, 0, float(rng.integers(1, 10)), +1))
            present.add((u, w))
    return edges, ops, int(rng.integers(0, len(ops) + 1)), int(rng.integers(0, V))


def test_random_streams_restore_to_the_uninterrupted_run(tmp_path):
    """The reference's property test as a seeded loop in one process, the
    stream it shrank to among the examples (third, not first): for each
    stream and engine, checkpoint at the cut, restore, replay — equal to the
    reference's uninterrupted run, and the per-operator byte sums too."""
    rng = np.random.default_rng(2022)
    streams = [random_stream(rng) for _ in range(6)]
    streams.insert(2, SHRUNK)
    for n, (edges, ops, cut, src) in enumerate(streams):
        refs = {}
        for engine in ("dense", "host"):
            ref = refs[engine] = _ref(edges, engine)
            ref.register(rplan.sssp(src, max_iters=MAX_ITERS))
            ref.apply_updates(ops)
        for engine, backend in (("dense", "coo"), ("dense", "fused"), ("host", "coo")):
            ref = refs[engine]
            (h_ref,) = ref.handles()
            s = _port(edges, engine, backend=backend)
            s.register(tplan.sssp(src, max_iters=MAX_ITERS))
            s.apply_updates(ops[:cut])
            d = str(tmp_path / f"case{n}-{engine}-{backend}")
            s.checkpoint(d)
            del s
            r = TSession.restore(d, device=CPU)
            r.apply_updates(ops[cut:])
            (h_r,) = r.handles()
            np.testing.assert_array_equal(r.answers(h_r), ref.answers(h_ref), err_msg=f"stream {n} {engine}")
            assert ([sum(o.values()) for o in r.nbytes_per_operator()]
                    == [sum(o.values()) for o in ref.nbytes_per_operator()])


@pytest.mark.parametrize("backend", ["coo", "fused"])
def test_empty_batch_keeps_the_answers_where_the_reference_resets_them(backend):
    """The cause of the reference property's failure: a dense sweep with
    nothing dirty runs no iteration, and the reference then returns the
    loop carry's ``cur``, which is D_0 — ``apply_updates([])`` resets every
    answer to its init row (the shrunk stream replays ``ops[7:] == []``).
    The port keeps the last sweep's answers, as the uninterrupted run and
    the host engine do (ROADMAP Queue 3)."""
    edges, ops, _cut, src = SHRUNK
    ref = _ref(edges, "dense")
    rh = ref.register(rplan.sssp(src, max_iters=MAX_ITERS))
    port = _port(edges, "dense", backend=backend)
    th = port.register(tplan.sssp(src, max_iters=MAX_ITERS))
    ref.apply_updates(ops)
    port.apply_updates(ops)
    want = ref.answers(rh)
    np.testing.assert_array_equal(port.answers(th), want)
    assert np.isfinite(want[[14, 15]]).all()
    ref.apply_updates([])
    port.apply_updates([])
    np.testing.assert_array_equal(port.answers(th), want)
    np.testing.assert_array_equal(ref.answers(rh), rplan.sssp(src).build_init(V))
    assert int(port.last_stats.iters_run) == 0


def test_snapshots_and_state_dicts_are_owned_host_copies():
    """On the CPU ``tensor.numpy()`` would alias the engine's state, which
    the fused sweep and the slot edits write in place: every
    ``answers_snapshot`` row and ``state_dict`` array must stay as it was
    taken while the session goes on."""
    initial, log = workload()
    s = _port(initial, "dense", backend="fused", drop=tdr.DropConfig(mode="det"))
    hs = s.register_many([tplan.sssp(q, max_iters=MAX_ITERS, drop=tdr.DropConfig(mode="det", p=0.5, seed=1))
                          for q in (0, 7)])
    s.apply_updates(log[:6])
    snap, (arrays, _meta) = s.answers_snapshot(), s.state_dict()
    kept = ({q: a.copy() for q, a in snap.items()}, {k: np.array(a, copy=True) for k, a in arrays.items()})
    s.apply_updates(log[6:])
    s.deregister(hs[0])
    s.register(tplan.sssp(3, max_iters=MAX_ITERS))
    assert any(not np.array_equal(s.answers(h), kept[0][h.qid]) for h in s.handles() if h.qid in kept[0])
    for q, a in snap.items():
        np.testing.assert_array_equal(a, kept[0][q])
    for k, a in arrays.items():
        np.testing.assert_array_equal(a, kept[1][k], err_msg=k)
