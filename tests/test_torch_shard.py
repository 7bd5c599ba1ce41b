"""Port parity: the vertex-sharded sweep (DESIGN.md §8) on an emulated CPU mesh.

The port's sharded engine — 2 and 4 shards of ``make_data_mesh(n,
device="cpu", emulate=True)`` — is held against the reference's UNSHARDED
engine on the same numpy-seeded inputs: the reference's own suite holds its
sharded sweep equal to its unsharded one (``tests/test_shard_parity.py``),
so no emulated JAX devices are needed here.  For the min family the
answers, the global D store, the DroppedVT (Det rows or Bloom bits), the
selection rows and every ``MaintainStats`` field are equal bit for bit;
PageRank's answers at ``rtol=1e-6``.

VDC's J store lives in the :class:`ShardIndex` cell layout: a reinserted
edge takes a free cell of its destination's shard, not the graph's free
slot, so the J rows it inherits (and ``jwritten``, the J writes counted
against them) may differ from the unsharded run's.  For VDC the answers,
the D store and every other stat are held equal.

The ``ShardIndex`` itself (built with a stable sort where the reference
loops over the edges) equals the reference's cell for cell.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import dropping as rdr
from repro.core import engine as reng
from repro.core import queries as rq
from repro.core.graph import DynamicGraph as RGraph
from repro.core.graph import ShardIndex as RShardIndex
from repro.core.graph import ShardOverflow as RShardOverflow
from repro_torch.core import convert
from repro_torch.core import dropping as tdr
from repro_torch.core import engine as teng
from repro_torch.core import queries as tq
from repro_torch.core.graph import DynamicGraph as TGraph
from repro_torch.core.graph import ShardIndex, ShardOverflow
from repro_torch.kernels import fused_sweep as K2
from repro_torch.launch.mesh import DataMesh, make_data_mesh
from test_torch_engine import _same_stats, _symmetric, random_workload
from test_torch_fused import _all_ref_leaves, _drop_kw
from test_torch_fused_sweep import FLOAT_OUTS, MODES, _inputs, _port_call, _reference

V = 24
CPU = "cpu"
MAX_ITERS = 24


def mesh(n):
    return make_data_mesh(n, device=CPU, emulate=True)


# ------------------------------------------------------------------ ShardIndex
def _same_index(port: ShardIndex, ref: RShardIndex):
    assert port.shard_capacity == ref.shard_capacity
    assert {s: int(c) for s, c in enumerate(port.cell_of) if c >= 0} == ref.cell_of
    assert port.dead == ref.dead
    assert port.fill.tolist() == ref.fill.tolist()
    assert {k: v for k, v in port.free.items() if v} == {k: v for k, v in ref.free.items() if v}


def _churn_graphs(seed, v=V, capacity=128):
    """(reference graph, port graph, resolved-op batches): a stream whose
    deletions free slots (and cells) that later inserts take again."""
    initial, batches = random_workload(seed, v=v, num_batches=6)
    rg, tg = RGraph(v, initial, capacity=capacity), TGraph(v, initial, capacity=capacity)
    return rg, tg, batches


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("seed", [3, 11])
def test_shard_index_matches_reference(seed, shards):
    """cell_of, writes_for, edge_arrays, the free lists and the dead cells
    after every batch of a seeded stream."""
    rg, tg, batches = _churn_graphs(seed)
    ref, port = RShardIndex(rg.snapshot(), shards), ShardIndex(tg.snapshot(), shards)
    _same_index(port, ref)
    reused = 0
    for batch in batches:
        rops, tops = rg.apply_batch_resolved(batch), tg.apply_batch_resolved(batch)
        assert rops == tops
        free_before = sum(len(x) for x in port.free.values())
        got, want = port.writes_for(tops), ref.writes_for(rops)
        assert [dataclasses.astuple(w) for w in got] == [dataclasses.astuple(w) for w in want]
        reused += free_before > sum(len(x) for x in port.free.values())
        _same_index(port, ref)
        for a, b in zip(port.edge_arrays(tg.snapshot()), ref.edge_arrays(rg.snapshot())):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    assert reused  # the stream takes freed cells again


def test_shard_overflow_raises_at_the_references_op():
    """An insert past a shard's cells raises in both packages at the same
    op; the index regrown at twice the capacity equals the reference's."""
    v = 16
    initial = [(i, (i + 1) % v, 1.0) for i in range(v)]
    rg, tg = RGraph(v, initial, capacity=64), TGraph(v, initial, capacity=64)
    ref, port = RShardIndex(rg.snapshot(), 4), ShardIndex(tg.snapshot(), 4)
    hub = [(i, 3, 0, 1.0, +1) for i in range(v) if i not in (2, 3)]  # all into shard 0
    for k, u in enumerate(hub):
        rops, tops = rg.apply_batch_resolved([u]), tg.apply_batch_resolved([u])
        try:
            want = ref.writes_for(rops)
        except RShardOverflow:
            with pytest.raises(ShardOverflow):
                port.writes_for(tops)
            break
        assert [dataclasses.astuple(w) for w in port.writes_for(tops)] == [dataclasses.astuple(w) for w in want]
    else:
        pytest.fail("the hub stream never overflowed shard 0")
    ref2 = RShardIndex(rg.snapshot(), 4, min_capacity=ref.shard_capacity * 2)
    port2 = ShardIndex(tg.snapshot(), 4, min_capacity=port.shard_capacity * 2)
    _same_index(port2, ref2)
    assert port2.shard_capacity > port.shard_capacity


@pytest.mark.parametrize("shards", [2, 3, 4])
def test_vectorised_build_equals_reference_cell_of_after_deletions_and_reuse(shards):
    """A fresh index over a graph whose slots were freed and taken again
    (free-list reuse puts later edges in earlier slots) gives the
    reference's cell_of and edge arrays, at several shard counts."""
    rg, tg, batches = _churn_graphs(5)
    for batch in batches:
        rg.apply_batch(batch)
        tg.apply_batch(batch)
    snap = tg.snapshot()
    live = np.nonzero(snap.valid)[0]
    assert not np.array_equal(live, np.arange(live.size))  # holes: slots were freed
    ref, port = RShardIndex(rg.snapshot(), shards), ShardIndex(snap, shards)
    _same_index(port, ref)
    for a, b in zip(port.edge_arrays(snap), ref.edge_arrays(rg.snapshot())):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ the parity matrix
MATRIX = [
    (backend, mode, drop)
    for backend in ("coo", "ell", "fused")
    for mode in ("jod", "vdc")
    for drop in ("none", "det", "prob")
    if not (mode == "vdc" and (drop != "none" or backend == "ell"))
]


def _steps(engine, batches, log):
    """Feed one engine the host-path batches, then the batched log in chunks
    of 3; yield after every step."""
    yield
    for batch in batches:
        engine.apply_updates(batch)
        yield
    engine.apply_updates_batched(log, batch_size=3)
    yield


@functools.lru_cache(maxsize=None)
def _reference_run(mode: str, drop: str) -> list:
    """The reference's unsharded ``coo`` engine through the stream: per step
    (answers, state leaves, stats, nbytes, nbytes_per_shard at 2 and 4)."""
    initial, batches = random_workload(seed=11)
    log = [u for b in random_workload(seed=5)[1] for u in b]
    eng = rq.sssp(RGraph(V, initial, capacity=512), [0, V // 2], max_iters=MAX_ITERS, mode=mode,
                  backend="coo", batch_capacity=4, **_drop_kw(rdr, drop))
    out = []
    for _ in _steps(eng, batches, log):
        out.append((eng.answers(), _all_ref_leaves(eng.state), jax.tree.map(np.asarray, eng.last_stats),
                    eng.nbytes(), {n: reng.nbytes_per_shard(eng.cfg, eng.state, n) for n in (2, 4)}))
    return out


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("backend,mode,drop", MATRIX, ids=lambda m: str(m))
def test_sharded_matches_reference_unsharded(backend, mode, drop, shards):
    initial, batches = random_workload(seed=11)
    log = [u for b in random_workload(seed=5)[1] for u in b]
    eng = tq.sssp(TGraph(V, initial, capacity=512), [0, V // 2], max_iters=MAX_ITERS, mode=mode,
                  backend=backend, batch_capacity=4, mesh=mesh(shards), device=CPU, **_drop_kw(tdr, drop))
    assert eng.num_shards == shards and len(eng.states) == shards
    want = _reference_run(mode, drop)
    for k, _ in enumerate(_steps(eng, batches, log)):
        answers, leaves, stats, nbytes, per_shard = want[k]
        np.testing.assert_array_equal(eng.answers(), answers)
        got = convert.engine_state_to_numpy(eng.state)
        for key in leaves:
            if not key.startswith("jstore/"):
                np.testing.assert_array_equal(got[key], leaves[key], err_msg=key)
                assert got[key].dtype == leaves[key].dtype, key
        if mode == "vdc":
            stats = stats._replace(jwritten=np.asarray(eng.last_stats.jwritten))
        _same_stats(eng.last_stats, stats)
        per_device = eng.nbytes_per_device()
        assert len(per_device) == shards and sum(per_device) == eng.nbytes()
        if mode == "jod":
            assert eng.nbytes() == nbytes
            assert per_device == per_shard[shards]


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_state_export_is_global_and_imports_at_any_shard_count(shards):
    """export_state gives global arrays (the J store in the edge-slot layout)
    that import into an engine at another shard count and answer alike."""
    initial, batches = random_workload(seed=7)
    make = lambda m: tq.sssp(TGraph(V, initial, capacity=512), [0, V // 2], max_iters=MAX_ITERS,  # noqa: E731
                             mode="vdc", backend="fused", mesh=m, device=CPU)
    src = make(mesh(shards))
    for batch in batches[:2]:
        src.apply_updates(batch)
    arrays, meta = src.export_state()
    assert arrays["jstore/iters"].shape[1] == src.graph.capacity
    assert arrays["cur"].shape == (2, V)
    ref = make(None)
    for batch in batches:
        ref.apply_updates(batch)
    for other in (None, mesh(2), mesh(4)):
        graph = TGraph(V, initial, capacity=512)
        for batch in batches[:2]:
            graph.apply_batch(batch)
        dst = teng.DiffIFE(src.cfg, graph, arrays["init"], mesh=other, active=np.zeros(2, bool), device=CPU)
        dst.import_state(arrays, meta)
        np.testing.assert_array_equal(dst.answers(), src.answers())
        for batch in batches[2:]:
            dst.apply_updates(batch)
        np.testing.assert_array_equal(dst.answers(), ref.answers())


def test_sharded_state_setter_takes_the_getters_layout():
    """``state`` reads a global copy with the J store in the edge-slot
    layout, and the setter takes that layout back: after deletions and
    reinsertions (cells no longer follow slots) ``eng.state = eng.state``
    changes no shard's leaves and the stream goes on as without it."""
    initial, batches = random_workload(seed=7)
    make = lambda: tq.sssp(TGraph(V, initial, capacity=512), [0, V // 2], max_iters=MAX_ITERS,  # noqa: E731
                           mode="vdc", backend="fused", mesh=mesh(4), device=CPU)
    eng, twin = make(), make()
    for batch in batches[:3]:
        eng.apply_updates(batch)
        twin.apply_updates(batch)
    slots, cells = eng._shard_index.cells()
    assert not np.array_equal(cells, slots)  # the layouts differ, so a mix-up would show
    before = [convert.engine_state_to_numpy(st) for st in eng.states]
    eng.state = eng.state
    for st, want in zip(eng.states, before):
        np.testing.assert_equal(convert.engine_state_to_numpy(st), want)
    for batch in batches[3:]:
        eng.apply_updates(batch)
        twin.apply_updates(batch)
    np.testing.assert_array_equal(eng.answers(), twin.answers())
    np.testing.assert_equal(convert.engine_state_to_numpy(eng.state), convert.engine_state_to_numpy(twin.state))


@pytest.mark.parametrize("backend", ["coo", "fused"])
def test_sharded_sweep_syncs_once_per_device_not_per_shard(backend, monkeypatch):
    """The sweep's ``nonzero`` syncs beyond the loop scalars' — the frontier
    push and the two Bloom inserts of Prob-Drop — run once a device an
    iteration: 4 shards emulated on one device make as many as one shard."""
    initial, batches = random_workload(seed=4)
    calls = {"push": 0, "insert": 0}
    push, insert = teng._push_cells, tdr.register_

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(teng, "_push_cells", counted("push", push))
    monkeypatch.setattr(tdr, "register_", counted("insert", insert))
    per_iter = {}
    for shards in (None, 4):
        eng = tq.sssp(TGraph(V, initial, capacity=512), [0, V // 2], max_iters=MAX_ITERS, backend=backend,
                      mesh=None if shards is None else mesh(shards), device=CPU, **_drop_kw(tdr, "prob"))
        calls.update(push=0, insert=0)
        stats = eng.apply_updates(batches[0])
        iters = int(stats.iters_run)
        assert iters > 0
        per_iter[shards] = (calls["push"] / iters, calls["insert"] / iters)
    assert per_iter[4] == per_iter[None] == (1.0, 2.0)


# ------------------------------------------------------------------ growth paths
@pytest.mark.parametrize("backend,mode", [("coo", "jod"), ("ell", "jod"), ("fused", "jod"), ("coo", "vdc"),
                                          ("fused", "vdc")])
def test_sharded_batched_equals_unsharded_sequential_stream(backend, mode):
    """Sharded batched ingestion == the reference's unsharded per-update
    ingestion, on a stream crafted to hit the growth paths: a hub vertex
    outruns both the fixed ELL width and its owner's shard cells (the
    layout regrows, VDC's J rows follow their edges), with Det-Drop
    records and diff-row evictions through a store of capacity 3."""
    v = 16
    initial = [(i, (i + 1) % v, float(1 + i % 3)) for i in range(v)]
    hub = [(i, 3, 0, 1.0, +1) for i in range(v) if i != 3]  # in-degree 15
    rng = np.random.default_rng(3)
    mixed = [(int(rng.integers(0, v)), 7, 0, 2.0, +1) for _ in range(4)] + [
        (1, 2, 0, 1.0, -1),
        (3, 4, 0, 1.0, -1),
    ]
    log = hub + mixed
    drop = {} if mode == "vdc" else {"selection": "random", "p": 0.0}
    kw = dict(max_iters=16, store_capacity=3, mode=mode)
    seq = rq.sssp(RGraph(v, initial, capacity=64), [0, v // 2], backend="coo",
                  **({"drop": rdr.DropConfig(mode="det", **drop)} if drop else {}), **kw)
    bat = tq.sssp(TGraph(v, initial, capacity=64), [0, v // 2], backend=backend, mesh=mesh(8), device=CPU,
                  **({"drop": tdr.DropConfig(mode="det", **drop)} if drop else {}), **kw)
    cap0, width0 = bat._shard_index.shard_capacity, bat._ell_width
    for u in log:
        seq.apply_updates([u])
    bat.apply_updates_batched(log, batch_size=4)
    np.testing.assert_array_equal(bat.answers(), seq.answers())
    assert bat._shard_index.shard_capacity > cap0  # the shard layout regrew
    if backend != "coo":
        assert bat._ell_width > width0  # and the ELL width grew


def test_sharded_pagerank_and_wcc():
    """PageRank on the data mesh at rtol 1e-6 (its sums reassociate over
    the sharded edge layout); WCC bit for bit."""
    rng = np.random.default_rng(2)
    v = 16
    seen = {}
    while len(seen) < 48:
        u, w = int(rng.integers(0, v)), int(rng.integers(0, v))
        if u != w:
            seen[(u, w)] = (u, w, 1.0)
    edges = list(seen.values())
    log = [(int(rng.integers(0, v)), int(rng.integers(0, v)), 0, 1.0, s) for s in (+1, +1, -1, +1) for _ in range(2)]
    log = [op for op in log if op[0] != op[1]]
    for backend, shards in (("ell", 4), ("coo", 2), ("fused", 8)):
        a = rq.pagerank(RGraph(v, edges, capacity=128), iters=8)
        b = tq.pagerank(TGraph(v, edges, capacity=128), iters=8, backend=backend, mesh=mesh(shards), device=CPU)
        np.testing.assert_allclose(b.answers(), a.answers(), rtol=1e-6)
        a.apply_updates_batched(log, batch_size=4)
        b.apply_updates_batched(log, batch_size=4)
        np.testing.assert_allclose(b.answers(), a.answers(), rtol=1e-6)
    initial, batches = _symmetric(*random_workload(seed=2, v=v, e=40))
    for backend in ("coo", "fused"):
        c = rq.wcc(RGraph(v, initial, capacity=256), max_iters=16)
        d = tq.wcc(TGraph(v, initial, capacity=256), max_iters=16, backend=backend, mesh=mesh(4), device=CPU)
        np.testing.assert_array_equal(d.answers(), c.answers())
        for batch in batches:
            c.apply_updates(batch)
            d.apply_updates(batch)
            np.testing.assert_array_equal(d.answers(), c.answers())


def test_empty_sweep_keeps_every_shards_answers():
    """A sweep with nothing dirty (a no-op batch) keeps the last answers on
    every shard, as unsharded (ROADMAP Queue 3's pinning)."""
    initial, batches = random_workload(seed=4)
    eng = tq.sssp(TGraph(V, initial, capacity=512), [0, V // 2], max_iters=MAX_ITERS, backend="fused",
                  mesh=mesh(4), device=CPU)
    eng.apply_updates(batches[0])
    before = eng.answers()
    assert int(eng.apply_updates([]).iters_run) == 0
    np.testing.assert_array_equal(eng.answers(), before)


def test_sweep_leaves_every_shards_input_state_frozen():
    """K2 writes its working stores in place from a sweep's second iteration
    on; every shard's input state stays as it was."""
    initial, batches = random_workload(seed=4)
    for drop in ("det", "prob"):
        eng = tq.sssp(TGraph(V, initial, capacity=512), [0, V // 2], max_iters=MAX_ITERS, backend="fused",
                      mesh=mesh(2), device=CPU, **_drop_kw(tdr, drop))
        states = eng.states
        before = [{k: v.copy() for k, v in convert.engine_state_to_numpy(st).items()} for st in states]
        eng.apply_updates(batches[0])
        assert all(a is not b for a, b in zip(eng.states, states))
        for st, want in zip(states, before):
            np.testing.assert_equal(convert.engine_state_to_numpy(st), want)


# ------------------------------------------------------------------ K2 at an offset
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("semiring", ["min_plus", "pr_sum"])
def test_fused_sweep_plain_at_offset_matches_reference_kernel(semiring, mode):
    """K2's plain version on a shard's rows — 37 of a 148-vertex graph at
    ``off`` = 74, the expand gathering from every vertex — equals the
    reference kernel in interpret mode with the same ``off``; the coin and
    the Bloom key see global ids, so the drops move with ``off``."""
    q, v, d, s, n, off = 3, 37, 5, 8, 4, 74
    rng = np.random.default_rng(17 + MODES.index(mode))
    x = _inputs(rng, q, v, d, s, semiring, mode)
    full = v * n
    x["nbr"] = rng.integers(0, full + 1, size=(v, d)).astype(np.int32)
    if semiring == "pr_sum":
        x["states"] = np.concatenate([rng.random((q, full), np.float32), np.zeros((q, 1), np.float32)], 1)
    else:
        x["states"] = np.concatenate(
            [rng.integers(0, 6, size=(q, full)).astype(np.float32), np.full((q, 1), np.inf, np.float32)], 1)
    args, kw = _port_call(x, semiring, mode)
    got = K2.fused_sweep(*args, off=off, **kw)
    want = _reference(x, semiring, mode, off=off)
    for name in K2.FusedOut._fields:
        g, w = getattr(got, name), getattr(want, name)
        if name in ("det_overflow", "det_max_iter") and w is not None:
            w = np.asarray(w).sum(1, dtype=np.int32) if name == "det_overflow" else np.asarray(w).max(1)
        if w is None:
            assert g is None, name
            continue
        w = np.asarray(w)
        if semiring == "pr_sum" and name in FLOAT_OUTS:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if mode != "none":
        at0 = K2.fused_sweep(*_port_call(x, semiring, mode)[0], **_port_call(x, semiring, mode)[1])
        assert not (torch.equal(at0.to_drop, got.to_drop) and torch.equal(at0.repair, got.repair))


# ------------------------------------------------------------------ meshes and elastic resharding
def test_meshes_and_elastic_resharding():
    """A global state placed on 2 shards (``runtime.elastic.reshard``)
    gathers back to itself; a mesh over distinct devices raises when fewer
    are visible; emulation happens only when asked for."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.runtime import elastic

    initial, _ = random_workload(seed=9)
    eng = tq.sssp(TGraph(V, initial, capacity=512), [0, V // 2], max_iters=MAX_ITERS, backend="fused",
                  mesh=mesh(4), device=CPU, **_drop_kw(tdr, "prob"))
    whole = teng.gather_state(eng.states, eng.mesh, torch.device(CPU))
    two = mesh(2)
    parts = elastic.reshard(whole, two)
    assert len(parts) == 2 and parts[0].dstore.iters.shape[1] == V // 2
    assert parts[0].drop.flt.bits is parts[1].drop.flt.bits  # replicated: one copy on the one device
    back = teng.gather_state(parts, two, torch.device(CPU))
    for a, b in zip(convert.engine_state_to_numpy(back).values(), convert.engine_state_to_numpy(whole).values()):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="emulate=True"):
        make_data_mesh(2, device=CPU)
    with pytest.raises(ValueError, match="visible"):
        make_production_mesh()
    assert not make_data_mesh(1, device=CPU).emulated and two.emulated
    built = elastic.build_mesh([CPU] * 4, data=2, model=1, emulate=True)  # the reference's (data, model)
    assert built.size == 2 and built.shape == {"data": 2, "model": 1} and built.emulated
    with pytest.raises(ValueError, match="emulate=True"):
        elastic.build_mesh([CPU] * 4, data=2)  # repeated devices are never emulated silently
    assert elastic.shrink_after_failure(two, {torch.device("cuda", 0)}).size == 2
    cards = DataMesh((torch.device("cuda", 0), torch.device("cuda", 1)))
    assert elastic.shrink_after_failure(cards, {"cuda"}).devices == (torch.device("cuda", 1),)
    with pytest.raises(ValueError, match="survives"):
        elastic.shrink_after_failure(two, {CPU})
    assert elastic.split_global_batch(8, mesh(4)) == 2
    with pytest.raises(ValueError, match="split"):
        elastic.split_global_batch(6, mesh(4))
