"""Port parity: the dense engine's query-slot pool, drop-policy sheds and
``export_state``/``import_state``.

The same seeded workloads go through the JAX reference (its Pallas kernels
in interpret mode) and the port with ``device="cpu"``.  Both engines start
as all-inactive pools of one slot and take the same registrations,
deregistrations and update chunks; after each step their ``export_state``
snapshots — every state leaf, with the reference's keys and dtypes, and the
free list, shed-overflow and schedule counters — must be equal (min family;
PageRank's answers at ``rtol=1e-6``), and so must ``slot_nbytes`` of every
slot and the bytes each call reports.
"""

import numpy as np
import pytest
import torch

from repro.core import dropping as rdr
from repro.core import engine as reng
from repro.core import plan as rplan
from repro.core.graph import DynamicGraph as RGraph
from repro.core.session import engine_config_for as r_config_for
from repro_torch.core import dropping as tdr
from repro_torch.core import engine as teng
from repro_torch.core import plan as tplan
from repro_torch.core.graph import DynamicGraph as TGraph
from repro_torch.core.session import engine_config_for as t_config_for
from test_torch_engine import random_workload

V = 16
CPU = "cpu"
MAX_ITERS = 16

DROPS = {
    "none": None,
    "det": dict(mode="det", selection="random", p=0.3, seed=5),
    "prob": dict(mode="prob", selection="random", p=0.3, seed=5, bloom_bits=1 << 10),
}


def _drop(mod, mode, **kw):
    return None if DROPS[mode] is None else mod.DropConfig(**{**DROPS[mode], **kw})


def _pair(initial, plan_name="sssp", *, backend="coo", mode="none", vdc=False, cap=1):
    """(reference, port) engines for one plan family: all-inactive pools of
    ``cap`` slots on copies of one graph."""
    pair = []
    for plan_mod, dr_mod, graph_cls, config_for, eng_mod, kw in (
        (rplan, rdr, RGraph, r_config_for, reng, {}),
        (tplan, tdr, TGraph, t_config_for, teng, {"device": CPU}),
    ):
        first = _plan(plan_mod, plan_name, 0)
        cfg = config_for(first, num_queries=cap, num_vertices=V, mode="vdc" if vdc else "jod",
                         drop=_drop(dr_mod, mode), backend=backend)
        init = np.full((cap, V), first.semiring.identity, np.float32)
        pair.append(eng_mod.DiffIFE(cfg, graph_cls(V, initial, capacity=256), init, batch_capacity=4,
                                    active=np.zeros(cap, bool), **kw))
    return tuple(pair)


def _plan(plan_mod, name, source, **kw):
    if name == "pagerank":
        return plan_mod.pagerank(iters=8, **kw)
    return plan_mod.sssp(source, max_iters=MAX_ITERS, **kw)


def _register(ref, port, plan_name, sources, mode="none"):
    """Register one plan per source in both engines (one batch); the slots
    handed out must agree."""
    got = []
    for eng, plan_mod, dr_mod in ((ref, rplan, rdr), (port, tplan, tdr)):
        reqs = []
        for s in sources:
            p = _plan(plan_mod, plan_name, s, drop=_drop(dr_mod, mode, seed=s) or dr_mod.DropConfig())
            reqs.append((p.build_init(V), p.drop))
        got.append(eng.register_slots(reqs))
    assert got[0] == got[1]
    return got[1]


def _same_exports(ref, port, *, rtol=None):
    ra, rm = ref.export_state()
    ta, tm = port.export_state()
    assert tm == rm
    assert ta.keys() == ra.keys()
    for k in ra:
        want = np.asarray(ra[k])
        assert ta[k].dtype == want.dtype, k
        if rtol is not None and k == "cur":
            np.testing.assert_allclose(ta[k], want, rtol=rtol, err_msg=k)
        elif rtol is None or not k.startswith(("dstore/", "drop_det/", "drop_flt/", "drop/")):
            np.testing.assert_array_equal(ta[k], want, err_msg=k)
    if rtol is None:
        for s in range(ref.slot_capacity):
            assert port.slot_nbytes(s) == ref.slot_nbytes(s), s
        assert port.nbytes() == ref.nbytes()
        assert port.nbytes_per_operator() == ref.nbytes_per_operator()


CASES = [
    ("sssp", "coo", "det"),
    ("sssp", "fused", "prob"),
    ("pagerank", "coo", "none"),
]


@pytest.mark.parametrize("plan_name,backend,mode", CASES)
def test_register_deregister_regrow_match_the_reference(plan_name, backend, mode):
    """One slot grows to eight by single registrations between update
    chunks; a retired slot is reused; every step leaves both engines with
    equal exports and ``slot_nbytes``."""
    initial, batches = random_workload(3, v=V, e=48, num_batches=4)
    ref, port = _pair(initial, plan_name, backend=backend, mode=mode)
    rtol = 1e-6 if plan_name == "pagerank" else None
    sources = [0, 5, 9, 13, 2]
    for j, s in enumerate(sources):
        _register(ref, port, plan_name, [s], mode)
        _same_exports(ref, port, rtol=rtol)
        if j < len(batches):
            ref.apply_updates_batched(batches[j])
            port.apply_updates_batched(batches[j])
            _same_exports(ref, port, rtol=rtol)
    assert port.slot_capacity == ref.slot_capacity == 8
    want = ref.slot_nbytes(2)
    assert port.deregister_slot(2) == ref.deregister_slot(2) == want
    _same_exports(ref, port, rtol=rtol)
    assert _register(ref, port, plan_name, [7], mode) == [2]  # the freed slot comes back first
    assert port.slot_capacity == 8
    _same_exports(ref, port, rtol=rtol)
    ref.apply_updates(batches[-1])
    port.apply_updates(batches[-1])
    _same_exports(ref, port, rtol=rtol)


def test_one_batch_registers_in_one_sweep_and_schedules_only_new_rows():
    """``register_slots`` grows the pool once for a whole batch and seeds
    exactly the new rows: the sweep's schedule equals the reference's and
    the earlier slot's stored rows and answers are untouched (its dropped
    points are repaired as the sweep walks past them, as in the
    reference)."""
    initial, batches = random_workload(4, v=V, e=48, num_batches=1)
    ref, port = _pair(initial, backend="coo", mode="det")
    _register(ref, port, "sssp", [1], "det")
    port.apply_updates_batched(batches[0])
    ref.apply_updates_batched(batches[0])
    before = {k: v for k, v in port.export_state()[0].items()}
    _register(ref, port, "sssp", [3, 6, 11], "det")  # 1 → 4 slots, one sweep
    assert port.slot_capacity == 4
    np.testing.assert_array_equal(port.last_stats.sched_sizes, ref.last_stats.sched_sizes)
    after = port.export_state()[0]
    for k in ("dstore/iters", "dstore/count", "drop_det/iters", "cur"):
        np.testing.assert_array_equal(after[k][0], before[k][0], err_msg=k)
    _same_exports(ref, port)


@pytest.mark.parametrize("backend", ["fused"])
def test_midstream_register_equals_from_start(backend):
    """A slot registered mid-stream ends with the answers of an engine that
    had it from the start, on the port as on the reference."""
    initial, batches = random_workload(6, v=V, e=48, num_batches=4)
    ref_a, port_a = _pair(initial, backend=backend)
    ref_b, port_b = _pair(initial, backend=backend)
    slots_a = _register(ref_a, port_a, "sssp", [0, 8])
    slots_b = _register(ref_b, port_b, "sssp", [0])
    for j, b in enumerate(batches):
        for eng in (ref_a, port_a, ref_b, port_b):
            eng.apply_updates_batched(b)
        if j == 1:
            slots_b += _register(ref_b, port_b, "sssp", [8])
    np.testing.assert_array_equal(port_b.answers()[slots_b], port_a.answers()[slots_a])
    _same_exports(ref_b, port_b)


@pytest.mark.parametrize("mode", ["det", "prob"])
def test_shed_after_set_drop_params_matches_the_reference(mode):
    """Escalating one slot's policy sheds its stored points into the
    DroppedVT exactly as the reference does (every leaf, the bytes freed,
    shed evictions); the neighbour slot keeps its bytes; later sweeps agree."""
    initial, batches = random_workload(8, v=V, e=48, num_batches=3)
    ref, port = _pair(initial, backend="coo", mode=mode)
    _register(ref, port, "sssp", [0, 4], mode)
    for b in batches[:2]:
        ref.apply_updates_batched(b)
        port.apply_updates_batched(b)
    other = port.slot_nbytes(1)
    for p, det_capacity in ((0.7, 32), (1.0, 2)):
        up = dict(p=p, seed=2, det_capacity=det_capacity)
        freed_r = ref.set_drop_params(0, _drop(rdr, mode, **up))
        freed_t = port.set_drop_params(0, _drop(tdr, mode, **up))
        assert freed_t == freed_r
        _same_exports(ref, port)
    assert port.slot_nbytes(1) == other
    assert port.det_overflow_shed == ref.det_overflow_shed
    ref.apply_updates_batched(batches[2])
    port.apply_updates_batched(batches[2])
    _same_exports(ref, port)


def test_set_drop_params_join_and_validation():
    """``op_id="join"`` routes to ``set_join_store`` (VDC); the validation
    errors are the reference's."""
    initial, batches = random_workload(9, v=V, e=48, num_batches=2)
    ref, port = _pair(initial, backend="coo", mode="det", vdc=True)
    _register(ref, port, "sssp", [0, 3], "det")
    ref.apply_updates_batched(batches[0])
    port.apply_updates_batched(batches[0])
    drop_all = dict(mode="det", p=1.0)
    freed = port.set_drop_params(1, tdr.DropConfig(**drop_all), op_id="join")
    assert freed == ref.set_drop_params(1, rdr.DropConfig(**drop_all), op_id="join") > 0
    _same_exports(ref, port)
    assert port.set_drop_params(1, tdr.DropConfig(), op_id="join") == 0  # re-materialize
    ref.set_drop_params(1, rdr.DropConfig(), op_id="join")
    ref.apply_updates_batched(batches[1])
    port.apply_updates_batched(batches[1])
    _same_exports(ref, port)
    with pytest.raises(ValueError, match="completely"):
        port.set_drop_params(0, tdr.DropConfig(mode="det", p=0.5), op_id="join")
    with pytest.raises(ValueError, match="owns no engine difference store"):
        port.set_drop_params(0, tdr.DropConfig(), op_id="aggregate")
    with pytest.raises(ValueError, match="drop mode"):
        port.set_drop_params(0, tdr.DropConfig(mode="prob", p=0.5))
    with pytest.raises(ValueError, match="drop mode"):
        port.register_slot(np.zeros(V, np.float32), tdr.DropConfig(mode="prob", p=0.5))
    port.deregister_slot(0)
    with pytest.raises(ValueError, match="not active"):
        port.deregister_slot(0)
    with pytest.raises(ValueError, match="not active"):
        port.set_drop_params(0, tdr.DropConfig(mode="det", p=0.5))
    _, plain = _pair(initial, backend="coo")
    plain.register_slot(tplan.sssp(0, max_iters=MAX_ITERS).build_init(V))
    assert plain.set_drop_params(0, tdr.DropConfig()) == 0
    with pytest.raises(ValueError, match="representation"):
        plain.set_drop_params(0, tdr.DropConfig(mode="det", p=0.5))


@pytest.mark.parametrize("mode,vdc", [("det", False), ("prob", False), ("none", True)])
def test_export_imports_across_packages(mode, vdc):
    """An export of either package imports into the other, and the same
    stream continued on both ends leaf-equal."""
    initial, batches = random_workload(10, v=V, e=48, num_batches=3)
    ref, port = _pair(initial, backend="coo", mode=mode, vdc=vdc)
    slots = _register(ref, port, "sssp", [0, 6, 12], mode)
    for b in batches[:2]:
        ref.apply_updates_batched(b)
        port.apply_updates_batched(b)
    port.deregister_slot(slots[1])
    ref.deregister_slot(slots[1])
    # fresh engines on the current graphs, each fed the other package's export
    ref2, port2 = _pair([], backend="coo", mode=mode, vdc=vdc, cap=port.slot_capacity)
    ref2.graph, port2.graph = ref.graph, port.graph
    ref2.g = ref2._device_graph(ref.graph.snapshot())
    port2.g = port2._device_graph(port.graph.snapshot())
    ref2.import_state(*port.export_state())
    port2.import_state(*ref.export_state())
    _same_exports(ref2, port)
    _same_exports(ref, port2)
    for eng in (ref2, port2):
        eng.apply_updates_batched(batches[2])
    _same_exports(ref2, port2)
    # the export is a copy: later slot edits leave it as it was
    arrays, _ = port2.export_state()
    kept = arrays["cur"].copy()
    port2.deregister_slot(slots[0])
    np.testing.assert_array_equal(arrays["cur"], kept)


@pytest.mark.parametrize("mode", ["none", "det"])
def test_fused_sweep_after_register_and_regrow_leaves_its_input(mode):
    """K2 writes in place only from a sweep's second iteration, into the
    sweep's own stores: a ``maintain`` on the state that ``register_slots``
    and ``_grow_queries`` just built leaves that state bit-unchanged."""
    initial, batches = random_workload(12, v=V, e=48, num_batches=1)
    _, port = _pair(initial, backend="fused", mode=mode)
    slot = port.register_slot(tplan.sssp(0, max_iters=MAX_ITERS).build_init(V))
    port.apply_updates_batched(batches[0])
    port.register_slots([(tplan.sssp(s, max_iters=MAX_ITERS).build_init(V), None) for s in (4, 9)])
    assert port.slot_capacity == 4
    before, _ = port.export_state()
    dirty = np.zeros((port.slot_capacity, V), bool)
    dirty[slot] = True
    out, stats = teng.maintain(port.cfg, port.state, port.g, torch.from_numpy(dirty))
    assert int(stats.iters_run) > 1  # the in-place iterations ran
    after, _ = port.export_state()
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    assert out.dstore.iters.data_ptr() != port.state.dstore.iters.data_ptr()
