"""Port parity: VDC mode (the per-edge J store) and the access path.

The same workloads go through the JAX reference (its Pallas kernels in
interpret mode) and the port with ``device="cpu"``, where ``diff_lookup``
and ``fused_sweep`` run their plain versions.  For the min family every
state leaf — D store, J store, ``join_mat``, DroppedVT — every
``MaintainStats`` field (``jwritten`` included), ``nbytes()`` and
``nbytes_per_operator()`` must be equal; PageRank's answers are held at
``rtol=1e-6`` (its sums may reassociate, so change points may differ).
"""

import functools
import importlib.util
from functools import partial
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import access as raccess
from repro.core import dropping as rdr
from repro.core import engine as reng
from repro.core import plan as rplan
from repro.core import queries as rq
from repro.core.graph import DynamicGraph as RGraph
from repro.core.session import engine_config_for as r_engine_config_for
from repro_torch.core import access as taccess
from repro_torch.core import convert
from repro_torch.core import dropping as tdr
from repro_torch.core import engine as teng
from repro_torch.core import plan as tplan
from repro_torch.core import queries as tq
from repro_torch.core import scratch as tscratch
from repro_torch.core.graph import DynamicGraph as TGraph
from repro_torch.core.session import engine_config_for as t_engine_config_for
from repro_torch.kernels import diff_lookup as K4
from test_torch_engine import _same_stats, _symmetric, random_workload
from test_torch_fused import DROPS, _all_ref_leaves, _drop_kw, _same_state

V = 24
CPU = "cpu"


def _ref_vdc_leaves(state) -> dict:
    """The reference state as ``core/convert.py``'s flat leaves, J store and
    ``join_mat`` included."""
    out = _all_ref_leaves(state)
    if state.jstore is not None:
        st = jax.tree.map(np.asarray, state.jstore)
        out.update({f"jstore/{k}": getattr(st, k) for k in ("iters", "vals", "count")})
        out["join_mat"] = np.asarray(state.join_mat)
    return out


def _same_vdc_engine(port, ref, exact: bool = True):
    if not exact:
        np.testing.assert_allclose(port.answers(), ref.answers(), rtol=1e-6)
        return
    np.testing.assert_array_equal(port.answers(), ref.answers())
    _same_state(convert.engine_state_to_numpy(port.state), _ref_vdc_leaves(ref.state))
    _same_stats(port.last_stats, ref.last_stats)
    assert port.nbytes() == ref.nbytes()
    assert port.nbytes_per_operator() == ref.nbytes_per_operator()
    assert port.nbytes_per_query() == ref.nbytes_per_query()


def _feed(engines, batches, path):
    """Feed every engine the same batches; yield after each step."""
    if path == "apply_updates":
        for batch in batches:
            for e in engines:
                e.apply_updates(batch)
            yield
    else:
        log = [u for b in batches for u in b]
        for e in engines:
            e.apply_updates_batched(log, batch_size=4)
        yield


def _pair(query, initial, backend, mode, **kw):
    """(reference, port) VDC engines for one query family on copies of one
    initial graph."""
    common = dict(backend=backend, batch_capacity=4, mode="vdc", **kw)
    if query == "sssp":
        make = lambda m, g, **k: m.sssp(g, [0, V // 2], max_iters=24, **common, **k)  # noqa: E731
    elif query == "khop":
        make = lambda m, g, **k: m.khop(g, [0, V // 2], k=4, **common, **k)  # noqa: E731
    elif query == "wcc":
        make = lambda m, g, **k: m.wcc(g, max_iters=24, **common, **k)  # noqa: E731
    else:
        make = lambda m, g, **k: m.pagerank(g, iters=8, **common, **k)  # noqa: E731
    ref = make(rq, RGraph(V, initial, capacity=512), **_drop_kw(rdr, mode))
    port = make(tq, TGraph(V, initial, capacity=512), device=CPU, **_drop_kw(tdr, mode))
    return ref, port


# ------------------------------------------------------------ the parity matrix
@pytest.mark.parametrize("path", ["apply_updates", "batched"])
@pytest.mark.parametrize("mode", ["none", "det", "prob"])
@pytest.mark.parametrize("backend", ["coo", "fused"])
def test_vdc_sssp_matches_reference(backend, mode, path):
    """SSSP in VDC, with deletions in the stream: every leaf after every step."""
    initial, batches = random_workload(seed=11)
    assert any(u[-1] == -1 for b in batches for u in b)
    ref, port = _pair("sssp", initial, backend, mode)
    _same_vdc_engine(port, ref)
    assert int(port.last_stats.jwritten) > 0
    for _ in _feed((ref, port), batches, path):
        _same_vdc_engine(port, ref)


@pytest.mark.parametrize("backend", ["coo", "fused"])
@pytest.mark.parametrize("query,mode,seed", [("khop", "det", 1), ("wcc", "prob", 2), ("pagerank", "none", 9)])
def test_vdc_semirings_match_reference(query, mode, seed, backend):
    """The other three semirings through VDC on the batched path; PageRank
    at rtol 1e-6."""
    initial, batches = random_workload(seed=seed)
    if query == "wcc":
        initial, batches = _symmetric(initial, batches)
    ref, port = _pair(query, initial, backend, mode)
    exact = query != "pagerank"
    _same_vdc_engine(port, ref, exact)
    for _ in _feed((ref, port), batches, "batched"):
        _same_vdc_engine(port, ref, exact)


def test_vdc_evicts_full_j_rows_as_the_reference():
    """S_J = 2 fills J rows: the oldest change point is evicted and
    forgotten, on both sides alike."""
    initial, batches = random_workload(seed=3, num_batches=6)
    ref, port = _pair("sssp", initial, "coo", "none", jstore_capacity=2)
    assert port.cfg.jstore_capacity == 2
    for _ in _feed((ref, port), batches, "apply_updates"):
        _same_vdc_engine(port, ref)
    assert int((port.state.jstore.count == 2).sum()) > 0


@pytest.mark.parametrize("backend", ["coo", "fused"])
def test_mixed_join_rows_and_set_join_store(backend):
    """Slots without a materialized Join recompute their messages inside
    the VDC engine; dropping a slot's J rows frees exactly its join bytes,
    and re-materializing re-walks its trajectory."""
    initial, batches = random_workload(seed=7, num_batches=4)
    sources, join_rows = [0, 5, V // 2], [True, False, True]

    def build(plan_mod, graph_mod, cfg_for):
        plans = [plan_mod.sssp(s, max_iters=24) for s in sources]
        cfg = cfg_for(plans[0], num_queries=3, num_vertices=V, mode="vdc", backend=backend)
        return graph_mod(V, initial, capacity=512), cfg, np.stack([p.build_init(V) for p in plans])

    g, cfg, init = build(rplan, RGraph, r_engine_config_for)
    ref = reng.DiffIFE(cfg, g, init, batch_capacity=4, join_rows=join_rows)
    g, cfg, init = build(tplan, TGraph, t_engine_config_for)
    port = teng.DiffIFE(cfg, g, init, batch_capacity=4, join_rows=join_rows, device=CPU)
    _same_vdc_engine(port, ref)
    assert port.nbytes_per_operator()[1]["join"] == 0
    assert port.nbytes_per_operator()[0]["join"] > 0
    ref.apply_updates_batched([u for b in batches[:2] for u in b], batch_size=4)
    port.apply_updates_batched([u for b in batches[:2] for u in b], batch_size=4)
    _same_vdc_engine(port, ref)

    before = port.nbytes()
    join0 = port.nbytes_per_operator()[0]["join"]
    state = port.state
    freed = port.set_join_store(0, False)
    assert freed == join0 == ref.set_join_store(0, False)
    assert port.nbytes() == before - freed
    assert int(state.jstore.count[0].sum()) * 8 == join0  # the earlier state stays
    _same_vdc_engine(port, ref)
    assert port.set_join_store(0, True) == ref.set_join_store(0, True) == 0
    _same_vdc_engine(port, ref)
    assert port.set_join_store(0, True) == 0  # already materialized: nothing to do
    ref.apply_updates_batched([u for b in batches[2:] for u in b], batch_size=4)
    port.apply_updates_batched([u for b in batches[2:] for u in b], batch_size=4)
    _same_vdc_engine(port, ref)
    assert port.recompute_cost_per_operator() == ref.recompute_cost_per_operator()
    assert port.recompute_cost_per_query() == ref.recompute_cost_per_query()
    assert port.active_slots() == ref.active_slots() == [0, 1, 2]


def test_engine_from_plans_takes_each_plans_join_policy():
    """A plan whose Join drops its trace gets ``join_mat`` False; one that
    materializes it makes the engine VDC."""
    nfa = tplan.NFA.star(1)
    initial, _ = random_workload(seed=5)
    plans = [tplan.rpq(0, nfa, max_iters=12, join_store="materialize"),
             tplan.rpq(1, nfa, max_iters=12, join_store="drop")]
    rplans = [rplan.rpq(0, rplan.NFA.star(1), max_iters=12, join_store="materialize"),
              rplan.rpq(1, rplan.NFA.star(1), max_iters=12, join_store="drop")]
    port = tq.engine_from_plans(TGraph(V, initial, capacity=512), plans, jstore_capacity=4, device=CPU)
    ref = rq.engine_from_plans(RGraph(V, initial, capacity=512), rplans, jstore_capacity=4)
    assert port.cfg.mode == "vdc" and port.cfg.jstore_capacity == 4
    assert port.state.join_mat.tolist() == [True, False]
    _same_vdc_engine(port, ref)


def test_vdc_state_carries_across_from_reference():
    """A reference VDC run moves into the port mid-stream (J store and
    ``join_mat`` included); both run the next chunk and every leaf matches."""
    initial, batches = random_workload(seed=11, num_batches=4)
    ref, _ = _pair("sssp", initial, "coo", "det")
    ref.apply_updates_batched([u for b in batches[:3] for u in b], batch_size=4)
    leaves = _ref_vdc_leaves(ref.state)
    state = convert.engine_state_from_numpy(leaves, CPU)
    _same_state(convert.engine_state_to_numpy(state), leaves)
    g = convert.graph_arrays_from_numpy(
        {f: (None if x is None else np.asarray(x)) for f, x in ref.g._asdict().items()}, CPU
    )
    ops = ref.graph.apply_batch_resolved(batches[3])
    upd = ref._encode_chunk(ops, [], 4)
    tupd = convert.update_batch_from_numpy({f: np.asarray(x) for f, x in upd._asdict().items()}, CPU)
    cfg = teng.EngineConfig(**{
        f.name: getattr(ref.cfg, f.name) for f in teng.dataclasses.fields(teng.EngineConfig)
        if f.name != "drop"
    }, drop=tdr.DropConfig(**DROPS["det"]))
    rstate, _, rstats = jax.jit(partial(reng.batched_step, ref.cfg))(ref.state, ref.g, upd)
    tstate, _, tstats = teng.batched_step(cfg, state, g, tupd)
    _same_state(convert.engine_state_to_numpy(tstate), _ref_vdc_leaves(rstate))
    _same_stats(tstats, rstats)
    assert int(tstats.jwritten) > 0


def test_vdc_sweep_leaves_its_input_state_frozen():
    """The sweep writes the J store in place into its own clone: the state
    it was given keeps every leaf."""
    initial, batches = random_workload(seed=4)
    _, port = _pair("sssp", initial, "coo", "none")
    before = {k: v.copy() for k, v in convert.engine_state_to_numpy(port.state).items()}
    state = port.state
    port.apply_updates(batches[0])
    assert port.state.jstore.iters.data_ptr() != state.jstore.iters.data_ptr()
    np.testing.assert_equal(convert.engine_state_to_numpy(state), before)


# ------------------------------------------------------------ the deletion repair
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_data", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scratch_answers(port) -> np.ndarray:
    return tscratch.scratch_like(port.cfg, port.graph, port.state.init, device=CPU).answers()


@functools.lru_cache(maxsize=1)
def _deletion_streams():
    """Answers of the port, the reference and SCRATCH after every step of the
    deletion-heavy streams: the pinned one (V=64, ``uniform_edges(64, 281,
    default_rng(0))``, ``split_and_stream(edges, 16, 0.5, rng)``, one
    source, one update a step) and 30 seeded ones (V=128, E=700, 4 sources,
    32 updates at 50% deletes, 4 a step).  One list of (port, ref, scratch)
    triples per stream."""
    cs = _chip_smoke()
    specs = [(0, 64, 281, 16, 1, 1)] + [(seed, 128, 700, 32, 4, 4) for seed in range(30)]
    out = []
    for seed, v, e, n, q, step in specs:
        rng = np.random.default_rng(seed)
        edges = cs.uniform_edges(v, e, rng)
        initial, stream = cs.split_and_stream(edges, n, 0.5, rng)
        sources = cs.pick_sources(RGraph(v, initial), q, rng)
        ref = rq.sssp(RGraph(v, initial), sources, mode="vdc", max_iters=48)
        port = tq.sssp(TGraph(v, initial), sources, mode="vdc", max_iters=48, device=CPU)
        steps = []
        for lo in range(0, n, step):
            ref.apply_updates(stream[lo:lo + step])
            port.apply_updates(stream[lo:lo + step])
            steps.append((port.answers(), ref.answers(), _scratch_answers(port)))
        out.append(steps)
    return out


def test_vdc_equals_scratch_under_deletions():
    """The J rewrite gate re-checks every out-edge of a vertex scheduled at
    i-1 (ROADMAP Queue 3): on the pinned stream, where the reference
    differs from SCRATCH by 4 answers after the 5th update (the delete
    (32, 63, 0, 2.0, -1)), and on 30 seeded streams, the port equals
    SCRATCH after every step."""
    streams = _deletion_streams()
    assert len(streams) == 31
    for steps in streams:
        for port, _ref, sc in steps:
            np.testing.assert_array_equal(port, sc)
    assert int((streams[0][4][1] != streams[0][4][2]).sum()) == 4


def test_vdc_departs_from_the_reference_only_where_the_reference_is_wrong():
    """Every answer where the port and the reference differ is one where the
    reference differs from SCRATCH; a stream on which the reference stays
    exact gives the port's answers equal to the reference's throughout.
    The streams are not vacuous: on several the reference is wrong."""
    wrong_streams = 0
    for steps in _deletion_streams():
        ref_wrong = False
        for port, ref, sc in steps:
            assert not ((port != ref) & (ref == sc)).any()
            ref_wrong |= bool((ref != sc).any())
        if not ref_wrong:
            for port, ref, _sc in steps:
                np.testing.assert_array_equal(port, ref)
        wrong_streams += ref_wrong
    assert wrong_streams >= 10


# ------------------------------------------------------------ access path
@pytest.mark.parametrize("mode", ["det", "prob"])
def test_access_reassemble_and_latest_dropped_match_reference(mode):
    """``access``, ``reassemble`` and ``latest_dropped_le`` on det and prob
    engines equal the reference's (the shape of
    ``tests/test_sparse_and_access.py``), after a deletion."""
    edges = [(0, 1, 2.0), (1, 2, 3.0), (0, 2, 10.0), (2, 3, 1.0)]
    kw = dict(mode=mode, selection="random", p=0.6, seed=5, bloom_bits=1 << 10)
    ref = rq.sssp(RGraph(4, edges, capacity=32), [0], max_iters=16, drop=rdr.DropConfig(**kw))
    port = tq.sssp(TGraph(4, edges, capacity=32), [0], max_iters=16, drop=tdr.DropConfig(**kw), device=CPU)
    for e in (ref, port):
        e.apply_updates([(0, 1, 0, 2.0, -1)])  # delete the short path
    want = np.asarray(reng.reassemble(ref.cfg, ref.state, ref.g))
    got = teng.reassemble(port.cfg, port.state, port.g).numpy()
    np.testing.assert_array_equal(got, want)
    for v in range(4):
        np.testing.assert_array_equal(taccess.access(port.cfg, port.state, port.g, v, 16),
                                      raccess.access(ref.cfg, ref.state, ref.g, v, 16))
        np.testing.assert_allclose(taccess.access(port.cfg, port.state, port.g, v, 16), want[:, v])
    for i in (0, 3, 16):
        rf, rit = rdr.latest_dropped_le(ref.state.drop, i, 4)
        tf, tit = tdr.latest_dropped_le(port.state.drop, i, 4)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(rf))
        np.testing.assert_array_equal(tit.numpy(), np.asarray(rit))
        assert tit.dtype == torch.int32


def test_latest_dropped_le_goes_through_the_lookup_on_det_rows():
    """Det mode reads the Det rows through ``diff_lookup`` with the scalar
    iteration (K4's second caller)."""
    initial, batches = random_workload(seed=2)
    drop = tdr.DropConfig(**DROPS["det"])
    port = tq.sssp(TGraph(V, initial, capacity=512), [0, 3], max_iters=24, drop=drop, device=CPU)
    calls = []
    real = tdr.diff_lookup
    try:
        tdr.diff_lookup = lambda it, va, qi: calls.append((tuple(it.shape), qi)) or real(it, va, qi)
        found, it = tdr.latest_dropped_le(port.state.drop, 9, V)
    finally:
        tdr.diff_lookup = real
    assert calls == [((2 * V, drop.det_capacity), 9)]
    assert found.shape == it.shape == (2, V)
    _, want_it, want_found = K4.diff_lookup_ref(
        port.state.drop.det.iters.reshape(2 * V, -1), port.state.drop.det.vals.reshape(2 * V, -1), 9)
    assert torch.equal(found.reshape(-1), want_found) and torch.equal(it.reshape(-1), want_it)
