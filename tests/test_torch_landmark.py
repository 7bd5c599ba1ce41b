"""Port parity: the landmark index (``core/landmark.py``, paper §6.6).

The same inputs, made from a numpy seed, go through the JAX reference and
the port with ``device="cpu"``.  Min-plus is held bit for bit: the
transposed graph, the landmark choice, the triangle bounds, and the pruned
Bellman-Ford's ``final``, ``iters`` and ``work`` (the Fig. 9 meter).
"""

import functools

import numpy as np
import pytest
import torch

from repro.core import landmark as rlm
from repro.core import semiring as rsr
from repro.core.graph import DynamicGraph as RGraph
from repro.core.queries import sssp as rsssp
from repro.data.graphgen import powerlaw_graph
from repro_torch.core import landmark as tlm
from repro_torch.core import semiring as tsr
from repro_torch.core.graph import DynamicGraph as TGraph

CPU = "cpu"
V = 64


def _graphs(seed=6, e=256, capacity=2048):
    edges = powerlaw_graph(V, e, seed=seed)
    return edges, RGraph(V, edges, capacity=capacity), TGraph(V, edges, capacity=capacity)


def _stream(seed, n=12):
    """Inserts and deletes of existing edges, in the paper's update form."""
    edges, _, _ = _graphs()
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        if k % 3 == 2:
            u, v, w = edges[int(rng.integers(len(edges)))]
            out.append((int(u), int(v), 0, float(w), -1))
        else:
            out.append((int(rng.integers(V)), int(rng.integers(V)), 0, float(rng.integers(1, 9)), 1))
    return out


def _same_graph(port, ref):
    for name in ("src", "dst", "weight", "label", "valid", "out_degree", "in_degree"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name), err_msg=name)
    assert port._slot == ref._slot
    assert port._free == ref._free
    assert port.num_vertices == ref.num_vertices and port.capacity == ref.capacity


def test_transpose_graph_and_updates_match_reference():
    _, rg, tg = _graphs()
    ups = _stream(1)
    rg.apply_batch(ups[:6])
    tg.apply_batch(ups[:6])
    rt, tt = rlm.transpose_graph(rg), tlm.transpose_graph(tg)
    _same_graph(tt, rt)
    assert tlm.transpose_updates(ups) == rlm.transpose_updates(ups)
    rt.apply_batch(rlm.transpose_updates(ups[6:]))
    tt.apply_batch(tlm.transpose_updates(ups[6:]))
    _same_graph(tt, rt)


@pytest.mark.parametrize("num_landmarks", [1, 3, 10])
def test_select_landmarks_matches_reference(num_landmarks):
    _, rg, tg = _graphs(seed=9)
    assert tlm.select_landmarks(tg, num_landmarks) == rlm.select_landmarks(rg, num_landmarks)


def test_source_init_and_engine_cfg_match_reference():
    np.testing.assert_array_equal(tlm.source_init([3, 0, 3], V, 1.5), rlm.source_init([3, 0, 3], V, 1.5))
    cfg = tlm.engine_cfg(3, V, tsr.min_plus(), max_iters=17)
    assert (cfg.num_queries, cfg.num_vertices, cfg.max_iters, cfg.mode) == (3, V, 17, "jod")
    assert not cfg.drop.enabled() and not cfg.weight_from_degree


@functools.lru_cache(maxsize=None)
def _fields(seed, num_landmarks=4):
    """Index fields [L, V] (infinities included: unreachable vertices) from
    the reference's own index, plus random queries."""
    _, rg, _ = _graphs(seed=seed)
    idx = rlm.LandmarkIndex(rg, rlm.select_landmarks(rg, num_landmarks), max_iters=32)
    rng = np.random.default_rng(seed)
    sources = [int(x) for x in rng.integers(V, size=5)]
    targets = [int(x) for x in rng.integers(V, size=5)]
    return np.asarray(idx.fwd), np.asarray(idx.rev), sources, targets


@pytest.mark.parametrize("seed", [0, 6, 13])
def test_triangle_bounds_match_reference(seed):
    fwd, rev, sources, targets = _fields(seed)
    fwd, rev = fwd.copy(), rev.copy()
    assert np.isinf(fwd).any() and np.isinf(rev).any()  # inf − inf → nan → 0 is exercised
    rlb, rub = rlm.triangle_bounds(fwd, rev, sources, targets)
    tlb, tub = tlm.triangle_bounds(torch.from_numpy(fwd), torch.from_numpy(rev), sources, targets)
    np.testing.assert_array_equal(tlb.numpy(), rlb)
    np.testing.assert_array_equal(tub.numpy(), rub)
    assert tlb.dtype == torch.float32 and tub.dtype == torch.float32
    # arrays are accepted as well as tensors
    np.testing.assert_array_equal(tlm.triangle_bounds(fwd, rev, sources, targets)[0].numpy(), rlb)


@pytest.mark.parametrize("bounds", [True, False])
@pytest.mark.parametrize("seed", [6, 13])
def test_pruned_scratch_run_matches_reference(seed, bounds):
    """``final``, ``iters`` and ``work`` equal, with the index's bounds and
    with ``None`` (plain scratch)."""
    fwd, rev, sources, targets = _fields(seed)
    _, rg, tg = _graphs(seed=seed)
    if not bounds:
        fwd = rev = None
    rcfg = rlm.engine_cfg(len(sources), V, rsr.min_plus(), max_iters=32)
    tcfg = tlm.engine_cfg(len(sources), V, tsr.min_plus(), max_iters=32)
    rfinal, riters, rwork = rlm.pruned_scratch_run(rcfg, rg, sources, targets, fwd, rev)
    tfinal, titers, twork = tlm.pruned_scratch_run(tcfg, tg, sources, targets, fwd, rev, device=CPU)
    np.testing.assert_array_equal(tfinal.numpy(), rfinal)
    assert (titers, twork) == (riters, rwork)
    assert isinstance(twork, int) and titers > 1
    if not bounds:
        assert twork == titers * len(sources) * V  # nothing pruned


def test_pruned_work_is_the_live_slot_count_in_int64(monkeypatch):
    """With trivial bounds every slot is live at every iteration; the meter
    is summed in int64 (the reference's int32 would near 2^31 at the
    real-size cell: Q = 8, V = 3,774,768, 49 iterations)."""
    _, _, tg = _graphs()
    cfg = tlm.engine_cfg(2, V, tsr.min_plus(), max_iters=4)
    from repro_torch.core.engine import GraphArrays

    g = GraphArrays.from_snapshot(tg.snapshot(), device=CPU)
    init = torch.from_numpy(tlm.source_init([0, 1], V))
    _, iters, work = tlm._pruned_bf(cfg, g, init, torch.zeros(2, V), torch.full((2,), torch.inf))
    assert work == iters * 2 * V
    sums = []
    real_sum = torch.Tensor.sum

    def spy(self, *args, **kw):
        out = real_sum(self, *args, **kw)
        sums.append(out.dtype)
        return out

    monkeypatch.setattr(torch.Tensor, "sum", spy)
    tlm._pruned_bf(cfg, g, init, torch.zeros(2, V), torch.full((2,), torch.inf))
    assert sums and set(sums) == {torch.int64}


def test_landmark_index_matches_reference():
    """The direct-engine index: both fields and its bytes, before and after
    a stream with deletions."""
    _, rg, tg = _graphs(seed=3)
    lms = rlm.select_landmarks(rg, 4)
    ref = rlm.LandmarkIndex(rg, lms, max_iters=32)
    port = tlm.LandmarkIndex(tg, lms, max_iters=32, device=CPU)
    for batch in (None, _stream(2)[:6], _stream(2)[6:]):
        if batch is not None:
            ref.apply_updates(batch)
            port.apply_updates(batch)
        np.testing.assert_array_equal(port.fwd, np.asarray(ref.fwd))
        np.testing.assert_array_equal(port.rev, np.asarray(ref.rev))
        assert port.nbytes() == ref.nbytes()


def test_landmark_index_and_pruned_scratch():
    """``tests/test_runtime.py::test_landmark_index_and_pruned_scratch`` on
    both packages: SCRATCH-LANDMARK equals un-pruned SSSP at the targets,
    before and after an update, and the port's iters and work equal the
    reference's."""
    edges, rg, tg = _graphs(seed=6)
    queries = [(0, 9), (3, 40), (11, 2)]
    ref = rlm.ScratchLandmark(rg, queries, num_landmarks=5, max_iters=32)
    port = tlm.ScratchLandmark(tg, queries, num_landmarks=5, max_iters=32, device=CPU)
    oracle = rsssp(RGraph(V, edges, capacity=2048), [s for s, _ in queries], max_iters=32)
    for upd in (None, [(0, 40, 0, 1.0, +1)]):
        if upd is not None:
            ref.apply_updates(upd)
            port.apply_updates(upd)
            oracle.apply_updates(upd)
        want = np.asarray(oracle.answers())[np.arange(3), [t for _, t in queries]]
        np.testing.assert_array_equal(port.answers(), want)
        np.testing.assert_array_equal(port.answers(), np.asarray(ref.answers()))
        assert (port.last_iters, port.last_work) == (ref.last_iters, ref.last_work)
        np.testing.assert_array_equal(port._dists.numpy(), ref._dists)
        assert port.nbytes() == ref.nbytes()
