"""Port parity: the vectorized graph layer equals the reference cell for cell.

``DynamicGraph`` construction, ``GraphSnapshot.to_ell`` and ``EllIndex`` are
vectorized in the port; on random insert+delete streams with slot recycling
they must reproduce the reference's one-edge-at-a-time loops exactly.
"""

import numpy as np
import pytest

from repro.core import graph as rg
from repro.data import graphgen as rgen
from repro_torch.core import graph as tg
from repro_torch.data import graphgen as tgen


def _stream(seed: int, v: int = 20, e: int = 60, batches: int = 6):
    rng = np.random.default_rng(seed)
    edges = rgen.uniform_graph(v, e, seed=seed)
    # a few labelled duplicates of one (u, v): distinct keys, same endpoints
    edges += [(edges[0][0], edges[0][1], 3.0, 2), (edges[1][0], edges[1][1], 4.0, 1)]
    initial, pool = edges[: e * 2 // 3] + edges[e:], edges[e * 2 // 3 : e]
    present = [(u, w, 0) for (u, w, *_x) in edges[: e * 2 // 3]]
    log = []
    for _ in range(batches):
        batch = []
        for _ in range(int(rng.integers(3, 7))):
            r = rng.random()
            if present and r < 0.45:
                u, w, lbl = present.pop(int(rng.integers(0, len(present))))
                batch.append((u, w, lbl, 1.0, -1))
            elif present and r < 0.55:  # weight update in place
                u, w, lbl = present[int(rng.integers(0, len(present)))]
                batch.append((u, w, lbl, float(rng.integers(1, 10)), +1))
            elif pool:
                u, w, x = pool.pop()
                batch.append((u, w, 0, x, +1))
                present.append((u, w, 0))
        batch.append((0, 1, 0, 1.0, -1) if (0, 1, 0) not in present else (0, 1, 0, 2.0, +1))
        log.append(batch)
    log.append([(u, 0, 0, 1.0, +1) for u in range(1, v)])  # a hub outgrows any row width
    return v, initial, log


def _same_graph(port: tg.DynamicGraph, ref: rg.DynamicGraph):
    pa, pm = port.state_dict()
    ra, rm = ref.state_dict()
    assert pm == rm
    for k in ra:
        np.testing.assert_array_equal(pa[k], ra[k], err_msg=k)
        assert pa[k].dtype == ra[k].dtype, k
    assert port._slot == ref._slot


def _same_index(port: tg.EllIndex, ref: rg.EllIndex):
    live = np.nonzero(port.row_of >= 0)[0]
    got = {int(s): (int(port.row_of[s]), int(port.col_of[s])) for s in live}
    assert got == ref.col_of
    np.testing.assert_array_equal(port.fill, ref.fill)
    assert port.free == ref.free


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("as_array", [False, True])
def test_graph_ell_and_index_match_reference(seed, as_array):
    v, initial, log = _stream(seed)
    ref = rg.DynamicGraph(v, initial, capacity=96)
    edges = initial
    if as_array:
        edges = np.asarray([(a, b, w, lbl[0] if lbl else 0) for (a, b, w, *lbl) in initial])
    port = tg.DynamicGraph(v, edges, capacity=96)
    _same_graph(port, ref)

    # indexes at exactly the max in-degree: an insert into a full row overflows
    rsnap, psnap = ref.snapshot(), port.snapshot()
    ridx = rg.EllIndex(rsnap, int(rsnap.in_degree.max()))
    pidx = tg.EllIndex(psnap, int(psnap.in_degree.max()))
    _same_index(pidx, ridx)
    overflows = 0
    for batch in log:
        rops = ref.apply_batch_resolved(batch)
        pops = port.apply_batch_resolved(batch)
        assert pops == rops
        _same_graph(port, ref)
        try:
            rw = ridx.writes_for(rops)
        except rg.EllOverflow as exc:
            with pytest.raises(tg.EllOverflow, match=str(exc)):
                pidx.writes_for(pops)
            overflows += 1
            rsnap, psnap = ref.snapshot(), port.snapshot()
            ridx = rg.EllIndex(rsnap, int(rsnap.in_degree.max()))
            pidx = tg.EllIndex(psnap, int(psnap.in_degree.max()))
        else:
            assert [vars(w) for w in pidx.writes_for(pops)] == [vars(w) for w in rw]
        _same_index(pidx, ridx)
        rsnap, psnap = ref.snapshot(), port.snapshot()
        for kw in ({}, {"min_width": 24}, {"pad_to_multiple": 4}):
            rn, rw_, rd = rsnap.to_ell(**kw)
            pn, pw, pd = psnap.to_ell(**kw)
            assert pd == rd
            np.testing.assert_array_equal(pn, rn)
            np.testing.assert_array_equal(pw, rw_)
            assert (pn.dtype, pw.dtype) == (rn.dtype, rw_.dtype)
        # a fresh index from the stream-worn snapshot (recycled slots)
        width = max(16, int(rsnap.in_degree.max()))
        _same_index(tg.EllIndex(psnap, width), rg.EllIndex(rsnap, width))
    assert overflows > 0


def _churn(seed: int, v: int = 12, batches: int = 8):
    """Initial edges with repeated (u, v, label) keys and labelled twins of
    one pair, then batches that delete, re-insert, re-weight and insert
    keys drawn from a small pool, so keys repeat within and across batches
    and freed slots are recycled."""
    rng = np.random.default_rng(seed)
    pool = [(int(a), int(b), int(lbl)) for a, b, lbl in rng.integers(0, [v, v, 3], (24, 3))]
    initial = [(*pool[int(i)][:2], float(rng.integers(1, 9)), pool[int(i)][2])
               for i in rng.integers(0, len(pool), 30)]
    initial += [(0, 1, 2.0, 0), (0, 1, 3.0, 1), (0, 1, 4.0, 0)]  # a repeat keeps its last slot
    log = []
    for _ in range(batches):
        batch = []
        for _ in range(int(rng.integers(4, 12))):
            a, b, lbl = pool[int(rng.integers(0, len(pool)))]
            sign = 1 if rng.random() < 0.55 else -1
            batch.append((a, b, lbl, float(rng.integers(1, 9)), sign))
        log.append(batch)
    return v, initial, log


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("built_by", ["init", "from_state", "transpose"])
def test_slot_index_matches_the_references_dict(seed, built_by):
    """The port's ``SlotIndex`` (sorted edge keys plus a dict of edits)
    against the reference's tuple-keyed ``_slot`` dict on streams that
    delete, re-insert and repeat keys: every batch's resolved ops, the slot
    each insert recycles, ``state_dict`` and the index itself equal, for a
    graph built from edges, restored by ``from_state`` (after half the
    stream) and transposed by ``transpose_graph``."""
    _check_slot_index(seed, built_by)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("built_by", ["init", "from_state", "transpose"])
def test_slot_index_folds_its_edits_and_still_matches_the_references_dict(seed, built_by, monkeypatch):
    """The same streams with the index folding its edits into the sorted
    arrays as soon as they outnumber them: the ops, recycling, state and
    the index still equal the reference's, and the dict of edits never
    holds more than an eighth of the sorted arrays."""
    monkeypatch.setattr(tg.SlotIndex, "FOLD_MIN", 0)
    monkeypatch.setattr(tg.SlotIndex, "FOLD_FRACTION", 8)
    folds = []
    fold = tg.SlotIndex._fold
    monkeypatch.setattr(tg.SlotIndex, "_fold", lambda self: (folds.append(len(self._edits)), fold(self)))
    _check_slot_index(seed, built_by, bound_edits=True)
    assert folds


def _check_slot_index(seed, built_by, bound_edits=False):
    from repro.core import landmark as rlm
    from repro_torch.core import landmark as tlm

    v, initial, log = _churn(seed)
    ref = rg.DynamicGraph(v, initial, capacity=64)
    port = tg.DynamicGraph(v, initial, capacity=64)
    half = len(log) // 2
    if built_by != "init":
        for batch in log[:half]:
            assert port.apply_batch_resolved(batch) == ref.apply_batch_resolved(batch)
        if built_by == "from_state":
            arrays, meta = ref.state_dict()
            ref = rg.DynamicGraph.from_state(meta, arrays)
            port = tg.DynamicGraph.from_state(meta, port.state_dict()[0])
        else:
            ref, port = rlm.transpose_graph(ref), tlm.transpose_graph(port)
        log = [rlm.transpose_updates(b) for b in log[half:]] if built_by == "transpose" else log[half:]
    assert isinstance(port._slot, tg.SlotIndex)
    _same_graph(port, ref)
    twin = port._slot.copy()  # chip_smoke's graph copies: independent edits
    twin[(v, v, 0)] = 7
    del twin[next(iter(port._slot))]
    assert (v, v, 0) not in port._slot and dict(port._slot) == ref._slot
    u0, v0, l0 = next(iter(port._slot))  # a key past V never aliases another pair
    assert (u0 - 1, v0 + v, l0) not in port._slot and port._slot.get((u0 - 1, v0 + v, l0)) is None
    for batch in log:
        assert port.apply_batch_resolved(batch) == ref.apply_batch_resolved(batch)
        _same_graph(port, ref)
        assert sorted(port._slot) == sorted(ref._slot) and len(port._slot) == len(ref._slot)
        if bound_edits:
            assert len(port._slot._edits) <= port._slot._base()[0].shape[0] // 8


def test_ell_index_overflow_names_the_same_vertex():
    edges = [(i, 7, 1.0) for i in range(7)] + [(i, 3, 1.0) for i in range(4, 7)]
    ref = rg.DynamicGraph(8, edges, capacity=32).snapshot()
    port = tg.DynamicGraph(8, edges, capacity=32).snapshot()
    with pytest.raises(rg.EllOverflow) as want:
        rg.EllIndex(ref, 2)
    with pytest.raises(tg.EllOverflow, match=str(want.value)):
        tg.EllIndex(port, 2)


def test_graph_from_state_and_unweighted():
    v, initial, log = _stream(5)
    ref = rg.DynamicGraph(v, initial, capacity=96, weighted=False)
    port = tg.DynamicGraph(v, initial, capacity=96, weighted=False)
    _same_graph(port, ref)
    for batch in log[:3]:
        ref.apply_batch(batch)
        port.apply_batch(batch)
    arrays, meta = port.state_dict()
    _same_graph(tg.DynamicGraph.from_state(meta, arrays), rg.DynamicGraph.from_state(meta, arrays))
    with pytest.raises(ValueError):
        tg.DynamicGraph(4, [(0, 1, 1.0)] * 20, capacity=8)


def test_graphgen_is_the_reference_generator():
    assert tgen.uniform_graph(30, 80, seed=2) == rgen.uniform_graph(30, 80, seed=2)
    assert tgen.powerlaw_graph(30, 80, seed=2, num_labels=3) == rgen.powerlaw_graph(
        30, 80, seed=2, num_labels=3
    )
    e = rgen.uniform_graph(30, 80, seed=4)
    assert tgen.split_90_10(e, seed=1) == rgen.split_90_10(e, seed=1)
    kw = dict(num_batches=4, batch_size=5, delete_fraction=0.3, seed=3)
    assert tgen.update_stream(e, 30, **kw) == rgen.update_stream(e, 30, **kw)
