"""Port parity: partial dropping and ``backend="fused"`` through the engine.

The same workloads go through the JAX reference (its Pallas kernels in
interpret mode) and the port with ``device="cpu"``, where ``fused_sweep``
runs its plain version.  For the min family every state leaf — difference
store, DroppedVT (Det store, Bloom bits, ``det_overflow``, ``max_iter``),
``repair_counts`` — and every ``MaintainStats`` field and ``nbytes()`` must
be equal; PageRank's answers are held at ``rtol=1e-6``.
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from repro.core import dropping as rdr
from repro.core import engine as reng
from repro.core import plan as rplan
from repro.core import queries as rq
from repro.core.graph import DynamicGraph as RGraph
from repro_torch.core import convert
from repro_torch.core import dropping as tdr
from repro_torch.core import engine as teng
from repro_torch.core import plan as tplan
from repro_torch.core import queries as tq
from repro_torch.core.graph import DynamicGraph as TGraph
from test_torch_engine import _ref_leaves, _same_stats, _symmetric, random_workload

V = 24
CPU = "cpu"
MAX_ITERS = 24

# the policies of the reference's tests/test_fused_sweep.py
DROPS = {
    "none": None,
    "det": dict(mode="det", selection="random", p=0.4, seed=7),
    "prob": dict(mode="prob", selection="random", p=0.4, seed=7, bloom_bits=1 << 12),
}


def _drop_kw(mod, mode):
    return {} if DROPS[mode] is None else {"drop": mod.DropConfig(**DROPS[mode])}


def _sssp_pair(initial, backend, mode, ref_backend=None):
    """(reference, port) SSSP engines on copies of one graph."""
    ref = rq.sssp(RGraph(V, initial, capacity=512), [0, V // 2], max_iters=MAX_ITERS,
                  backend=ref_backend or backend, batch_capacity=4, **_drop_kw(rdr, mode))
    port = tq.sssp(TGraph(V, initial, capacity=512), [0, V // 2], max_iters=MAX_ITERS, backend=backend,
                   batch_capacity=4, device=CPU, **_drop_kw(tdr, mode))
    return ref, port


def _port_leaves(state) -> dict:
    return convert.engine_state_to_numpy(state)


def _all_ref_leaves(state) -> dict:
    """The reference state as the flat leaves of ``core/convert.py``."""
    st = jax.tree.map(np.asarray, state)
    out = _ref_leaves(state)
    if st.drop.det is not None:
        out.update({f"drop_det/{k}": getattr(st.drop.det, k) for k in ("iters", "vals", "count")})
    if st.drop.flt is not None:
        out["drop_flt/bits"] = np.asarray(st.drop.flt.bits)
        out["drop_flt/num_hashes"] = np.asarray(state.drop.flt.num_hashes)
    if st.drop.params is not None:
        out.update({f"drop_params/{f}": np.asarray(getattr(st.drop.params, f)) for f in rdr.DropParams._fields})
    return out


def _same_state(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


def _same_engine(port, ref):
    np.testing.assert_array_equal(port.answers(), ref.answers())
    _same_state(_port_leaves(port.state), _all_ref_leaves(ref.state))
    _same_stats(port.last_stats, ref.last_stats)
    assert port.nbytes() == ref.nbytes()


def _stream(engines, batches, path):
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


# ------------------------------------------------------------ the parity matrix
@pytest.mark.parametrize("path", ["apply_updates", "batched"])
@pytest.mark.parametrize("mode", ["none", "det", "prob"])
def test_fused_parity_matrix(mode, path):
    """The reference's fused parity matrix, JOD rows: port ``fused`` = port
    ``ell`` = reference ``fused`` = reference ``ell``, leaf for leaf."""
    initial, batches = random_workload(seed=11)
    ref_fused, port_fused = _sssp_pair(initial, "fused", mode)
    ref_ell, port_ell = _sssp_pair(initial, "ell", mode)
    engines = (ref_fused, port_fused, ref_ell, port_ell)
    _same_engine(port_fused, ref_fused)
    for _ in _stream(engines, batches, path):
        _same_engine(port_fused, ref_fused)
        _same_engine(port_ell, ref_ell)
        _same_engine(port_fused, ref_ell)


def _semiring_engines(mod, graph_mod, semiring, backend, device_kw):
    initial, _ = random_workload(seed=5)
    g = graph_mod(V, initial, capacity=512)
    if semiring == "min_hop":
        return mod.khop(g, [0, 3], k=6, backend=backend, **device_kw)
    if semiring == "min_label":
        sym, _ = _symmetric(initial, [])
        return mod.wcc(graph_mod(V, sym, capacity=512), max_iters=MAX_ITERS, backend=backend, **device_kw)
    return mod.pagerank(g, iters=12, backend=backend, **device_kw)


@pytest.mark.parametrize("semiring", ["min_hop", "min_label", "pr_sum"])
def test_fused_semiring_parity(semiring):
    """``fused`` equals ``ell`` in the port for the other three semirings,
    and both equal the reference (PageRank at rtol 1e-6)."""
    _, batches = random_workload(seed=5)
    if semiring == "min_label":
        _, batches = _symmetric([], batches)
    ref = _semiring_engines(rq, RGraph, semiring, "ell", {})
    fused = _semiring_engines(tq, TGraph, semiring, "fused", {"device": CPU})
    ell = _semiring_engines(tq, TGraph, semiring, "ell", {"device": CPU})
    for step in range(len(batches) + 1):
        if step:
            for e in (ref, fused, ell):
                e.apply_updates(batches[step - 1])
        np.testing.assert_array_equal(fused.answers(), ell.answers())
        _same_state(_port_leaves(fused.state), _port_leaves(ell.state))
        _same_stats(fused.last_stats, ell.last_stats)
        if semiring == "pr_sum":
            np.testing.assert_allclose(fused.answers(), ref.answers(), rtol=1e-6)
        else:
            _same_engine(fused, ref)


@pytest.mark.parametrize("path", ["apply_updates", "batched"])
@pytest.mark.parametrize("mode", ["det", "prob"])
def test_stitched_coo_dropping_matches_reference(mode, path):
    initial, batches = random_workload(seed=3)
    ref, port = _sssp_pair(initial, "coo", mode)
    _same_engine(port, ref)
    assert int(port.last_stats.dropped) > 0
    for _ in _stream((ref, port), batches, path):
        _same_engine(port, ref)


def test_prob_drop_false_positives_never_change_answers():
    """A filter small enough to saturate makes nearly every probe positive:
    many spurious repairs, answers still equal to SCRATCH's."""
    from repro_torch.core.scratch import scratch_like

    initial, batches = random_workload(seed=8)
    cfg = tdr.DropConfig(mode="prob", p=0.8, seed=3, bloom_bits=64, bloom_hashes=2)
    port = tq.sssp(TGraph(V, initial, capacity=512), [0, 5, 9], max_iters=MAX_ITERS, backend="fused",
                   drop=cfg, device=CPU)
    for batch in batches:
        port.apply_updates(batch)
    sc = scratch_like(port.cfg, TGraph(V, initial, capacity=512), port.state.init, device=CPU)
    for batch in batches:
        sc.apply_updates(batch)
    np.testing.assert_array_equal(port.answers(), sc.answers())
    assert float(port.state.drop.flt.bits.float().mean()) > 0.5
    assert int(port.state.repair_counts.sum()) > 0


# --------------------------------------------------------------- dispatch
@pytest.mark.parametrize("backend", ["ell", "fused"])
def test_fused_dispatch_once_per_sweep_iteration(backend, monkeypatch):
    """Under ``fused`` every sweep iteration enters ``fused_sweep`` exactly
    once and ``ell_spmv`` never; under ``ell`` the reverse.  The counters
    wrap the engine's own references, so they count on the CPU too."""
    calls = {"fused_sweep": 0, "ell_spmv": 0}

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(teng, "fused_sweep", counting("fused_sweep", teng.fused_sweep))
    monkeypatch.setattr(teng, "ell_spmv", counting("ell_spmv", teng.ell_spmv))
    initial, batches = random_workload(seed=11)
    port = tq.sssp(TGraph(V, initial, capacity=512), [0, V // 2], max_iters=MAX_ITERS, backend=backend,
                   drop=tdr.DropConfig(**DROPS["det"]), batch_capacity=4, device=CPU)
    iters = int(port.last_stats.iters_run)
    iters += int(port.apply_updates_batched([u for b in batches for u in b], batch_size=4).iters_run)
    assert iters > 2
    want = {"fused_sweep": iters, "ell_spmv": 0} if backend == "fused" else {"fused_sweep": 0, "ell_spmv": iters}
    assert calls == want


# ------------------------------------------------------------ in place
def _store_leaves(state) -> dict:
    out = {f"dstore/{k}": getattr(state.dstore, k).clone() for k in ("iters", "vals", "count")}
    if state.drop.det is not None:
        out.update({f"det/{k}": getattr(state.drop.det, k).clone() for k in ("iters", "vals", "count")})
    return out


@pytest.mark.parametrize("engine_mode", ["jod", "vdc"])
@pytest.mark.parametrize("mode", ["none", "det", "prob"])
def test_fused_sweep_in_place_leaves_the_input_state(mode, engine_mode, monkeypatch):
    """On ``fused`` the sweep writes its D and Det stores in place from the
    second iteration on, never the first: ``maintain`` (``apply_updates``)
    and ``batched_step`` (``apply_updates_batched``) leave the state they
    were given bit-unchanged, and the port still equals the reference."""
    forms = []

    def recording(*args, **kw):
        forms.append(kw["inplace"])
        return fused_sweep(*args, **kw)

    fused_sweep = teng.fused_sweep
    monkeypatch.setattr(teng, "fused_sweep", recording)
    initial, batches = random_workload(seed=11)
    kw = dict(max_iters=MAX_ITERS, backend="fused", batch_capacity=4, mode=engine_mode)
    ref = rq.sssp(RGraph(V, initial, capacity=512), [0, V // 2], **kw, **_drop_kw(rdr, mode))
    port = tq.sssp(TGraph(V, initial, capacity=512), [0, V // 2], device=CPU, **kw, **_drop_kw(tdr, mode))
    for step, batch in enumerate(batches[:4]):
        state, before = port.state, _store_leaves(port.state)
        forms.clear()
        if step % 2:
            port.apply_updates_batched(batch, batch_size=4)
            ref.apply_updates_batched(batch, batch_size=4)
        else:
            port.apply_updates(batch)
            ref.apply_updates(batch)
        after = _store_leaves(state)
        assert after.keys() == before.keys()
        for k in before:
            assert torch.equal(after[k], before[k]), k
        assert port.state.dstore.iters.data_ptr() != state.dstore.iters.data_ptr()
        assert forms and not forms[0] and all(forms[1:])
        np.testing.assert_array_equal(port.answers(), ref.answers())
        assert port.nbytes() == ref.nbytes()


# ------------------------------------------------------------ carry-across
@pytest.mark.parametrize("mode", ["det", "prob"])
def test_drop_state_carries_across_from_reference(mode):
    """The reference runs k batches; its state (DroppedVT included) and
    graph arrays move into the port; both run batch k+1 on ``fused`` and
    every leaf matches."""
    initial, batches = random_workload(seed=11, num_batches=4)
    ref, _ = _sssp_pair(initial, "fused", mode)
    ref.apply_updates_batched([u for b in batches[:3] for u in b], batch_size=4)

    leaves = _all_ref_leaves(ref.state)
    state = convert.engine_state_from_numpy(leaves, CPU)
    _same_state(convert.engine_state_to_numpy(state), leaves)
    assert int(state.drop.max_iter) > 0
    g = convert.graph_arrays_from_numpy(
        {f: (None if x is None else np.asarray(x)) for f, x in ref.g._asdict().items()}, CPU
    )
    ops = ref.graph.apply_batch_resolved(batches[3])
    upd = ref._encode_chunk(ops, ref._ell_index.writes_for(ops), 8)
    tupd = convert.update_batch_from_numpy({f: np.asarray(x) for f, x in upd._asdict().items()}, CPU)
    cfg = teng.EngineConfig(**{
        f.name: getattr(ref.cfg, f.name) for f in teng.dataclasses.fields(teng.EngineConfig) if f.name != "drop"
    }, drop=tdr.DropConfig(**DROPS[mode]))

    rstate, _, rstats = jax.jit(partial(reng.batched_step, ref.cfg))(ref.state, ref.g, upd)
    tstate, _, tstats = teng.batched_step(cfg, state, g, tupd)
    _same_state(convert.engine_state_to_numpy(tstate), _all_ref_leaves(rstate))
    _same_stats(tstats, rstats)
    assert teng.nbytes_accounted(cfg, tstate) == reng.nbytes_accounted(ref.cfg, rstate)


# ------------------------------------------------------------ per-query policies
@pytest.mark.parametrize("backend", ["coo", "fused"])
@pytest.mark.parametrize("mode", ["det", "prob"])
def test_drop_rows_carry_each_plans_policy(mode, backend):
    """Two plans with different drop policies in one engine: each slot
    selects with its own row (``drop_rows``), as in the reference."""
    initial, batches = random_workload(seed=12)
    pol = [dict(mode=mode, selection="random", p=0.9, seed=5, bloom_bits=1 << 12),
           dict(mode=mode, selection="degree", p=0.3, tau_min=4.0, tau_max=9.0, seed=2**32 - 3,
                bloom_bits=1 << 12)]

    def build(mod, plan_mod, drmod, graph_mod, **kw):
        plans = [plan_mod.sssp(s, max_iters=MAX_ITERS, drop=drmod.DropConfig(**p)) for s, p in zip((0, 7), pol)]
        return mod.engine_from_plans(graph_mod(V, initial, capacity=512), plans, backend=backend, **kw)

    ref = build(rq, rplan, rdr, RGraph)
    port = build(tq, tplan, tdr, TGraph, device=CPU)
    np.testing.assert_array_equal(port.state.drop.params.p.numpy(), np.float32([0.9, 0.3]))
    _same_engine(port, ref)
    for batch in batches:
        ref.apply_updates(batch)
        port.apply_updates(batch)
        _same_engine(port, ref)
