"""Port parity: the dense Diff-IFE engine (JOD, ``coo``/``ell``) on the CPU.

The same inputs go through the JAX reference (its ELL kernel in interpret
mode) and the port with ``device="cpu"``.  For the min family the answers,
the difference-store leaves, every ``MaintainStats`` field and ``nbytes()``
must be equal; PageRank's answers are held at ``rtol=1e-6`` (its sums may
reassociate, DESIGN.md §8), and its store leaves are not compared: change
points are detected by exact float comparison.
"""

import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as reng
from repro.core import queries as rq
from repro.core import scratch as rscratch
from repro.core.graph import DynamicGraph as RGraph
from repro_torch.core import convert
from repro_torch.core import dropping as tdr
from repro_torch.core import engine as teng
from repro_torch.core import queries as tq
from repro_torch.core import scratch as tscratch
from repro_torch.core.graph import DynamicGraph as TGraph
from repro_torch.launch.mesh import make_data_mesh

V = 24
CPU = "cpu"


# ----------------------------------------------------------------- workloads
def random_workload(seed: int, v: int = V, e: int = 96, num_batches: int = 4):
    """(initial edges, update batches) with insertion + deletion mixes — the
    generator of ``tests/test_ell_and_batched.py``."""
    rng = np.random.default_rng(seed)
    seen = {}
    while len(seen) < e:
        u, w = int(rng.integers(0, v)), int(rng.integers(0, v))
        if u != w:
            seen[(u, w)] = (u, w, float(rng.integers(1, 10)))
    edges = list(seen.values())
    initial, pool = edges[: e * 3 // 4], edges[e * 3 // 4 :]
    present = {(u, w) for (u, w, _x) in initial}
    batches = []
    for _ in range(num_batches):
        batch = []
        for _ in range(int(rng.integers(2, 5))):
            if present and rng.random() < 0.4:
                u, w = sorted(present)[int(rng.integers(0, len(present)))]
                batch.append((u, w, 0, 1.0, -1))
                present.discard((u, w))
            elif pool:
                u, w, x = pool.pop()
                batch.append((u, w, 0, x, +1))
                present.add((u, w))
        batches.append(batch)
    return initial, batches


def _symmetric(initial, batches):
    """WCC runs on a graph carrying both directions of every edge."""
    sym = lambda es: es + [(b, a, x) for (a, b, x) in es]  # noqa: E731
    back = lambda bs: [u for (a, b, l, x, s) in bs for u in ((a, b, l, x, s), (b, a, l, x, s))]  # noqa: E731
    return sym(initial), [back(b) for b in batches]


def _build(query: str, initial, backend: str, batch_capacity: int = 8):
    """(reference engine, port engine) for one query family on copies of
    one initial graph."""
    rg, tg = RGraph(V, initial, capacity=512), TGraph(V, initial, capacity=512)
    common = dict(backend=backend, batch_capacity=batch_capacity)
    if query == "sssp":
        make = lambda m, g, **k: m.sssp(g, [0, V // 2], max_iters=24, **common, **k)  # noqa: E731
    elif query == "khop":
        make = lambda m, g, **k: m.khop(g, [0, V // 2], k=4, **common, **k)  # noqa: E731
    elif query == "wcc":
        make = lambda m, g, **k: m.wcc(g, max_iters=24, **common, **k)  # noqa: E731
    else:
        make = lambda m, g, **k: m.pagerank(g, iters=8, **common, **k)  # noqa: E731
    return make(rq, rg), make(tq, tg, device=CPU)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_stats(got, want):
    assert got._fields == want._fields
    for f in want._fields:
        g, w = _np(getattr(got, f)), _np(getattr(want, f))
        np.testing.assert_array_equal(g, w, err_msg=f)
        assert g.dtype == w.dtype == np.int32, f


def _same_store(got, want):
    for name, g, w in zip(("iters", "vals", "count"), got, want):
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=name)
        assert _np(g).dtype == _np(w).dtype, name


def _same_engine(port: teng.DiffIFE, ref: reng.DiffIFE, query: str):
    if query == "pagerank":
        np.testing.assert_allclose(port.answers(), ref.answers(), rtol=1e-6)
        return
    np.testing.assert_array_equal(port.answers(), ref.answers())
    _same_store(port.state.dstore, ref.state.dstore)
    _same_stats(port.last_stats, ref.last_stats)
    assert port.nbytes() == ref.nbytes()


# --------------------------------------------------------------- Fig. 2 trace
FIG2_EDGES = [
    (0, 1, 30.0), (1, 2, 10.0), (2, 3, 10.0), (0, 3, 20.0),
    (3, 4, 10.0), (0, 4, 10.0), (3, 2, 20.0),
]
FIG2_UPDATES = [[(0, 3, 0, 100.0, +1)], [(1, 2, 0, 100.0, +1)]]
FIG2_DIST = [[0, 30, 40, 20, 10], [0, 30, 40, 50, 10], [0, 30, 120, 100, 10]]


@pytest.mark.parametrize("backend", ["coo", "ell"])
def test_fig2_trace_matches_reference(backend):
    ref = rq.sssp(RGraph(5, FIG2_EDGES, capacity=16), [0], mode="jod", max_iters=16, backend=backend)
    port = tq.sssp(TGraph(5, FIG2_EDGES, capacity=16), [0], max_iters=16, backend=backend, device=CPU)
    for version in range(3):
        if version:
            ref.apply_updates(FIG2_UPDATES[version - 1])
            port.apply_updates(FIG2_UPDATES[version - 1])
        np.testing.assert_array_equal(port.answers()[0], FIG2_DIST[version])
        _same_engine(port, ref, "sssp")
        assert port.state.dstore.iters.dtype == torch.int32
        assert port.state.dstore.count.dtype == torch.int32


# ----------------------------------------------------------- random workloads
@pytest.mark.parametrize("query,seed", [("sssp", 0), ("khop", 1), ("wcc", 2), ("pagerank", 9)])
@pytest.mark.parametrize("backend", ["coo", "ell"])
@pytest.mark.parametrize("path", ["apply_updates", "batched"])
def test_random_workload_matches_reference(query, seed, backend, path):
    initial, batches = random_workload(seed)
    if query == "wcc":
        initial, batches = _symmetric(initial, batches)
    ref, port = _build(query, initial, backend, batch_capacity=4)
    _same_engine(port, ref, query)
    if path == "apply_updates":
        for batch in batches:
            ref.apply_updates(batch)
            port.apply_updates(batch)
            _same_engine(port, ref, query)
    else:
        log = [u for b in batches for u in b]
        ref.apply_updates_batched(log, batch_size=4)
        port.apply_updates_batched(log, batch_size=4)
        _same_engine(port, ref, query)


def test_batched_ell_width_growth_matches_reference():
    """Inserts that outrun the fixed ELL width take the rebuild fallback."""
    initial = [(i, i + 1, 1.0) for i in range(10)]
    ref = rq.sssp(RGraph(12, initial, capacity=256), [0], max_iters=16, backend="ell", batch_capacity=4)
    port = tq.sssp(TGraph(12, initial, capacity=256), [0], max_iters=16, backend="ell",
                   batch_capacity=4, device=CPU)
    hub = [(i, 11, 0, 1.0, +1) for i in range(11)]  # in-degree 11 > width 8
    ref.apply_updates_batched(hub, batch_size=4)
    port.apply_updates_batched(hub, batch_size=4)
    assert port._ell_width == ref._ell_width > 8
    _same_engine(port, ref, "sssp")
    np.testing.assert_array_equal(port.g.nbr.numpy(), np.asarray(ref.g.nbr))


# ------------------------------------------------------------------ scratch
@pytest.mark.parametrize("query", ["sssp", "pagerank"])
@pytest.mark.parametrize("backend", ["coo", "ell"])
def test_scratch_run_matches_reference(query, backend):
    initial, batches = random_workload(seed=7)
    ref, port = _build(query, initial, backend)
    for batch in batches[:2]:
        ref.apply_updates(batch)
        port.apply_updates(batch)
    rs = rscratch.scratch_like(ref.cfg, RGraph(V, initial, capacity=512), ref.state.init)
    ts = tscratch.scratch_like(port.cfg, TGraph(V, initial, capacity=512), port.state.init, device=CPU)
    for batch in batches[:2]:
        rs.apply_updates(batch)
        ts.apply_updates(batch)
    _same_stats(ts.last_stats, rs.last_stats)
    if query == "pagerank":
        np.testing.assert_allclose(ts.answers(), rs.answers(), rtol=1e-6)
    else:
        np.testing.assert_array_equal(ts.answers(), rs.answers())
        np.testing.assert_array_equal(ts.answers(), port.answers())


# ------------------------------------------------------------ carry-across
def _ref_leaves(state) -> dict:
    st = jax.tree.map(np.asarray, state)
    return {
        "dstore/iters": st.dstore.iters, "dstore/vals": st.dstore.vals,
        "dstore/count": st.dstore.count,
        "drop/det_overflow": st.drop.det_overflow, "drop/max_iter": st.drop.max_iter,
        "init": st.init, "cur": st.cur, "repair_counts": st.repair_counts, "active": st.active,
    }


@pytest.mark.parametrize("backend", ["coo", "ell"])
def test_state_carries_across_from_reference(backend):
    """The reference runs k batches; its state and graph arrays move into the
    port; both run batch k+1 and every leaf matches."""
    initial, batches = random_workload(seed=11, num_batches=4)
    ref, _ = _build("sssp", initial, backend)
    ref.apply_updates_batched([u for b in batches[:3] for u in b], batch_size=8)

    state = convert.engine_state_from_numpy(_ref_leaves(ref.state), CPU)
    g = convert.graph_arrays_from_numpy(
        {f: (None if x is None else np.asarray(x)) for f, x in ref.g._asdict().items()}, CPU
    )
    np.testing.assert_equal(convert.engine_state_to_numpy(state), _ref_leaves(ref.state))
    ops = ref.graph.apply_batch_resolved(batches[3])
    writes = ref._ell_index.writes_for(ops) if backend == "ell" else []
    upd = ref._encode_chunk(ops, writes, 8)
    tupd = convert.update_batch_from_numpy({f: np.asarray(x) for f, x in upd._asdict().items()}, CPU)
    cfg = teng.EngineConfig(**{
        f.name: getattr(ref.cfg, f.name) for f in teng.dataclasses.fields(teng.EngineConfig)
        if f.name != "drop"
    })

    rstate, rg, rstats = jax.jit(partial(reng.batched_step, ref.cfg))(ref.state, ref.g, upd)
    tstate, tg, tstats = teng.batched_step(cfg, state, g, tupd)
    np.testing.assert_equal(convert.engine_state_to_numpy(tstate), _ref_leaves(rstate))
    want_g = {f: np.asarray(x) for f, x in rg._asdict().items() if x is not None}
    np.testing.assert_equal(convert.graph_arrays_to_numpy(tg), want_g)
    _same_stats(tstats, rstats)


# ------------------------------------------------------------------- traps
def test_padding_rows_scatter_nothing():
    """``UpdateBatch`` pads with out-of-range indices (slot == E_cap, vertex
    == V, ell_row == V), which the reference's scatters drop; the port must
    mask them, not write or raise."""
    initial, _ = random_workload(seed=6)
    ref, port = _build("sssp", initial, "ell")
    e, v = ref.graph.capacity, V
    pad = dict(
        slot=np.full(4, e, np.int32), src=np.arange(4, dtype=np.int32), dst=np.arange(4, dtype=np.int32),
        weight=np.full(4, 9.0, np.float32), valid=np.ones(4, bool), dirty_v=np.full(4, v, np.int32),
        touched_src=np.full(4, v, np.int32), ell_row=np.full(4, v, np.int32),
        ell_col=np.arange(4, dtype=np.int32), ell_nbr=np.zeros(4, np.int32), ell_w=np.ones(4, np.float32),
    )
    # one real row: re-write slot 0 with its own contents (a no-op update)
    for f, x in (("slot", 0), ("src", ref.graph.src[0]), ("dst", ref.graph.dst[0]),
                 ("weight", ref.graph.weight[0]), ("valid", True), ("dirty_v", ref.graph.dst[0])):
        pad[f][0] = x
    g_before = convert.graph_arrays_to_numpy(port.g)
    rupd = reng.UpdateBatch(**{f: jnp.asarray(x) for f, x in pad.items()})
    rstate, rg, rstats = jax.jit(partial(reng.batched_step, ref.cfg))(ref.state, ref.g, rupd)
    tstate, tg, tstats = teng.batched_step(port.cfg, port.state, port.g,
                                           convert.update_batch_from_numpy(pad, CPU))
    np.testing.assert_equal(convert.graph_arrays_to_numpy(tg), g_before)
    np.testing.assert_equal(convert.engine_state_to_numpy(tstate), _ref_leaves(rstate))
    _same_stats(tstats, rstats)
    assert int(tstats.scheduled) > 0  # the real row's endpoint was dirtied


def test_pagerank_weight_is_a_float32_division():
    """``alpha / outdeg`` must divide float32 by float32: a Python float over
    a tensor computes ``reciprocal * alpha``, which rounds differently."""
    outd = np.arange(1, 200000, dtype=np.int32)
    want = np.asarray(jnp.float32(0.85) / jnp.asarray(outd).astype(jnp.float32))
    cfg = teng.EngineConfig(
        num_queries=1, num_vertices=outd.shape[0], max_iters=1,
        semiring=tq.qplan.sr.pagerank(), weight_from_degree=True,
    )
    g = teng.GraphArrays(
        src=torch.arange(outd.shape[0], dtype=torch.int32), dst=torch.zeros(outd.shape[0], dtype=torch.int32),
        weight=torch.zeros(outd.shape[0]), valid=torch.ones(outd.shape[0], dtype=torch.bool),
        out_degree=torch.from_numpy(outd), in_degree=torch.zeros(outd.shape[0], dtype=torch.int32),
    )
    np.testing.assert_array_equal(teng.effective_weight(cfg, g).numpy(), want)
    naive = (0.85 / torch.from_numpy(outd).float()).numpy()
    assert (naive != want).any()  # the trap is real on this build


def test_empty_segments_read_the_identity():
    """A vertex with no in-edges aggregates to +inf (min) or 0 (sum), as
    ``segment_min``/``segment_sum`` fill empty segments."""
    for query in ("sssp", "pagerank"):
        initial = [(0, 1, 2.0), (1, 2, 3.0)]
        ref = (rq.sssp(RGraph(5, initial, capacity=8), [0], max_iters=8) if query == "sssp"
               else rq.pagerank(RGraph(5, initial, capacity=8), iters=4))
        port = (tq.sssp(TGraph(5, initial, capacity=8), [0], max_iters=8, device=CPU) if query == "sssp"
                else tq.pagerank(TGraph(5, initial, capacity=8), iters=4, device=CPU))
        cur = ref.state.cur
        want = reng.aggregate(ref.cfg, reng.edge_messages(ref.cfg, cur, ref.g), cur, ref.g)
        got = teng.aggregate(port.cfg, teng.edge_messages(port.cfg, port.state.cur, port.g),
                             port.state.cur, port.g)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_maintain_leaves_its_input_state_frozen():
    """δ detection reads the pre-update store: a sweep must not write into
    the state it was given."""
    initial, batches = random_workload(seed=4)
    _, port = _build("sssp", initial, "coo")
    before = {k: v.copy() for k, v in convert.engine_state_to_numpy(port.state).items()}
    state = port.state
    port.apply_updates(batches[0])
    assert port.state is not state
    np.testing.assert_equal(convert.engine_state_to_numpy(state), before)


def test_unported_configurations_raise():
    g = TGraph(4, [(0, 1, 1.0)], capacity=8)
    # the vertex-sharded sweep is ported: a mesh must be a DataMesh, and a
    # 2-shard CPU mesh answers as the unsharded engine
    with pytest.raises(TypeError, match="DataMesh"):
        tq.sssp(g, [0], mesh=object(), device=CPU)
    edges = [(0, 1, 1.0), (1, 2, 2.0), (3, 0, 1.0)]
    sharded = tq.sssp(TGraph(4, edges, capacity=8), [0], mesh=make_data_mesh(2, device=CPU, emulate=True),
                      device=CPU)
    assert sharded.num_shards == 2 and len(sharded.states) == 2
    np.testing.assert_array_equal(sharded.answers(), tq.sssp(TGraph(4, edges, capacity=8), [0], device=CPU).answers())
    with pytest.raises(ValueError, match="realizes JOD"):
        tq.sssp(g, [0], mode="vdc", backend="ell", device=CPU)
    # dropping, the fused backend, VDC and the slot pool are ported: this
    # engine builds, and the pool's surface runs (tests/test_torch_slot_pool.py
    # holds it against the reference)
    eng = tq.sssp(g, [0], backend="fused", mode="vdc", drop=tdr.DropConfig(mode="det", p=0.5), device=CPU)
    slot = eng.register_slot(np.array([np.inf, 0.0, np.inf, np.inf], np.float32))
    assert eng.slot_capacity == 2 and eng.active_slots() == [0, 1]
    assert eng.set_drop_params(slot, tdr.DropConfig(mode="det", p=1.0)) >= 0
    arrays, meta = eng.export_state()
    eng.import_state(arrays, meta)
    assert eng.deregister_slot(slot) >= 0 and eng.active_slots() == [0]


# ------------------------------------------------------------------ hygiene
def test_entry_points_default_to_cuda(monkeypatch):
    """Without ``device=`` the port runs on the GPU, and raises where there
    is none — it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tq.sssp(TGraph(4, [(0, 1, 1.0)], capacity=8), [0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teng.resolve_device(None)
    assert teng.resolve_device("cpu") == torch.device("cpu")
    # the LM serving slice's entry points
    from repro_torch.configs import get_arch
    from repro_torch.launch import model_serve
    from repro_torch.models import common as mcommon
    from repro_torch.models import transformer as ttf
    from repro_torch.models.recsys import mind

    arch = get_arch("llama3.2-1b")
    cfg = arch.smoke()
    for call in (lambda: ttf.init_params(cfg, torch.Generator().manual_seed(0)),
                 lambda: ttf.init_cache(cfg, 2, 4),
                 lambda: mcommon.ParamFactory(torch.Generator()),
                 lambda: convert.transformer_params_from_reference({"embed": np.zeros((2, 2), np.float32)}),
                 lambda: model_serve.lm_serve(arch, 1, 2, 1),
                 lambda: model_serve.mind_serve(get_arch("mind"), 1),
                 lambda: mind.init_params(get_arch("mind").smoke(), torch.Generator()),
                 lambda: ttf.init_cache(get_arch("minicpm3-4b").smoke(), 2, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert ttf.init_cache(cfg, 2, 4, device="cpu")[0].device == torch.device("cpu")
    assert cfg.num_params() > 0  # shapes only, on the meta device


def test_port_imports_neither_jax_nor_the_reference():
    src = Path(__file__).resolve().parents[1] / "src"
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith(('jax.', 'jaxlib'))"
        " or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(' '.join(n for n in sys.modules if n.startswith('repro_torch')))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    imported = set(out.stdout.split())
    assert len(imported) >= 23
    # the dropping / fused, VDC, LM serving and plan-optimizer slices'
    # modules are among those checked
    assert {"repro_torch.core.bloom", "repro_torch.core.dropping", "repro_torch.core.convert",
            "repro_torch.kernels.fused_sweep", "repro_torch.kernels.bloom",
            "repro_torch.core.access", "repro_torch.kernels.diff_lookup",
            "repro_torch.models.transformer", "repro_torch.kernels.flash_attn",
            "repro_torch.launch.model_serve", "repro_torch.core.landmark", "repro_torch.planner",
            "repro_torch.planner.cost", "repro_torch.planner.rules",
            "repro_torch.planner.landmark_rewrite", "repro_torch.models.moe",
            "repro_torch.models.recsys.mind", "repro_torch.models.recsys.embeddingbag",
            "repro_torch.configs.qwen2_moe_a2_7b", "repro_torch.configs.minicpm3_4b",
            "repro_torch.configs.mind", "repro_torch.models.gnn.equiformer_v2",
            "repro_torch.models.gnn.dimenet", "repro_torch.models.gnn.wigner",
            "repro_torch.configs.gnn_harness", "repro_torch.optim.adamw", "repro_torch.optim.compression",
            "repro_torch.data.sampler", "repro_torch.launch.train", "repro_torch.runtime.mesh_rules",
            "repro_torch.runtime.elastic", "repro_torch.launch.mesh", "repro_torch.configs.qwen2_72b",
            "repro_torch.configs.arctic_480b"} <= imported
