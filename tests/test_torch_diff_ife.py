"""Port parity: ``configs/diff_ife.py``, the DC engine as an architecture.

The smoke cell's sweep, from the numpy inputs of the reference's own smoke
test (``tests/test_arch_smoke.py::test_diff_ife_smoke_cell_runs_with_real_arrays``),
equals the reference's ``eng.maintain`` bit for bit: the answers, the store's
leaves and every ``MaintainStats`` field, for the initial sweep and for a δE
batch with deletions.  The cell's two hand-written layouts — queries over
``data`` and vertices over ``model`` (``maintain_q8k``, ``maintain_burst``)
on an emulated (2, 2) CPU mesh, queries over the whole mesh
(``maintain_q8k_qpar``) on an emulated (1, 4) one — equal the unsharded
sweep bit for bit, and their answers equal SCRATCH.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as REF_ARCH_NAMES
from repro.configs.diff_ife import _engine_cfg as ref_engine_cfg
from repro.configs.diff_ife import smoke as ref_smoke
from repro.core import engine as reng
from repro_torch.configs import ARCH_NAMES, get_arch
from repro_torch.configs import diff_ife as D
from repro_torch.core import engine as teng
from repro_torch.core.scratch import scratch_run
from repro_torch.launch.mesh import make_mesh

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the smoke tensors are tiny, and the
    suite's parallel workers would otherwise run many threads each on the
    same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_registry_is_the_references_and_every_arch_builds_cells():
    assert ARCH_NAMES == REF_ARCH_NAMES
    arch = get_arch("diff_ife")
    assert (arch.name, arch.family, set(arch.shapes)) == (
        "diff-ife", "dc", {"maintain_q8k", "maintain_burst", "maintain_q8k_qpar"})
    assert all(callable(get_arch(n).build_cell) for n in ARCH_NAMES)
    assert D.full() == D.DiffIFESizing(8192, 1_048_576, 16_777_216, 8, 16)
    assert D.smoke() == D.DiffIFESizing(**vars(ref_smoke()))
    assert {k: (s.kind, s.meta) for k, s in arch.shapes.items()} == \
        {k: (s.kind, s.meta) for k, s in __import__("repro.configs.diff_ife", fromlist=["SHAPES"]).SHAPES.items()}


def _numpy_inputs(z):
    """The reference smoke test's graph and sources, as numpy."""
    rng = np.random.default_rng(0)
    e, v = z.num_edges, z.num_vertices
    src, dst = rng.integers(0, v, e), rng.integers(0, v, e)
    w = rng.integers(1, 10, e)
    init = np.full((z.num_queries, v), np.inf, np.float32)
    init[np.arange(z.num_queries), np.arange(z.num_queries)] = 0.0
    return src.astype(np.int32), dst.astype(np.int32), w.astype(np.float32), init


def _graphs(src, dst, w, valid, v):
    cols = (src, dst, w, valid, np.zeros(v, np.int32), np.zeros(v, np.int32))
    ref = reng.GraphArrays(*(jnp.asarray(x) for x in cols))
    port = teng.GraphArrays(*(torch.from_numpy(np.array(x)) for x in cols))
    return ref, port


def _assert_same(ref_state, ref_stats, port_state, port_stats):
    for name, a, b in (("cur", ref_state.cur, port_state.cur),
                       ("repair_counts", ref_state.repair_counts, port_state.repair_counts),
                       *((f"dstore.{f}", getattr(ref_state.dstore, f), getattr(port_state.dstore, f))
                         for f in ("iters", "vals", "count"))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    for f in teng.MaintainStats._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ref_stats, f)), getattr(port_stats, f).numpy(), err_msg=f)


def test_smoke_cell_equals_the_references_maintain_bit_for_bit():
    z = ref_smoke()
    rcfg, tcfg = ref_engine_cfg(z), D._engine_cfg(D.smoke())
    src, dst, w, init = _numpy_inputs(z)
    v, e = z.num_vertices, z.num_edges
    rg, tg = _graphs(src, dst, w, np.ones(e, bool), v)
    rmaintain = jax.jit(lambda s, g, d: reng.maintain(rcfg, s, g, d))
    rs, rstats = rmaintain(reng.make_state(rcfg, jnp.asarray(init), e), rg, jnp.ones((v,), bool))
    ts, tstats = teng.maintain(tcfg, teng.make_state(tcfg, torch.from_numpy(init), e), tg,
                               torch.ones((v,), dtype=torch.bool))
    assert int(tstats.iters_run) > 0
    _assert_same(rs, rstats, ts, tstats)
    # the cell's own fn on a one-device mesh is the same sweep
    cell = D.build_cell(D.smoke(), "maintain_q8k", make_mesh((1, 1), ("data", "model"), device="cpu"))
    cs, cstats = cell.fn(teng.make_state(tcfg, torch.from_numpy(init), e), tg, torch.ones((v,), dtype=torch.bool))
    _assert_same(rs, rstats, cs, cstats)

    # a δE batch with deletions: 24 edges dropped, 16 re-pointed
    rng = np.random.default_rng(1)
    slots = rng.choice(e, 40, replace=False)
    valid, src2, dst2 = np.ones(e, bool), src.copy(), dst.copy()
    valid[slots[:24]] = False
    src2[slots[24:]], dst2[slots[24:]] = rng.integers(0, v, 16), rng.integers(0, v, 16)
    dirty = np.zeros(v, bool)
    dirty[dst[slots]] = True
    dirty[dst2[slots[24:]]] = True
    rg2, tg2 = _graphs(src2, dst2, w, valid, v)
    rs2, rstats2 = rmaintain(rs, rg2, jnp.asarray(dirty))
    ts2, tstats2 = teng.maintain(tcfg, ts, tg2, torch.from_numpy(dirty))
    assert int(tstats2.removed) + int(tstats2.written) > 0
    _assert_same(rs2, rstats2, ts2, tstats2)


LAYOUTS = [("maintain_q8k", (2, 2)), ("maintain_burst", (2, 2)), ("maintain_q8k_qpar", (1, 4))]


@pytest.mark.parametrize("shape,mesh_shape", LAYOUTS)
def test_layouts_equal_the_unsharded_sweep_and_scratch(shape, mesh_shape):
    mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu", emulate=True)
    cell = D.build_cell(D.smoke(), shape, mesh)
    state, g, dirty = cell.materialize(CPU, torch.Generator().manual_seed(7))
    cfg = D._engine_cfg(D.smoke(), D.SHAPES[shape].meta.get("queries"))
    assert tuple(state.cur.shape) == tuple(cell.args[0].cur.shape)
    for step in range(2):
        want, want_stats = teng.maintain(cfg, state, g, dirty)
        got, stats = cell.fn(state, g, dirty)
        assert int(want_stats.iters_run) > 0
        for a, b in ((want.cur, got.cur), (want.repair_counts, got.repair_counts), *zip(want.dstore, got.dstore)):
            assert torch.equal(a, b)
        for f in teng.MaintainStats._fields:
            assert torch.equal(getattr(want_stats, f), getattr(stats, f)), f
        assert torch.equal(want.active, got.active)
        answers, _ = scratch_run(cfg, g, state.init)
        assert torch.equal(got.cur, answers)
        if step == 0:
            state = got
            g, dirty = D.edge_batch(g, 24, seed=3)
            assert not bool(g.valid.all())
    assert int(stats.removed) + int(stats.written) > 0


def test_blocks_share_the_loop_so_a_blocks_own_horizon_does_not_stop_it():
    """Query blocks swept apart would stop at their own horizons; swept by
    ``maintain_blocks`` they run the whole axis's iterations, and their
    ``scheduled`` (dirty vertices rerun at every live iteration) adds up to
    the unsharded sweep's."""
    cfg = D._engine_cfg(D.smoke())
    mesh = make_mesh((4, 1), ("data", "model"), device="cpu", emulate=True)
    cell = D.build_cell(D.smoke(), "maintain_q8k", mesh)
    state, g, dirty = cell.materialize(CPU, torch.Generator().manual_seed(11))
    state.init[0] = float("inf")  # query 0 reaches nothing: alone it stops after one iteration
    want, want_stats = teng.maintain(cfg, state, g, dirty)
    one = D._engine_cfg(D.smoke(), 1)
    alone = [teng.maintain(one, teng.EngineState(
        dstore=type(state.dstore)(*(x[q:q + 1] for x in state.dstore)), jstore=None, drop=state.drop,
        init=state.init[q:q + 1], cur=state.cur[q:q + 1], repair_counts=state.repair_counts[q:q + 1],
        active=state.active[q:q + 1]), g, dirty)[1] for q in range(4)]
    assert len({int(s.iters_run) for s in alone}) > 1  # the blocks' own horizons differ
    _, stats = cell.fn(state, g, dirty)
    assert torch.equal(stats.scheduled, want_stats.scheduled)
    assert int(stats.iters_run) == int(want_stats.iters_run)
    assert sum(int(s.scheduled) for s in alone) != int(want_stats.scheduled)


def _declared(cell, i: int) -> int:
    from repro_torch.configs.common import leaves_with_shardings
    return sum(int(np.prod(sh.shard_shape(x.shape))) * x.element_size()
               for x, sh in leaves_with_shardings(cell.args[i], cell.in_shardings[i]))


@pytest.mark.parametrize("shape,mesh_shape", LAYOUTS)
def test_held_bytes_are_what_the_layout_passes_to_the_sweep(shape, mesh_shape):
    """Each coordinate holds the state the cell's shardings declare, exactly;
    its graph is its vertex shard's ``ShardIndex`` cells and every vertex's
    out-degree (the declared shardings replicate the edges: qpar holds them
    so, ``maintain_q8k``'s layout holds one shard's), and its slice of the
    dirty mask."""
    from repro_torch.core.graph import GraphSnapshot, ShardIndex

    mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu", emulate=True)
    cell = D.build_cell(D.smoke(), shape, mesh)
    state, g, dirty = cell.materialize(CPU, torch.Generator().manual_seed(7))
    cfg = D._engine_cfg(D.smoke(), D.SHAPES[shape].meta.get("queries"))
    lay = D.lay_out(cfg, mesh, *D._axes(D.SHAPES[shape].meta), state, g, dirty)
    held = D.held_bytes(lay)
    assert len(held) == mesh.size
    nv = len(lay.coords[0])
    v, e = g.num_vertices, g.src.shape[0]
    if nv == 1:
        cells = e
    else:
        snap = GraphSnapshot(num_vertices=v, label=np.zeros(e, np.int32),
                             **{f: getattr(g, f).numpy() for f in D._GRAPH_FIELDS})
        cells = ShardIndex(snap, nv).shard_capacity
    for c, h in held.items():
        assert h["state"] == _declared(cell, 0), c
        assert h["graph"] == cells * 13 + v * 4 + v // nv * 4, c
        assert h["dirty"] == _declared(cell, 2) == v // nv, c
    assert (sum(held[next(iter(held))].values()) == cell.per_device_bytes()) == (nv == 1)
