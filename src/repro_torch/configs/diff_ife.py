"""diff_ife [dc]: the paper's engine as a production arch.

The port of ``repro/configs/diff_ife.py``.  ``maintain`` — one δE
maintenance sweep over Q concurrent queries — is the cell's step, at the
reference's production sizing: Q=8,192 concurrent queries × V=1,048,576
vertices × E=16,777,216 edges, S=8 change points (the dense store is ~550 GB
global, ~2.1 GB per chip on 256 chips), on a JOD min_plus engine without
dropping on the ``coo`` backend.

The reference only annotates the sweep's arguments (queries over
``q_vertices`` → ``(pod, data)``, vertices over ``dc_vertices`` → ``model``;
or, in ``maintain_q8k_qpar``, queries over ``q_all`` → the whole mesh and
vertices device-local) and lets XLA's partitioner split it.  The port has no
partitioner, so the cell's ``fn`` (:func:`maintain_layout`) lays the sweep
out by hand on ``launch/mesh.Mesh``: each mesh coordinate takes its block of
every argument (``NamedSharding.place``: views on an emulated mesh), each
query block runs ``engine.maintain_blocks`` over its vertex shards (the
edges of each shard in a fresh ``ShardIndex``'s layout, as the sharded
engine lays them out), and the blocks share only the loop's control and
their stats.  The cell's shardings are the reference's: they declare the
edge arrays replicated, while ``maintain_q8k``'s layout gives each vertex
shard only its own edge cells and every vertex's out-degree
(:func:`held_bytes` counts what a coordinate holds).  Under
``maintain_q8k``'s layout the exact front crosses the ``model`` axis every
iteration (the sweep's gather); under ``maintain_q8k_qpar``'s each device
sweeps its queries over the whole graph and nothing else crosses.

The reference's ``build_cell`` builds its state shardings without
``EngineState.active`` and so raises ``TypeError`` (ROADMAP Queue 3); the
port shards ``active`` replicated, as ``jax.jit`` places an argument given
no sharding.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.common import ArchSpec, Cell, ShapeDef, named, replicated, tree_struct
from repro_torch.core import diffstore as ds
from repro_torch.core import dropping as dr
from repro_torch.core import engine as eng
from repro_torch.core import semiring as sr
from repro_torch.core.graph import GraphSnapshot, ShardIndex, shard_capacity
from repro_torch.launch import mesh as mesh_lib
from repro_torch.runtime import mesh_rules
from repro_torch.runtime.mesh_rules import Placed

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DiffIFESizing:
    num_queries: int = 8192
    num_vertices: int = 1_048_576
    num_edges: int = 16_777_216
    store_capacity: int = 8
    max_iters: int = 16


SHAPES = {
    "maintain_q8k": ShapeDef("maintain", dict()),
    "maintain_burst": ShapeDef("maintain", dict(queries=1024)),
    # query axis over the WHOLE mesh, vertex axis device-local: the IFE
    # gather/scatter never crosses devices
    "maintain_q8k_qpar": ShapeDef("maintain", dict(query_parallel=True)),
}


def full() -> DiffIFESizing:
    return DiffIFESizing()


def smoke() -> DiffIFESizing:
    return DiffIFESizing(num_queries=4, num_vertices=64, num_edges=256, store_capacity=4, max_iters=8)


def _engine_cfg(z: DiffIFESizing, num_queries=None) -> eng.EngineConfig:
    return eng.EngineConfig(
        num_queries=num_queries or z.num_queries,
        num_vertices=z.num_vertices,
        max_iters=z.max_iters,
        semiring=sr.min_plus(),
        mode="jod",
        store_capacity=z.store_capacity,
        drop=dr.DropConfig(),
    )


def _axes(meta: dict) -> tuple[str, str]:
    """(query axis, vertex axis): the shape's logical axes."""
    if meta.get("query_parallel"):
        return "q_all", "dc_local"
    return "q_vertices", "dc_vertices"


def _graph_structs(v: int, e: int) -> eng.GraphArrays:
    def t(n, dtype):
        return torch.empty((n,), dtype=dtype, device="meta")

    return eng.GraphArrays(src=t(e, torch.int32), dst=t(e, torch.int32), weight=t(e, torch.float32),
                           valid=t(e, torch.bool), out_degree=t(v, torch.int32), in_degree=t(v, torch.int32))


def state_shardings(mesh, q_ax: str, v_ax: str) -> eng.EngineState:
    """The cell's state shardings: the store and the per-(query, vertex)
    leaves over both axes, ``active`` and the drop scalars replicated."""
    qv, qvs, rep = named(mesh, q_ax, v_ax), named(mesh, q_ax, v_ax, None), replicated(mesh)
    return eng.EngineState(
        dstore=ds.DiffStore(iters=qvs, vals=qvs, count=qv),
        jstore=None,
        drop=dr.DropState(det=None, flt=None, det_overflow=rep, max_iter=rep),
        init=qv,
        cur=qv,
        repair_counts=qv,
        active=rep,
    )


def build_cell(z: DiffIFESizing, shape_name: str, mesh) -> Cell:
    meta = SHAPES[shape_name].meta
    cfg = _engine_cfg(z, meta.get("queries"))
    q, v, e = cfg.num_queries, cfg.num_vertices, z.num_edges
    q_ax, v_ax = _axes(meta)

    state_structs = tree_struct(lambda: eng.make_state(cfg, torch.zeros((q, v)), e))
    vx, rep = named(mesh, v_ax), replicated(mesh)
    g_sh = eng.GraphArrays(src=rep, dst=rep, weight=rep, valid=rep, out_degree=vx, in_degree=vx)
    args = (state_structs, _graph_structs(v, e), torch.empty((v,), dtype=torch.bool, device="meta"))
    in_sh = (state_shardings(mesh, q_ax, v_ax), g_sh, vx)
    return Cell(
        f"diff-ife:{shape_name}", partial(maintain_layout, cfg, mesh, q_ax, v_ax), args, in_sh, mesh=mesh,
        make_args=partial(make_inputs, cfg, e),
        dry_fn=partial(iteration_unit, cfg, mesh, q_ax, v_ax),
    )


# ------------------------------------------------------------------ inputs
def make_inputs(cfg: eng.EngineConfig, num_edges: int, device, generator: torch.Generator):
    """``(state, g, dirty)`` of an initial sweep: a uniform random graph of
    ``num_edges`` edges (endpoints uniform over the vertices, weights
    uniform in 1..10), ``cfg.num_queries`` SSSP queries from uniform
    sources (distinct where there are no more queries than vertices), an
    empty store and every vertex dirty; drawn with numpy from
    ``generator``'s seed."""
    rng = np.random.default_rng(generator.initial_seed())
    q, v, e = cfg.num_queries, cfg.num_vertices, num_edges
    src = torch.from_numpy(rng.integers(0, v, e, dtype=np.int32)).to(device)
    dst = torch.from_numpy(rng.integers(0, v, e, dtype=np.int32)).to(device)
    w = torch.from_numpy(rng.integers(1, 11, e).astype(np.float32)).to(device)
    sources = torch.from_numpy(rng.choice(v, q, replace=q > v)).to(device)
    g = _with_degrees(src, dst, w, torch.ones((e,), dtype=torch.bool, device=device), v)
    init = torch.full((q, v), float("inf"), dtype=torch.float32, device=device)
    init[torch.arange(q, device=device), sources] = 0.0
    return eng.make_state(cfg, init, e), g, torch.ones((v,), dtype=torch.bool, device=device)


def _with_degrees(src: Tensor, dst: Tensor, w: Tensor, valid: Tensor, v: int) -> eng.GraphArrays:
    def degree(x):
        return torch.bincount(x[valid].long(), minlength=v).to(torch.int32)

    return eng.GraphArrays(src=src, dst=dst, weight=w, valid=valid, out_degree=degree(src), in_degree=degree(dst))


def edge_batch(g: eng.GraphArrays, num_updates: int, seed: int) -> tuple[eng.GraphArrays, Tensor]:
    """One δE batch on a cell's graph: ``num_updates`` edges deleted and
    ``num_updates`` others re-pointed to new uniform endpoints and weights
    in 1..10 (each a deletion and an insertion in its slot), slots drawn
    with numpy from ``seed``.  Returns the new graph and the dirty mask
    (every touched edge's old and new destination)."""
    rng = np.random.default_rng(seed)
    v, e = g.num_vertices, g.src.shape[0]
    dev = g.src.device
    slots = torch.from_numpy(rng.choice(e, 2 * num_updates, replace=False)).to(dev)
    gone, moved = slots[:num_updates], slots[num_updates:]
    src, dst, w, valid = (x.clone() for x in (g.src, g.dst, g.weight, g.valid))
    valid[gone] = False
    src[moved] = torch.from_numpy(rng.integers(0, v, num_updates, dtype=np.int32)).to(dev)
    dst[moved] = torch.from_numpy(rng.integers(0, v, num_updates, dtype=np.int32)).to(dev)
    w[moved] = torch.from_numpy(rng.integers(1, 11, num_updates).astype(np.float32)).to(dev)
    valid[moved] = True
    dirty = torch.zeros((v,), dtype=torch.bool, device=dev)
    dirty[g.dst[slots].long()] = True
    dirty[dst[moved].long()] = True
    return _with_degrees(src, dst, w, valid, v), dirty


# ------------------------------------------------------------------ the layouts
def _mesh_axes(logical: str, mesh) -> tuple[str, ...]:
    r = mesh_rules.resolve_axis(logical, mesh)
    return () if r is None else (r if isinstance(r, tuple) else (r,))


def _coords(names: tuple[str, ...], mesh) -> list[dict]:
    """Every coordinate of ``names`` in row-major order (the order the
    specs number their blocks in)."""
    sizes = [mesh.shape[a] for a in names]
    return [dict(zip(names, idx)) for idx in np.ndindex(*sizes)] if names else [{}]


def _grid(cfg: eng.EngineConfig, mesh, q_ax: str, v_ax: str):
    """(query-block coordinates, vertex-shard coordinates, the block's
    config): block ``b`` × shard ``k`` sits at the union of their
    coordinates (every other mesh axis at 0)."""
    qc, vc = _coords(_mesh_axes(q_ax, mesh), mesh), _coords(_mesh_axes(v_ax, mesh), mesh)
    if cfg.num_queries % len(qc) or cfg.num_vertices % len(vc):
        raise ValueError(f"{cfg.num_queries} queries x {cfg.num_vertices} vertices do not split "
                         f"into {len(qc)} x {len(vc)} blocks")
    return qc, vc, dataclasses.replace(cfg, num_queries=cfg.num_queries // len(qc))


def _coord(mesh, **where) -> tuple:
    return tuple(int(where.get(a, 0)) for a in mesh.axis_names)


def _place_state(state: eng.EngineState, shardings: eng.EngineState):
    """Every leaf of the global state placed by its sharding (``None``
    stays ``None``)."""
    def place(x, sh):
        if x is None:
            return None
        if isinstance(x, tuple):
            return type(x)(*(place(a, b) for a, b in zip(x, sh)))
        return sh.place(x)

    return place(state, shardings)


def _at(placed, coord: tuple):
    """A coordinate's blocks of a placed tree (``None`` stays ``None``)."""
    if placed is None:
        return None
    if isinstance(placed, tuple):
        return type(placed)(*(_at(x, coord) for x in placed))
    return placed.blocks[coord]


def _block_state(placed, coord: tuple, rows: slice) -> eng.EngineState:
    st = _at(placed, coord)
    return st._replace(active=st.active[rows])  # the block's rows of the replicated slots


class Layout(NamedTuple):
    """What each mesh coordinate holds of one sweep's arguments: a block's
    config, the coordinates and their devices (``[query block][vertex
    shard]``), the state as the cell's shardings place it, each
    coordinate's state block, each vertex shard's graph and each block's
    dirty mask."""

    cfg: eng.EngineConfig
    coords: list
    devices: list
    placed: eng.EngineState
    states: list
    gs: list
    dirty: list


def lay_out(cfg: eng.EngineConfig, mesh, q_ax: str, v_ax: str, state: eng.EngineState, g: eng.GraphArrays,
            dirty: Tensor) -> Layout:
    """The global ``(state, g, dirty)`` laid out on ``mesh``: queries split
    over ``q_ax``'s mesh axes and vertices over ``v_ax``'s.  Each coordinate
    takes its block of the state (placed by the cell's shardings; of the
    replicated ``active``, its block's rows), and each vertex shard its edge
    cells in a fresh :class:`ShardIndex`'s layout of the graph
    (``engine.shard_graph_arrays``; one shard: the graph itself)."""
    if cfg.drop.enabled() or cfg.mode != "jod" or cfg.backend != "coo":
        raise ValueError("the diff-ife layouts run the cell's engine: JOD, coo, no dropping")
    qc, vc, cfg_b = _grid(cfg, mesh, q_ax, v_ax)
    qb = cfg_b.num_queries
    placed = _place_state(state, state_shardings(mesh, q_ax, v_ax))
    coords = [[_coord(mesh, **a, **b) for b in vc] for a in qc]
    devices = [[mesh.devices[c] for c in row] for row in coords]
    states = [[_block_state(placed, c, slice(b * qb, (b + 1) * qb)) for c in row]
              for b, row in enumerate(coords)]
    gs, per_devices = [], {}
    for devs in devices:
        key = tuple(devs)
        if key not in per_devices:  # the same devices hold the same edge cells
            per_devices[key] = _shard_graphs(g, devs)
        gs.append(per_devices[key])
    return Layout(cfg_b, coords, devices, placed, states, gs, [dirty.to(devs[0]) for devs in devices])


def _shard_graphs(g: eng.GraphArrays, devices) -> list[eng.GraphArrays]:
    if len(devices) == 1:
        return [g._replace(**{f: getattr(g, f).to(devices[0]) for f in _GRAPH_FIELDS})]
    e = g.src.shape[0]
    snap = GraphSnapshot(num_vertices=g.num_vertices, label=np.zeros(e, np.int32),
                         **{f: getattr(g, f).cpu().numpy() for f in _GRAPH_FIELDS})
    return eng.shard_graph_arrays(snap, ShardIndex(snap, len(devices)), devices)


_GRAPH_FIELDS = ("src", "dst", "weight", "valid", "out_degree", "in_degree")


def held_bytes(lay: Layout) -> dict[tuple, dict[str, int]]:
    """The bytes each coordinate holds of a :class:`Layout`, by argument:
    ``state`` its placed blocks of the state's leaves (the whole replicated
    ``active``), ``graph`` its vertex shard's graph, ``dirty`` its slice of
    the dirty mask (the sweep seeds each shard with its vertices')."""
    def nbytes(tree) -> int:
        if tree is None:
            return 0
        if isinstance(tree, tuple):
            return sum(nbytes(x) for x in tree)
        return tree.numel() * tree.element_size()

    out = {}
    for row, gs, d in zip(lay.coords, lay.gs, lay.dirty):
        for c, g in zip(row, gs):
            out[c] = {"state": nbytes(_at(lay.placed, c)),
                      "graph": nbytes(tuple(getattr(g, f) for f in _GRAPH_FIELDS)),
                      "dirty": d.numel() * d.element_size() // len(row)}
    return out


def maintain_layout(cfg: eng.EngineConfig, mesh, q_ax: str, v_ax: str, state: eng.EngineState,
                    g: eng.GraphArrays, dirty: Tensor) -> tuple[eng.EngineState, eng.MaintainStats]:
    """One maintenance sweep of the global ``(state, g, dirty)`` laid out on
    ``mesh`` (:func:`lay_out`): each query block sweeps over its vertex
    shards and the blocks share the loop's control
    (``engine.maintain_blocks``).  Returns the global state, assembled on
    the state's device, and the blocks' stats combined
    (``engine.combine_stats``): equal to ``engine.maintain`` of the
    unsharded arguments."""
    lay = lay_out(cfg, mesh, q_ax, v_ax, state, g, dirty)
    new, stats = eng.maintain_blocks(lay.cfg, lay.devices, lay.states, lay.gs, lay.dirty)
    coords = lay.coords
    del lay
    return _assemble(state, state_shardings(mesh, q_ax, v_ax), coords, new), eng.combine_stats(stats)


def _assemble(state: eng.EngineState, shardings: eng.EngineState, coords, new) -> eng.EngineState:
    """The global state from every coordinate's new block, written block by
    block on the input state's device; ``active`` and the drop scalars (no
    dropping: the sweep leaves them as they were) are the input's."""
    dev = state.cur.device
    flat = [(c, st) for row, sts in zip(coords, new) for c, st in zip(row, sts)]

    def gather(get) -> Tensor:
        x = get(state)
        return Placed(get(shardings), tuple(x.shape), x.dtype, {c: get(st) for c, st in flat}).gather(dev)

    return state._replace(
        dstore=ds.DiffStore(*(gather(lambda t, f=f: getattr(t.dstore, f)) for f in ds.DiffStore._fields)),
        cur=gather(lambda t: t.cur),
        repair_counts=gather(lambda t: t.repair_counts),
    )


# ------------------------------------------------------------------ the dry-run's unit
# the frontier push (engine._push_cells) selects its hit edges with
# aten.nonzero, whose output shape depends on the data: the dry-run's unit
# leaves it out (it runs on real tensors in the smoke cell and on the card)
UNIT_LEAVES_OUT = "engine._push_cells (aten.nonzero: an output shape that depends on the data)"


def iteration_unit(cfg: eng.EngineConfig, mesh, q_ax: str, v_ax: str, state: eng.EngineState,
                   g: eng.GraphArrays, dirty: Tensor):
    """One device's part of one sweep iteration, on the meta device: the
    block of the first coordinate with every vertex scheduled, its share of
    the edges (E over the vertex shards), the front gathered over the
    vertex axis, ``engine._shard_body`` and the changed mask gathered for
    the push.  The whole sweep cannot run on meta (it reads its frontier on
    the host every iteration); this is the per-iteration unit the
    reference's roofline terms use for this cell.  Returns the body's
    step."""
    qc, vc, cfg_b = _grid(cfg, mesh, q_ax, v_ax)
    qb, nv = cfg_b.num_queries, len(vc)
    coord = _coord(mesh)
    dev = mesh.devices[coord]
    st = _block_state(_place_state(state, state_shardings(mesh, q_ax, v_ax)), coord, slice(0, qb))
    vb = cfg.num_vertices // nv
    e = g.src.shape[0]
    # the cells of an even spread (the data's fullest shard is known only on real edges)
    cap = e if nv == 1 else shard_capacity(e, nv)

    def cells(x):
        return torch.empty((cap,), dtype=x.dtype, device=x.device)

    g_k = eng.GraphArrays(src=cells(g.src), dst=cells(g.dst), weight=cells(g.weight), valid=cells(g.valid),
                          out_degree=g.out_degree, in_degree=g.in_degree[:vb])
    sh = eng._make_shard(cfg_b, st, g_k, eng._dirty_2d(cfg_b, dirty[:vb]), 0,
                         None if nv == 1 else eng._local_dst(g_k.dst, 0, vb))
    carry = eng._first_carries(cfg_b, [sh], [dev])[0]
    cur_full = mesh_lib.all_gather([carry.cur] * nv, [dev] * nv)[0]
    step, _, _ = eng._shard_body(cfg_b, sh, carry, cur_full)
    mesh_lib.all_gather([step.changed] * nv, [dev] * nv)
    return step


ARCH = ArchSpec(
    name="diff-ife", family="dc", full=full, smoke=smoke,
    shapes=SHAPES, build_cell=build_cell,
    notes="The paper's own engine: one maintenance sweep per δE batch, "
    "Q-batched, laid out by hand on the mesh.",
)
