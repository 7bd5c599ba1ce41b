"""Port parity: the named-axis mesh, ``runtime/mesh_rules`` and
``runtime/elastic`` against the reference's.

- ``logical_to_spec`` and ``resolve_axis``: every logical name of
  ``DEFAULT_RULES``, alone, after each other name (one mesh axis at most once
  a spec) and on meshes lacking an axis, over (1, 1), (2, 4) ``("data",
  "model")`` and (2, 2, 2) ``("pod", "data", "model")`` meshes.  The
  reference resolves against its mesh's axis names only, so its side runs on
  a stand-in with those names (and on ``jax.make_mesh`` for the one-device
  mesh); the port's on meshes emulated on the CPU.  The spec tuples must be
  equal.
- ``param_specs``/``cache_specs`` of the qwen2-72b and arctic-480b configs
  (full and smoke) equal the reference's trees, and ``shardings_for`` gives
  each leaf the reference's spec.
- Placement: every block of a placed tensor is the block the reference's
  ``shard_map`` hands that mesh coordinate (row-major over a spec entry's
  axes), a view of it on an emulated mesh, and the blocks gather back.
- ``elastic``: ``tests/test_runtime.py``'s cases, ``build_mesh`` shapes,
  ``shrink_after_failure`` keeping ``model``, ``split_global_batch`` over
  ``pod`` x ``data``.
"""

import itertools
import types

import jax
import numpy as np
import pytest
import torch

from repro.runtime import elastic as relastic
from repro.runtime import mesh_rules as rrules
from repro_torch.configs import get_arch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as tf
from repro_torch.runtime import elastic
from repro_torch.runtime import mesh_rules as mr

CPU = "cpu"
MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "model_only": ((4,), ("model",)),  # no data axis: batch and embed replicated
}


def _port_mesh(name):
    shape, axes = MESHES[name]
    return mesh_lib.make_mesh(shape, axes, device=CPU, emulate=True)


def _ref_mesh(name):
    """What the reference's rules read of a mesh: its axis names."""
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))


def _cases():
    names = list(rrules.DEFAULT_RULES) + [None, "no_such_axis"]
    singles = [(n,) for n in names]
    pairs = list(itertools.product(names, repeat=2))
    return singles + pairs + [("layers", "batch", None, "kv_seq", None), ("q_all", "batch", "heads"),
                              ("batch", "q_all"), ("embed", "embed"), ()]


def test_default_rules_are_the_references():
    assert mr.DEFAULT_RULES == rrules.DEFAULT_RULES


@pytest.mark.parametrize("mesh", list(MESHES))
def test_logical_to_spec_matches_the_reference(mesh):
    port, ref = _port_mesh(mesh), _ref_mesh(mesh)
    for axes in _cases():
        want = rrules.logical_to_spec(axes, ref)
        got = mr.logical_to_spec(axes, port)
        assert isinstance(got, mr.PartitionSpec)
        assert tuple(got) == tuple(want), axes
    for name in list(rrules.DEFAULT_RULES) + [None, "no_such_axis"]:
        assert mr.resolve_axis(name, port) == rrules.resolve_axis(name, ref), name
    assert tuple(mr.shard_batch_spec(port)) == tuple(rrules.shard_batch_spec(ref))
    assert tuple(mr.replicated(port).spec) == ()


def test_the_references_resolution_cases_on_a_one_device_mesh():
    """``tests/test_runtime.py::test_mesh_rules_resolution`` on the port,
    and the reference's own answers on ``jax.make_mesh``."""
    ref = jax.make_mesh((1, 1), ("data", "model"))
    port = mesh_lib.make_smoke_mesh(CPU)  # a DataMesh reads as (1, 1)
    for axes, want in ((("layers", "embed", "heads"), (None, "data", "model")),
                       (("embed", "embed"), ("data", None)), (("batch",), ("data",))):
        assert tuple(rrules.logical_to_spec(axes, ref)) == want
        assert mr.logical_to_spec(axes, port) == want


@pytest.mark.parametrize("name", ["qwen2-72b", "arctic-480b"])
@pytest.mark.parametrize("mesh", ["2x4", "2x2x2"])
def test_param_and_cache_specs_match_the_reference(name, mesh):
    from repro.configs import get_arch as ref_get_arch
    from repro.models import transformer as rtf

    port, ref = _port_mesh(mesh), _ref_mesh(mesh)
    for which in ("full", "smoke"):
        cfg, rcfg = getattr(get_arch(name), which)(), getattr(ref_get_arch(name), which)()
        rspecs = rtf.param_specs(rcfg)
        assert tf.param_specs(cfg) == rspecs
        assert tf.cache_specs(cfg) == rtf.cache_specs(rcfg)
        for tree, rtree in ((tf.param_specs(cfg), rspecs), (tf.cache_specs(cfg), rtf.cache_specs(rcfg))):
            got = mr.shardings_for(tree, port)
            flat_got = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, mr.NamedSharding))
            flat_want = jax.tree.leaves(rtree, is_leaf=rrules._is_axes_leaf)
            assert len(flat_got) == len(flat_want) > 0
            for s, axes in zip(flat_got, flat_want):
                assert s.mesh is port and tuple(s.spec) == tuple(rrules.logical_to_spec(axes, ref))
    # raw specs pass through, clipped to the mesh's axes
    raw = mr.shardings_for({"a": mr.P(("pod", "data"), "model"), "b": mr.P("pod", None)}, port)
    clipped = ("pod" in port.axis_names)
    assert tuple(raw["b"].spec) == (("pod" if clipped else None), None)


@pytest.mark.parametrize("mesh", ["2x4", "2x2x2"])
@pytest.mark.parametrize("axes", [("batch", None, "kv_seq", None), ("vocab", "embed"), ("q_all", None),
                                  ("experts", "embed", "mlp", None)])
def test_placement_takes_the_references_blocks(mesh, axes):
    """Each mesh coordinate's block is the one the reference's ``shard_map``
    hands that coordinate under the same spec (block ``k`` of an axis, ``k``
    the coordinate's row-major index over the entry's mesh axes), a view of
    the global tensor on an emulated mesh, and the blocks gather back."""
    port = _port_mesh(mesh)
    shape = (8, 4, 16, 8)[: len(axes)]
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    placed = mr.shardings_for(axes, port).place(x)
    spec = mr.logical_to_spec(axes, port)
    sizes = port.shape
    for coord in np.ndindex(port.devices.shape):
        where = dict(zip(port.axis_names, coord))
        want = x
        for i, entry in enumerate(spec):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            k = np.ravel_multi_index(tuple(where[a] for a in names), tuple(sizes[a] for a in names))
            n = x.shape[i] // int(np.prod([sizes[a] for a in names]))
            want = want.narrow(i, int(k) * n, n)
        block = placed.blocks[coord]
        assert torch.equal(block, want)
        assert block.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()  # a view
    assert torch.equal(placed.gather(), x)
    with pytest.raises(ValueError, match="does not split"):
        mr.NamedSharding(port, mr.P("model")).place(torch.zeros(3))


def test_elastic_matches_the_references_cases():
    """``tests/test_runtime.py::test_elastic_reshard_roundtrip``'s case,
    then the shapes of ``build_mesh`` and ``shrink_after_failure``."""
    one = elastic.build_mesh([torch.device(CPU)], data=1, model=1)
    assert one.shape == {"data": 1, "model": 1} and one.axis_names == ("data", "model")
    tree = {"emb": torch.arange(32, dtype=torch.float32).reshape(8, 4)}
    out = elastic.reshard(tree, {"emb": ("vocab", "embed")}, one)
    np.testing.assert_array_equal(out["emb"].gather().numpy(), tree["emb"].numpy())
    assert elastic.split_global_batch(256, one) == 256
    rmesh = relastic.build_mesh(jax.devices()[:1], data=1, model=1)
    assert dict(rmesh.shape) == one.shape

    cards = [torch.device("cuda", k) for k in range(8)]  # placement only: no tensor goes there
    for kw, want in (({}, {"data": 4, "model": 2}), ({"model": 4}, {"data": 2, "model": 4}),
                     ({"data": 2, "model": 2}, {"data": 2, "model": 2}),
                     ({"pod": 2, "data": 2, "model": 2}, {"pod": 2, "data": 2, "model": 2})):
        assert elastic.build_mesh(cards, **kw).shape == want, kw
    with pytest.raises(ValueError):
        elastic.build_mesh(cards, data=4, model=4)
    two = elastic.build_mesh(cards, model=2)
    shrunk = elastic.shrink_after_failure(two, {torch.device("cuda", 3)})
    assert shrunk.shape == {"data": 3, "model": 2} and torch.device("cuda", 3) not in set(shrunk.devices.flat)
    with pytest.raises(ValueError, match="survive"):
        elastic.shrink_after_failure(elastic.build_mesh(cards[:2], data=1, model=2), {cards[0]})
    pod = elastic.build_mesh(cards, pod=2, data=2, model=2)
    assert elastic.split_global_batch(8, pod) == 2 and elastic.split_global_batch(8, two) == 2
    with pytest.raises(ValueError, match="split"):
        elastic.split_global_batch(6, pod)
    # a 2-D mesh over emulated coordinates, the blocks views of the tree
    emu = elastic.build_mesh([torch.device(CPU)] * 8, data=2, model=4, emulate=True)
    placed = elastic.reshard(tree, {"emb": ("vocab", "embed")}, emu)["emb"]
    assert placed.blocks[(1, 3)].shape == (2, 2) and torch.equal(placed.blocks[(1, 3)], tree["emb"][6:8, 2:4])


def test_meshes_read_as_the_references():
    """A ``DataMesh`` reads as the reference's (n, 1) data mesh; a
    ``Mesh`` over repeated devices needs ``emulate``; too few devices
    raise."""
    dm = mesh_lib.make_data_mesh(3, device=CPU, emulate=True)
    assert dm.shape == {"data": 3, "model": 1} and dm.axis_names == ("data", "model")
    assert mr.logical_to_spec(("batch", "kv_seq"), dm) == ("data", "model")
    with pytest.raises(ValueError, match="emulate=True"):
        mesh_lib.make_mesh((2, 2), ("data", "model"), device=CPU)
    with pytest.raises(ValueError, match="emulate=True"):
        mesh_lib.Mesh(np.array([[torch.device(CPU)] * 2], dtype=object), ("data", "model"))
    m = _port_mesh("2x4")
    assert m.size == 8 and m.emulated and mesh_lib.as_data_mesh(m).size == 2
    with pytest.raises(TypeError, match="DataMesh or Mesh"):
        mesh_lib.as_data_mesh(object())
