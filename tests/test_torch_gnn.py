"""Port parity: the GNN models (``repro_torch.models.gnn``) and their configs.

Each arch's smoke config, parameters from the reference's ``init_params``
carried across by ``core.convert.transformer_params_from_reference``, on the same
numpy-seeded graph (48 nodes, 160 edges, as ``tests/test_arch_smoke.py``):
the forward and the loss within rtol 1e-5 (float32, the same products summed
in another order; 1e-4 for EquiformerV2, whose Wigner blocks go through
complex64 products), and every gradient leaf against
``jax.value_and_grad`` of the reference's ``loss_fn`` within 1e-4 of that
leaf's largest |value|.  Also: EquiformerV2's chunked layer against the
reference's chunked layer and the port's exact one, ``wigner_d_real`` for
l = 0..6, DimeNet's bases, the segment helpers' empty segments and ties,
and PNA on a graph with a repeated edge and an isolated node.
"""

import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs import gnn_harness as H
from repro_torch.core.convert import transformer_params_from_reference
from repro_torch.models.gnn import common as g
from repro_torch.models.gnn import dimenet, equiformer_v2, wigner
from repro_torch.optim.adamw import tree_leaves

ARCHS = ("pna", "gatedgcn", "dimenet", "equiformer-v2")
MODULE = {"pna": "pna", "gatedgcn": "gatedgcn", "dimenet": "dimenet", "equiformer-v2": "equiformer_v2"}
GEOMETRIC = ("dimenet", "equiformer-v2")
RTOL = {"pna": 1e-5, "gatedgcn": 1e-5, "dimenet": 1e-5, "equiformer-v2": 1e-4}
GRAD_TOL = 1e-4  # of each leaf's largest |value|


def _modules(name):
    return (importlib.import_module(f"repro.models.gnn.{MODULE[name]}"),
            importlib.import_module(f"repro_torch.models.gnn.{MODULE[name]}"))


def _port_cfg(port_module, ref_cfg):
    cls = {f: getattr(port_module, f) for f in dir(port_module)}[type(ref_cfg).__name__]
    return cls(**dataclasses.asdict(ref_cfg))


@functools.lru_cache(maxsize=None)
def _ref_params(name, ref_cfg):
    import jax

    ref, _ = _modules(name)
    return jax.tree.map(np.asarray, ref.init_params(ref_cfg, jax.random.PRNGKey(0)))


def _batches(name, cfg, rng_seed=1, n=48, e=160):
    """The reference's and the port's ``random_graph_batch`` from one seed."""
    from repro.models.gnn import common as rg

    kw = dict(edge_feat_dim=8, num_classes=getattr(cfg, "num_classes", 8), geometric=name in GEOMETRIC)
    d_in = getattr(cfg, "d_in", 16)
    return (rg.random_graph_batch(np.random.default_rng(rng_seed), n, e, d_in, **kw),
            g.random_graph_batch(np.random.default_rng(rng_seed), n, e, d_in, device="cpu", **kw))


def _extra(name, rbatch):
    """DimeNet's triplets for both packages (cap 1024, as ``_gnn_setup``)."""
    if name != "dimenet":
        return (), ()
    import jax.numpy as jnp

    from repro.models.gnn import dimenet as rd

    host = [np.asarray(x) for x in (rbatch.edge_src, rbatch.edge_dst, rbatch.edge_mask)]
    tri = rd.build_triplets(*host, 1024)
    return (tuple(jnp.asarray(t) for t in tri),), (dimenet.triplets_to(dimenet.build_triplets(*host, 1024), "cpu"),)


def _grads(module, cfg, params, *args):
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    loss = module.loss_fn(cfg, params, *args)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(x) if gr is None else gr for x, gr in zip(leaves, grads)]


def _assert_grads_close(got, want):
    import jax

    want = jax.tree.leaves(want)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        assert a.shape == b.shape, i
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a.numpy() - b).max())
        assert err <= GRAD_TOL * scale, (i, err, scale)


def _check_arch(name, ref_cfg, rbatch, pbatch):
    import jax

    ref, port = _modules(name)
    cfg = _port_cfg(port, ref_cfg)
    rparams = _ref_params(name, ref_cfg)
    rx, px = _extra(name, rbatch)
    want = np.asarray(ref.forward(ref_cfg, rparams, rbatch, *rx))
    with torch.no_grad():
        got = port.forward(cfg, transformer_params_from_reference(rparams, "cpu"), pbatch, *px)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL[name], atol=RTOL[name] * float(np.abs(want).max()))
    # op by op, not jitted: XLA's fusions reorder float32 sums, and for
    # EquiformerV2 the reference's jitted and unjitted gradients alone part
    # by up to 6e-5 of a leaf's largest value
    rloss, rgrads = jax.value_and_grad(lambda p: ref.loss_fn(ref_cfg, p, rbatch, *rx))(rparams)
    loss, grads = _grads(port, cfg, transformer_params_from_reference(rparams, "cpu"), pbatch, *px)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=RTOL[name])
    _assert_grads_close(grads, rgrads)
    return float(loss)


def test_configs_match_the_reference():
    from repro.configs import get_arch as ref_get_arch
    from repro.configs import gnn_harness as RH

    for name in ARCHS:
        arch, ref = get_arch(name), ref_get_arch(name)
        for port_cfg, ref_cfg in ((arch.full(), ref.full()), (arch.smoke(), ref.smoke())):
            assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)
        assert (arch.name, arch.family, arch.notes) == (ref.name, ref.family, ref.notes)
        assert {k: (s.kind, s.meta) for k, s in arch.shapes.items()} == \
            {k: (s.kind, s.meta) for k, s in ref.shapes.items()}
        cfg_mod = importlib.import_module(f"repro_torch.configs.{MODULE[name]}")
        ref_mod = importlib.import_module(f"repro.configs.{MODULE[name]}")
        for shape, sd in H.GNN_SHAPES.items():
            full = arch.full()
            got = cfg_mod._cfg_for_shape(full, shape, sd.meta)
            want = ref_mod._cfg_for_shape(ref.full(), shape, sd.meta) if hasattr(ref_mod, "_cfg_for_shape") \
                else ref.full()
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert H.model_flops_estimate(name, got, sd.meta) == RH.model_flops_estimate(name, want, sd.meta)
    assert H.EQUIFORMER_CHUNKS == RH.EQUIFORMER_CHUNKS
    assert H.DIMENET_TRIPLET_CAP == RH.DIMENET_TRIPLET_CAP
    assert all(H._pad(x) == RH._pad(x) for x in (1, 511, 512, 2708, 3840, 2449029))


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_has_the_references_tree(name):
    import jax

    ref, port = _modules(name)
    ref_cfg = get_arch(name).full() if name != "equiformer-v2" else get_arch(name).smoke()
    got = port.init_params(ref_cfg, torch.Generator().manual_seed(0), device="cpu")
    want = jax.eval_shape(lambda: ref.init_params(ref_cfg, jax.random.PRNGKey(0)))
    assert jax.tree.structure(jax.tree.map(lambda x: 0, want)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, got, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(a.shape) == tuple(b.shape) and a.dtype == torch.float32 and str(b.dtype) == "float32"
    # scales: one weight matrix a tree, N(0, 1/fan_in)
    w = {"pna": lambda p: p["layers"][0]["upd_w"], "gatedgcn": lambda p: p["layers"][0]["A"],
         "dimenet": lambda p: p["blocks"][0]["w_msg"], "equiformer-v2": lambda p: p["layers"][0]["so2_w0"]}[name](got)
    assert abs(float(w.std()) * w.shape[0] ** 0.5 - 1.0) < 0.1


@pytest.mark.parametrize("name", ARCHS)
def test_forward_loss_and_grads_match_the_reference(name):
    from repro.configs import get_arch as ref_get_arch

    ref_cfg = ref_get_arch(name).smoke()
    rbatch, pbatch = _batches(name, ref_cfg)
    assert np.isfinite(_check_arch(name, ref_cfg, rbatch, pbatch))


def test_random_graph_batch_takes_the_references_draws():
    from repro.models.gnn import common as rg

    for geometric in (False, True):
        want = rg.random_graph_batch(np.random.default_rng(7), 20, 50, 5, edge_feat_dim=3, geometric=geometric)
        got = g.random_graph_batch(np.random.default_rng(7), 20, 50, 5, edge_feat_dim=3, geometric=geometric,
                                   device="cpu")
        for f in g.GraphBatch._fields:
            assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f))), f
    assert got.to("cpu").num_nodes == 20 and got.num_edges == 50


def test_segment_helpers_follow_jax_on_empty_segments_and_ties():
    import jax
    import jax.numpy as jnp

    data = np.array([[1.0, -2.0], [3.0, 5.0], [3.0, 0.5], [-1.0, 0.5]], np.float32)
    ids = np.array([0, 2, 2, 0])
    for op, ref in ((g.segment_max, jax.ops.segment_max), (g.segment_min, jax.ops.segment_min),
                    (g.segment_sum, jax.ops.segment_sum)):
        got = op(torch.from_numpy(data), torch.from_numpy(ids), 4)
        want = np.asarray(ref(jnp.asarray(data), jnp.asarray(ids), 4))
        assert np.array_equal(got.numpy(), want)  # rows 1 and 3 empty: -inf / +inf / 0
    # a tie splits the gradient evenly in both libraries
    x = torch.tensor([1.0, 3.0, 3.0], requires_grad=True)
    (gx,) = torch.autograd.grad(g.segment_max(x, torch.tensor([0, 0, 0]), 1).sum(), x)
    want = jax.grad(lambda a: jax.ops.segment_max(a, jnp.array([0, 0, 0]), 1).sum())(jnp.array([1.0, 3.0, 3.0]))
    assert np.array_equal(gx.numpy(), np.asarray(want)) and np.array_equal(gx.numpy(), [0.0, 0.5, 0.5])
    np.testing.assert_allclose(g.segment_mean(torch.from_numpy(data), torch.from_numpy(ids), 4).numpy(),
                               np.asarray(__import__("repro.models.gnn.common", fromlist=["x"]).segment_mean(
                                   jnp.asarray(data), jnp.asarray(ids), 4)), rtol=1e-7)


def test_pna_with_a_repeated_edge_and_an_isolated_node():
    """A repeated edge ties max and min inside one segment (the gradient
    splits), an isolated node has degree 0 (max/min read 0, the scalers
    log 1), and a padded (masked) edge points at node 0."""
    from repro.configs import get_arch as ref_get_arch
    from repro.models.gnn import common as rg

    ref_cfg = ref_get_arch("pna").smoke()
    n, e = 12, 30
    rng = np.random.default_rng(3)
    src = rng.integers(0, n - 1, e)
    dst = rng.integers(0, n - 1, e)  # node n - 1 is isolated
    src[5], dst[5] = src[4], dst[4]  # a repeated edge
    emask = np.ones(e, bool)
    emask[-2:] = False
    src[-2:], dst[-2:] = 0, 0
    feat = rng.standard_normal((n, ref_cfg.d_in)).astype(np.float32)
    efeat = rng.standard_normal((e, 8)).astype(np.float32)
    labels = rng.integers(0, ref_cfg.num_classes, n)
    nmask = np.ones(n, bool)
    pos = np.zeros((n, 3), np.float32)
    import jax.numpy as jnp

    rbatch = rg.GraphBatch(*(jnp.asarray(a) for a in (feat, src.astype(np.int32), dst.astype(np.int32), efeat,
                                                       nmask, emask, pos, labels.astype(np.int32))))
    pbatch = g.batch_from_numpy(feat, src, dst, efeat, nmask, emask, pos, labels, device="cpu")
    _check_arch("pna", ref_cfg, rbatch, pbatch)


def test_out_of_range_labels_read_nan_as_the_reference():
    import jax.numpy as jnp

    from repro.models.gnn import common as rg

    logits = np.arange(8, dtype=np.float32).reshape(2, 4)
    for labels in ([1, 2], [5, 1]):
        want = float(rg.node_classification_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.ones(2)))
        got = float(g.node_classification_loss(torch.from_numpy(logits), torch.tensor(labels), torch.ones(2)))
        assert (np.isnan(got) and np.isnan(want)) or np.isclose(got, want, rtol=1e-7)


@pytest.mark.parametrize("l", range(7))
def test_wigner_d_real_matches_the_reference(l):
    import jax.numpy as jnp

    from repro.models.gnn import wigner as rw

    rng = np.random.default_rng(l)
    alpha = rng.uniform(-np.pi, np.pi, 64).astype(np.float32)
    beta = rng.uniform(0, np.pi, 64).astype(np.float32)
    want = np.asarray(rw.wigner_d_real(l, jnp.asarray(alpha), jnp.asarray(beta)))
    got = wigner.wigner_d_real(l, torch.from_numpy(alpha), torch.from_numpy(beta))
    assert got.dtype == torch.float32 and tuple(got.shape) == (64, 2 * l + 1, 2 * l + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    eye = torch.eye(2 * l + 1).expand(64, -1, -1)
    torch.testing.assert_close(got @ got.transpose(-1, -2), eye, atol=1e-5, rtol=0)  # orthogonal
    rvec = rng.standard_normal((64, 3)).astype(np.float32)
    for a, b in zip(wigner.align_to_z_angles(torch.from_numpy(rvec)), rw.align_to_z_angles(jnp.asarray(rvec))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("inverse", [False, True])
def test_rotate_block_matches_the_reference(inverse):
    import jax.numpy as jnp

    from repro.models.gnn import wigner as rw

    rng = np.random.default_rng(5)
    l_max, e, c = 3, 20, 6
    alpha, beta = (rng.uniform(-3, 3, e).astype(np.float32) for _ in range(2))
    feats = rng.standard_normal((e, (l_max + 1) ** 2, c)).astype(np.float32)
    rd = {l: rw.wigner_d_real(l, jnp.asarray(alpha), jnp.asarray(beta)) for l in range(l_max + 1)}
    pd = {l: torch.from_numpy(np.asarray(m)) for l, m in rd.items()}
    want = rw.rotate_block(jnp.asarray(feats), rd, l_max, inverse=inverse)
    got = wigner.rotate_block(torch.from_numpy(feats), pd, l_max, inverse=inverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_dimenet_bases_match_the_reference():
    import jax.numpy as jnp

    from repro.configs import get_arch as ref_get_arch
    from repro.models.gnn import dimenet as rd

    cfg = ref_get_arch("dimenet").full()
    rng = np.random.default_rng(11)
    d = np.concatenate([[0.0, 1e-7], rng.uniform(0, 6, 200)]).astype(np.float32)  # with the clamps
    c = rng.uniform(-1, 1, d.shape[0]).astype(np.float32)
    T, J = torch.from_numpy, jnp.asarray
    np.testing.assert_allclose(dimenet.bessel_rbf(T(d), 6, 5.0).numpy(), np.asarray(rd.bessel_rbf(J(d), 6, 5.0)),
                               rtol=1e-5, atol=1e-5)
    x = rng.uniform(0, 20, (50, 6)).astype(np.float32)
    np.testing.assert_allclose(dimenet._sph_bessel(6, T(x)).numpy(), np.asarray(rd._sph_bessel(6, J(x))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dimenet._legendre(6, T(c)).numpy(), np.asarray(rd._legendre(6, J(c))),
                               rtol=1e-5, atol=1e-6)
    pcfg = dimenet.DimeNetConfig(**dataclasses.asdict(cfg))
    np.testing.assert_allclose(dimenet.spherical_basis(T(d), T(c), pcfg).numpy(),
                               np.asarray(rd.spherical_basis(J(d), J(c), cfg)), rtol=1e-5, atol=1e-6)


def test_equiformer_chunked_layer_matches_the_reference_and_the_exact_layer():
    """edge_chunk 64 over 160 edges: 3 chunks, the last padded."""
    from repro.configs import get_arch as ref_get_arch

    ref_cfg = dataclasses.replace(ref_get_arch("equiformer-v2").smoke(), edge_chunk=64)
    rbatch, pbatch = _batches("equiformer-v2", ref_cfg, rng_seed=2)
    chunked_loss = _check_arch("equiformer-v2", ref_cfg, rbatch, pbatch)
    params = transformer_params_from_reference(_ref_params("equiformer-v2", ref_cfg), "cpu")
    chunked = equiformer_v2.EquiformerV2Config(**dataclasses.asdict(ref_cfg))
    exact = dataclasses.replace(chunked, edge_chunk=0)
    exact_loss, exact_grads = _grads(equiformer_v2, exact, params, pbatch)
    _, chunked_grads = _grads(equiformer_v2, chunked, transformer_params_from_reference(
        _ref_params("equiformer-v2", ref_cfg), "cpu"), pbatch)
    np.testing.assert_allclose(chunked_loss, float(exact_loss), rtol=1e-4)
    for a, b in zip(chunked_grads, exact_grads):
        assert float((a - b).abs().max()) <= GRAD_TOL * max(float(b.abs().max()), 1e-30)


def _check_batch():
    """``gnn_card_vs_cpu``'s EquiformerV2 batch: 8 graphs of ``molecule``'s
    layout (240 nodes, 512 edges)."""
    return H.molecule_batch(dict(n_nodes=240, n_edges=512, d_feat=16), num_species=16,
                            generator=torch.Generator().manual_seed(40), device="cpu")


def _reference_batch(batch):
    from repro.models.gnn import common as rg

    return rg.GraphBatch(*(np.asarray(x.numpy(), np.int32) if x.dtype == torch.int64 else x.numpy()
                           for x in batch))


def test_equiformer_gradients_grow_sensitive_with_depth_at_full_width():
    """Why the card-vs-CPU check holds EquiformerV2 at one layer: at full
    widths (d 128, l_max 6, m_max 2) with random weights, a relative 1e-7
    nudge of the weights moves one layer's gradients by under 1e-5 of a
    leaf's largest value, and three layers' by over 1e-4 -- more than any
    two float32 roundings of the same function may be held to."""
    from repro_torch.optim.adamw import tree_map

    full = get_arch("equiformer-v2").full()
    batch = _check_batch()

    def sensitivity(layers):
        cfg = dataclasses.replace(full, num_layers=layers)
        params = equiformer_v2.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        gen = torch.Generator().manual_seed(5)
        nudged = tree_map(lambda x: x * (1 + 1e-7 * torch.randn(x.shape, generator=gen)), params)
        _, g0 = _grads(equiformer_v2, cfg, params, batch)
        _, g1 = _grads(equiformer_v2, cfg, nudged, batch)
        return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30) for a, b in zip(g1, g0))

    assert sensitivity(1) < 1e-5
    assert sensitivity(3) > 1e-4


def test_the_references_equiformer_gradients_grow_sensitive_with_depth_too():
    """The reading above, of the reference (its jitted gradient, weights
    from its own ``init_params``) on the same batch: a relative 1e-7 nudge
    moves one layer's gradients by under 1e-5 of a leaf's largest value and
    three layers' by over 1e-4.  The depth sensitivity is the function's,
    not the port's rounding."""
    import jax

    from repro.configs import get_arch as ref_get_arch
    from repro.models.gnn import equiformer_v2 as ref

    full = ref_get_arch("equiformer-v2").full()
    batch = _reference_batch(_check_batch())

    def sensitivity(layers):
        cfg = dataclasses.replace(full, num_layers=layers)
        params = jax.tree.map(np.asarray, ref.init_params(cfg, jax.random.PRNGKey(0)))
        rng = np.random.default_rng(5)
        nudged = jax.tree.map(lambda x: (x * (1 + 1e-7 * rng.standard_normal(x.shape))).astype(x.dtype), params)
        grad = jax.jit(jax.grad(lambda p: ref.loss_fn(cfg, p, batch)))
        g0, g1 = jax.tree.leaves(grad(params)), jax.tree.leaves(grad(nudged))
        return max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) / max(float(np.abs(np.asarray(b)).max()), 1e-30)
                   for a, b in zip(g1, g0))

    assert sensitivity(1) < 1e-5
    assert sensitivity(3) > 1e-4
