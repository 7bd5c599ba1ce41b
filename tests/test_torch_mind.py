"""Port parity: MIND scoring (``repro_torch.models.recsys``) and its config.

The reference's smoke config and a wider one (``repro/models/recsys/mind.py``,
weights from its ``init_params``, carried across by the generic converter
as a flat float32 dict) against the port on the same numpy-seeded users,
masks and candidates: ``user_interests``, ``serve_scores``,
``retrieval_scores``, ``label_aware_attention`` and ``loss_fn``'s value at
rtol/atol 1e-5 (float32, the same products summed in another order), the
EmbeddingBag functions in both modes at 1e-6.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs import mind as C
from repro_torch.core.convert import transformer_params_from_reference
from repro_torch.launch import model_serve as MS
from repro_torch.models.recsys import embeddingbag as eb
from repro_torch.models.recsys import mind as m

ARCH = get_arch("mind")
RTOL = ATOL = 1e-5


def _ref_cfg(wide: bool):
    from repro.configs import get_arch as ref_get_arch

    cfg = ref_get_arch("mind").smoke()
    return dataclasses.replace(cfg, num_items=4096, embed_dim=64, seq_len=50, hidden=256) if wide else cfg


@functools.lru_cache(maxsize=None)
def _carried(wide: bool):
    import jax

    from repro.models.recsys import mind as rm

    ref_cfg = _ref_cfg(wide)
    params = jax.tree.map(np.asarray, rm.init_params(ref_cfg, jax.random.PRNGKey(3)))
    port = transformer_params_from_reference(params, device="cpu")
    cfg = m.MINDConfig(**{f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(ref_cfg)})
    return ref_cfg, params, cfg, port


def _inputs(cfg, b: int, c: int, seed: int):
    rng = np.random.default_rng(seed)
    beh = rng.integers(0, cfg.num_items, (b, cfg.seq_len))
    valid = rng.random((b, cfg.seq_len)) < 0.8
    valid[0] = False  # a user with no valid behaviour
    valid[1] = True
    cands = rng.integers(0, cfg.num_items, (b, c))
    return beh, valid, cands


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def test_config_matches_the_reference():
    from repro.configs import get_arch as ref_get_arch

    ref = ref_get_arch("mind")
    for port_cfg, ref_cfg in ((ARCH.full(), ref.full()), (ARCH.smoke(), ref.smoke())):
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)
    assert (ARCH.name, ARCH.family) == (ref.name, ref.family) == ("mind", "recsys")
    assert {k: (s.kind, s.meta) for k, s in ARCH.shapes.items()} == \
        {k: (s.kind, s.meta) for k, s in ref.shapes.items()}


def test_init_params_has_the_references_tree_and_distributions():
    import jax

    from repro.models.recsys import mind as rm

    cfg = dataclasses.replace(ARCH.smoke(), num_items=20000, embed_dim=64)
    got = m.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = jax.eval_shape(lambda: rm.init_params(cfg, jax.random.PRNGKey(0)))
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in got.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    assert abs(float(got["item_table"].std()) / 0.01 - 1.0) < 0.02
    assert abs(float(got["bilinear_s"].std()) * 8 - 1.0) < 0.1
    assert not got["mlp_b1"].any() and not got["mlp_b2"].any()


@pytest.mark.parametrize("wide", [False, True])
def test_scoring_matches_the_reference(wide):
    """user_interests, serve_scores, retrieval_scores and
    label_aware_attention on the smoke config and at the full config's
    widths (D 64, L 50, hidden 256) over a 4096-row table."""
    import jax.numpy as jnp

    from repro.models.recsys import mind as rm

    ref_cfg, rparams, cfg, params = _carried(wide)
    beh, valid, cands = _inputs(cfg, 6, 32, seed=4)
    J = lambda a: jnp.asarray(a)  # noqa: E731
    T = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    want = rm.user_interests(ref_cfg, rparams, J(beh), J(valid))
    got = m.user_interests(cfg, params, T(beh), T(valid))
    assert tuple(got.shape) == (6, 4, cfg.embed_dim)
    _close(got, want)
    _close(m.serve_scores(cfg, params, T(beh), T(valid), T(cands)),
           rm.serve_scores(ref_cfg, rparams, J(beh), J(valid), J(cands)))
    slab = np.arange(cfg.num_items)
    _close(m.retrieval_scores(cfg, params, T(beh[:2]), T(valid[:2]), T(slab)),
           rm.retrieval_scores(ref_cfg, rparams, J(beh[:2]), J(valid[:2]), J(slab)))
    t_emb = rparams["item_table"][cands[:, 0]]
    _close(m.label_aware_attention(got, T(t_emb)), rm.label_aware_attention(want, J(t_emb)))


def test_loss_value_matches_the_reference():
    import jax.numpy as jnp

    from repro.models.recsys import mind as rm

    ref_cfg, rparams, cfg, params = _carried(True)
    beh, valid, cands = _inputs(cfg, 8, 21, seed=5)
    target, neg = cands[:, 0], cands[:, 1:]
    want = rm.loss_fn(ref_cfg, rparams, *map(jnp.asarray, (beh, valid, target, neg)))
    got = m.loss_fn(cfg, params, *(torch.from_numpy(np.asarray(a)) for a in (beh, valid, target, neg)))
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=ATOL)


def test_step_makers_run_the_serve_and_retrieval_shapes():
    ref_cfg, _, cfg, params = _carried(False)
    beh, valid, cands = _inputs(cfg, 4, 16, seed=6)
    beh, valid, cands = (torch.from_numpy(a) for a in (beh, valid, cands))
    torch.testing.assert_close(C.make_serve(cfg)(params, beh, valid, cands),
                               m.serve_scores(cfg, params, beh, valid, cands), rtol=0, atol=0)
    slab = torch.arange(cfg.num_items)
    scores = C.make_retrieval(cfg)(params, beh[:1], valid[:1], slab)
    assert tuple(scores.shape) == (1, cfg.num_items)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bags_match_the_reference(mode):
    import jax.numpy as jnp

    from repro.models.recsys import embeddingbag as reb

    rng = np.random.default_rng(7)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    idx = rng.integers(0, 50, (6, 5))
    weights = rng.random((6, 5)).astype(np.float32)
    valid = rng.random((6, 5)) < 0.7
    valid[2] = False  # an empty bag
    T = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    for kw in ({}, {"valid": valid}, {"weights": weights, "valid": valid}):
        want = reb.embedding_bag_fixed(jnp.asarray(table), jnp.asarray(idx),
                                       None if "weights" not in kw else jnp.asarray(kw["weights"]),
                                       mode=mode, valid=None if "valid" not in kw else jnp.asarray(valid))
        got = eb.embedding_bag_fixed(T(table), T(idx), None if "weights" not in kw else T(kw["weights"]),
                                     mode=mode, valid=None if "valid" not in kw else T(valid))
        _close(got, want, rtol=1e-6, atol=1e-6)
    flat = rng.integers(0, 50, 17)
    bags = np.sort(rng.integers(0, 7, 17))  # bag 7 of 8 stays empty
    want = reb.embedding_bag_ragged(jnp.asarray(table), jnp.asarray(flat), jnp.asarray(bags), 8, mode=mode)
    got = eb.embedding_bag_ragged(T(table), T(flat), T(bags), 8, mode=mode)
    _close(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        eb.embedding_bag_fixed(T(table), T(idx), mode="max")


def test_model_serve_cli_scores_mind_on_the_cpu(capsys):
    MS.main(["--arch", "mind", "--device", "cpu"])
    assert "scored 4×64 candidates" in capsys.readouterr().out
    out = MS.mind_serve(ARCH, 3, device="cpu")
    assert tuple(out["scores"].shape) == (3, 64) and bool(torch.isfinite(out["scores"]).all())
