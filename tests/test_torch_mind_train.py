"""Port parity: MIND training (``models/recsys/mind.loss_fn``'s gradient,
``configs/mind.make_train_step``, ``launch/train.mind_setup``).

The reference's smoke config (512 items x 16, 8 behaviours, 3 routing
rounds), its weights from ``repro.launch.train._mind_setup`` carried
across, batches from ``data/synthetic.mind_batch`` (the same draws in both
packages; 32 users, 20 sampled negatives each):

- the sampled-softmax loss and its gradient against ``jax.value_and_grad``
  of the reference's, through the item table's gathers (a dense table
  gradient): the loss within rtol 1e-5, each leaf within 1e-5 of its
  largest |value|;
- three train steps (AdamW at lr 1e-3) against the reference's jitted
  ``_mind_setup`` step: losses within rtol 1e-5, gradient norms within
  1e-4, each final leaf within 1e-4 of its largest |value|.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.common import value_and_grad
from repro_torch.core.convert import transformer_params_from_reference
from repro_torch.launch import train as T
from repro_torch.models.recsys import mind as m
from repro_torch.optim.adamw import tree_leaves


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the smoke configs' operations are tiny,
    and the suite's parallel workers would otherwise run eight threads each
    on the same cores, which slowed these tests up to a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    """The reference's ``_mind_setup`` on its smoke config: ((params, opt),
    its jitted step, its data)."""
    from repro.configs import get_arch as ref_get_arch
    from repro.launch import train as ref_train

    arch = ref_get_arch("mind")
    return arch.smoke(), ref_train._mind_setup(arch, arch.smoke())


def _port_batch(arrays):
    return tuple(torch.from_numpy(np.asarray(x)).long() if np.asarray(x).dtype.kind == "i"
                 else torch.from_numpy(np.asarray(x)) for x in arrays)


def _leaf_rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got.detach().numpy() - want).max()) / max(float(np.abs(want).max()), 1e-30)


def test_loss_and_gradients_match_the_references_value_and_grad(reference):
    import jax
    import jax.numpy as jnp

    from repro.models.recsys import mind as rm

    rcfg, ((rparams, _), _, rdata) = reference
    cfg = get_arch("mind").smoke()
    assert (cfg.num_items, cfg.embed_dim, cfg.seq_len, cfg.hidden) == (
        rcfg.num_items, rcfg.embed_dim, rcfg.seq_len, rcfg.hidden)
    batch = rdata(0)
    rloss, rgrads = jax.value_and_grad(lambda p: rm.loss_fn(rcfg, p, *batch))(rparams)
    params = transformer_params_from_reference(jax.tree.map(np.asarray, rparams), "cpu")
    loss, grads = value_and_grad(lambda p: m.loss_fn(cfg, p, *_port_batch(batch)), params)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    for a, b in zip(tree_leaves(grads), jax.tree.leaves(rgrads)):
        assert _leaf_rel(a, b) <= 1e-5
    table = grads["item_table"]
    touched = np.unique(np.concatenate([np.asarray(x).reshape(-1) for x in (batch[0], batch[2], batch[3])]))
    assert table.shape == params["item_table"].shape and bool((table[touched] != 0).any())


def test_three_train_steps_match_the_references_mind_setup_step(reference):
    import jax

    rcfg, ((rparams, ropt), rstep, rdata) = reference
    params = transformer_params_from_reference(jax.tree.map(np.asarray, rparams), "cpu")
    (pp, po), pstep, pdata = T.mind_setup(get_arch("mind"), get_arch("mind").smoke(), params=params,
                                          device="cpu")
    rp, ro = rparams, ropt
    for step in range(3):
        batch = rdata(step)
        for a, b in zip(pdata(step), _port_batch(batch)):
            assert torch.equal(a, b)
        rp, ro, rmet = rstep(rp, ro, *batch)
        pp, po, pmet = pstep(pp, po, *pdata(step))
        np.testing.assert_allclose(float(pmet["loss"]), float(rmet["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pmet["gnorm"]), float(rmet["gnorm"]), rtol=1e-4)
    assert int(po.step) == int(ro.step) == 3
    for a, b in zip(tree_leaves(pp), jax.tree.leaves(rp)):
        assert _leaf_rel(a, b) <= 1e-4
