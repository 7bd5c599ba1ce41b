"""Port parity: the optimizers (``repro_torch.optim``).

``adamw_update`` against the reference's on the same parameter tree and
gradients for 1 and 10 steps, with the global-norm clip engaged and not:
parameters, moments and the norm within rtol 1e-6 (float32, the same
operations; the norm sums the leaves in the same order), the step counter
equal.  ``cosine_with_warmup`` at every step of a schedule within 1e-6.
The int8 error-feedback compression draws its rounding noise from a
``torch.Generator`` where the reference splits a JAX key, so it is held to
its function: the quantization against the same formula on the same noise,
and the error-feedback identity ``dequantized + error = corrected``.
"""

import numpy as np
import pytest
import torch

from repro_torch.optim import AdamWState, adamw_init, adamw_update, cosine_with_warmup, global_norm
from repro_torch.optim import compression as C
from repro_torch.optim.adamw import tree_leaves, tree_map


def _tree(rng, scale):
    """A nested tree like a GNN's: dicts (keys out of order) and a list."""
    r = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    return {"w": r(4, 3), "b": r(3), "layers": [{"z": r(2, 2), "a": r(5)}, {"z": r(2, 2), "a": r(5)}]}


def _to_torch(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _close(got_tree, want_tree, rtol):
    import jax

    got, want = tree_leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=rtol * float(np.abs(b).max()))


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("grad_scale", [0.01, 3.0])  # 3.0 engages the clip (norm > 1)
def test_adamw_update_matches_the_reference(steps, grad_scale):
    import jax
    import jax.numpy as jnp

    from repro.optim import adamw_init as ref_init
    from repro.optim import adamw_update as ref_update

    rng = np.random.default_rng(steps)
    params = _tree(rng, 1.0)
    rp, ro = jax.tree.map(jnp.asarray, params), None
    ro = ref_init(rp)
    pp = _to_torch(params)
    po = adamw_init(pp)
    assert po.step.dtype == torch.int32 and int(po.step) == 0
    for i in range(steps):
        grads = _tree(rng, grad_scale)
        rp, ro, rn = ref_update(rp, jax.tree.map(jnp.asarray, grads), ro, lr=1e-3)
        pp, po, pn = adamw_update(pp, _to_torch(grads), po, lr=1e-3)
        np.testing.assert_allclose(float(pn), float(rn), rtol=1e-6)
        if grad_scale > 1:
            assert float(pn) > 1.0  # the clip scales this step's gradient
    _close(pp, rp, 1e-6)
    _close(po.mu, ro.mu, 1e-6)
    _close(po.nu, ro.nu, 1e-6)
    assert int(po.step) == int(ro.step) == steps and isinstance(po, AdamWState)


def test_adamw_keeps_the_tree_and_global_norm_sums_every_leaf():
    rng = np.random.default_rng(0)
    pp = _to_torch(_tree(rng, 1.0))
    grads = _to_torch(_tree(rng, 1.0))
    new, state, gn = adamw_update(pp, grads, adamw_init(pp))
    assert list(new) == list(pp) and len(new["layers"]) == 2 and isinstance(new["layers"], list)
    want = np.sqrt(sum(float((x.double() ** 2).sum()) for x in tree_leaves(grads)))
    np.testing.assert_allclose(float(global_norm(grads)), want, rtol=1e-6)
    np.testing.assert_allclose(float(gn), want, rtol=1e-6)
    assert all(not x.requires_grad for x in tree_leaves(new))


def test_cosine_with_warmup_matches_the_reference():
    import jax.numpy as jnp

    from repro.optim import cosine_with_warmup as ref

    steps = np.arange(0, 130)
    for kw in (dict(peak_lr=3e-4, warmup=10, total=120), dict(peak_lr=1.0, warmup=0, total=50, floor=0.0)):
        got = cosine_with_warmup(torch.from_numpy(steps), **kw).numpy()
        want = np.asarray(ref(jnp.asarray(steps), **kw))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert float(cosine_with_warmup(5, peak_lr=1.0, warmup=10, total=20)) == pytest.approx(0.5)


def test_int8_compression_is_the_references_function_with_error_feedback():
    rng = np.random.default_rng(4)
    grads = _to_torch(_tree(rng, 2.0))
    errors = C.init_error_feedback(grads)
    assert all(not e.any() for e in tree_leaves(errors))
    gen = torch.Generator().manual_seed(1)
    qs, scales, new_errs = C.compress_grads(grads, errors, gen)
    deq = C.decompress_grads(qs, scales)
    # the same noise from the same generator state, through the reference's formula
    gen2 = torch.Generator().manual_seed(1)
    for g, q, s, e, d in zip(*(tree_leaves(t) for t in (grads, qs, scales, new_errs, deq))):
        assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
        x = g.numpy()
        want_s = max(np.abs(x).max(), 1e-12) / 127.0
        noise = (torch.rand(g.shape, generator=gen2) - 0.5).numpy()
        want_q = np.clip(np.round(x / np.float32(want_s) + noise), -127, 127).astype(np.int8)
        np.testing.assert_allclose(float(s), want_s, rtol=1e-6)
        assert np.abs(q.numpy().astype(int) - want_q.astype(int)).max() <= 1  # a rounding tie at most
        torch.testing.assert_close(d + e, g, rtol=0, atol=1e-6)  # error feedback keeps the remainder
        assert float((d - g).abs().max()) <= float(s) * 1.0001  # within one quantization step
    # the next step's corrected gradient carries the remainder
    qs2, scales2, errs2 = C.compress_grads(grads, new_errs, gen)
    for g, e, q, s, e2 in zip(*(tree_leaves(t) for t in (grads, new_errs, qs2, scales2, errs2))):
        torch.testing.assert_close(C.dequantize_int8(q, s) + e2, g + e, rtol=0, atol=1e-6)
