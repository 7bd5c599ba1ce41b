"""Port parity: ``ell_spmv`` against the reference Pallas kernel.

On the CPU the wrapper runs its plain PyTorch version; it is held against the
reference kernel in interpret mode, as ``tests/test_kernels.py`` runs it.  The
CUDA kernel is held against the plain version on the card (``gpu`` marker:
skips without a CUDA device).  The reference is imported inside the tests
that use it, so ``pytest -m gpu`` runs this file where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ell_spmv as K

SEMIRINGS = ["min_plus", "min_hop", "min_label", "pr_sum"]
SHAPES = [(1, 16, 4), (3, 100, 8), (2, 257, 16), (4, 128, 32)]


def _ell_inputs(rng, q, v, d, semiring):
    nbr = rng.integers(0, v + 1, size=(v, d)).astype(np.int32)  # v = identity slot
    w = rng.integers(1, 10, size=(v, d)).astype(np.float32)
    if semiring == "pr_sum":
        states = np.concatenate(
            [rng.random((q, v), np.float32), np.zeros((q, 1), np.float32)], 1
        )
        carry = np.full((q, v), 0.15, np.float32)
    else:
        states = np.concatenate(
            [rng.random((q, v), np.float32) * 10, np.full((q, 1), np.inf, np.float32)], 1
        )
        carry = rng.random((q, v)).astype(np.float32) * 10
    return states, nbr, w, carry


def _hop_cap(semiring):
    return 4.0 if semiring == "min_hop" else float("inf")


def _check(semiring, got, want):
    if semiring == "pr_sum":
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("q,v,d", SHAPES)
def test_ell_spmv_matches_reference_kernel(semiring, q, v, d):
    import jax.numpy as jnp

    from repro.kernels import ops, ref

    rng = np.random.default_rng(hash((semiring, q, v, d)) % 2**31)
    arrs = _ell_inputs(rng, q, v, d, semiring)
    want = ops.spmv(*map(jnp.asarray, arrs), semiring=semiring, block_v=64,
                    interpret=True, hop_cap=_hop_cap(semiring))
    before = K.LAUNCHES
    got = K.ell_spmv(*map(torch.from_numpy, arrs), semiring=semiring, hop_cap=_hop_cap(semiring))
    assert K.LAUNCHES == before  # the CPU path launches no kernel
    assert got.dtype == torch.float32 and tuple(got.shape) == (q, v)
    _check(semiring, got.numpy(), np.asarray(want))
    plain = ref.ell_spmv_ref(*map(jnp.asarray, arrs), semiring=semiring, hop_cap=_hop_cap(semiring))
    _check(semiring, got.numpy(), np.asarray(plain))


def test_ell_spmv_checks_its_operands():
    arrs = [torch.from_numpy(x) for x in _ell_inputs(np.random.default_rng(0), 2, 10, 4, "min_plus")]
    states, nbr, w, carry = arrs
    with pytest.raises(ValueError, match="semiring"):
        K.ell_spmv(states, nbr, w, carry, semiring="max_times")
    with pytest.raises(TypeError):
        K.ell_spmv(states, nbr.long(), w, carry)
    with pytest.raises(ValueError):
        K.ell_spmv(states[:, :10], nbr, w, carry)  # no sentinel column
    with pytest.raises(ValueError):
        K.ell_spmv(states, nbr, w[:, :2], carry)
    with pytest.raises(ValueError, match="cuda or cpu"):
        K.ell_spmv(*(x.to("meta") for x in arrs))


@pytest.mark.gpu
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("q,v,d", SHAPES + [(9, 3000, 24)])
def test_ell_spmv_cuda_kernel_matches_plain(semiring, q, v, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(hash((semiring, q, v, d, "cuda")) % 2**31)
    arrs = [torch.from_numpy(x).cuda() for x in _ell_inputs(rng, q, v, d, semiring)]
    before = K.LAUNCHES
    got = K.ell_spmv(*arrs, semiring=semiring, hop_cap=_hop_cap(semiring))
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    want = K.ell_spmv_ref(*arrs, semiring=semiring, hop_cap=_hop_cap(semiring))
    _check(semiring, got.cpu().numpy(), want.cpu().numpy())
