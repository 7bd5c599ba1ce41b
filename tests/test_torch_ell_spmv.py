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
    # meta tensors (the dry-run's) give the output's shape, no data
    out = K.ell_spmv(*(x.to("meta") for x in arrs))
    assert (out.device.type, tuple(out.shape), out.dtype) == ("meta", tuple(carry.shape), torch.float32)


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


@pytest.mark.parametrize("identity", [float("inf"), 0.0])
@pytest.mark.parametrize("q,v", [(1, 1), (3, 17), (8, 100)])
def test_transpose_states_equals_cat_then_transpose(q, v, identity):
    """The engine's one-pass ``[V+1, Q]`` states equal the two-pass form
    ``torch.cat([cur, identity column], 1).t()``, bit for bit."""
    cur = torch.from_numpy(np.random.default_rng(q * v).random((q, v), np.float32))
    want = torch.cat([cur, torch.full((q, 1), identity)], 1).t()
    got = K.transpose_states(cur, identity)
    assert got.is_contiguous() and got.shape == (v + 1, q)
    assert torch.equal(got, want)


@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_ell_spmv_takes_transposed_states(semiring):
    """``transposed=True`` (the engine's path) gives what the public layout
    gives."""
    arrs = [torch.from_numpy(x) for x in _ell_inputs(np.random.default_rng(7), 3, 50, 8, semiring)]
    states, rest = arrs[0], arrs[1:]
    want = K.ell_spmv(states, *rest, semiring=semiring, hop_cap=_hop_cap(semiring))
    got = K.ell_spmv(states.t().contiguous(), *rest, semiring=semiring, hop_cap=_hop_cap(semiring),
                     transposed=True)
    assert torch.equal(got, want)


def _misaligned(t):
    """A contiguous copy of ``t`` whose data does not start on 16 bytes."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    off = (4 - (buf.data_ptr() // t.element_size()) % 4) % 4 + 1
    out = buf[off : off + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("misaligned", [None, "states", "adjacency"])
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("q,v,d", [(1, 65, 24), (3, 130, 7), (8, 1000, 24), (9, 333, 6), (8, 300, 101)])
def test_ell_spmv_cuda_kernel_ragged_padding_and_views(q, v, d, semiring, misaligned):
    """Q in {1, 3, 8, 9}, V no multiple of the row tile, odd D, a row that
    starts with padding and a row of padding only (the kernel takes the
    sentinel's values for padding cells), a D too wide for the shared-memory
    tiles (101), and views whose data is not 16-byte aligned."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(hash((q, v, d, semiring, misaligned)) % 2**31)
    states, nbr, w, carry = (torch.from_numpy(x).cuda() for x in _ell_inputs(rng, q, v, d, semiring))
    nbr[0, 0] = v  # padding first
    nbr[1, :] = v  # nothing but padding
    w[0, 0] = w[1, :] = 0.0  # as GraphSnapshot.to_ell writes padding cells
    states_t = states.t().contiguous()
    if misaligned == "states":
        states_t = _misaligned(states_t)
    if misaligned == "adjacency":
        nbr, w = _misaligned(nbr), _misaligned(w)
    before = K.LAUNCHES
    got = K.ell_spmv(states_t, nbr, w, carry, semiring=semiring, hop_cap=_hop_cap(semiring),
                     transposed=True)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    want = K.ell_spmv_ref(states, nbr, w, carry, semiring=semiring, hop_cap=_hop_cap(semiring))
    _check(semiring, got.cpu().numpy(), want.cpu().numpy())
    assert torch.equal(got[:, 1], carry[:, 1])  # a row of padding only keeps its carry
