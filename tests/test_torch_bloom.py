"""Port parity: the Bloom query kernel K3's division-free modulo and its ragged
cases.

The kernel reduces a probe modulo M without a division: a mask when M is a
power of two, else ``umulhi64(c * x mod 2**64, M)`` with the constant the
wrapper computes (Lemire, Kaser and Kurz).  On the CPU that arithmetic is
emulated in Python integers and held against ``%``, and the port's plain
version against the reference kernel (interpret mode) at non-power-of-two M.
On the card (``gpu`` marker: skips without a CUDA device) the kernel is held
against the plain version at ragged N, non-power-of-two M, k from 1 to 8,
Q = 9 and on views that do not start on 16 bytes.  The reference is imported
inside the tests that use it, so ``pytest -m gpu`` runs this file where JAX
is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import bloom as K3
from test_torch_ell_spmv import _misaligned

U32 = 2**32
U64 = 2**64


def _kernel_mod(x: int, m: int) -> int:
    """``mod_bits`` of ``csrc/bloom.cu`` in Python integers."""
    if m & (m - 1) == 0:
        return x & (m - 1)
    return ((K3.fastmod_constant(m) * x) % U64 * m) // U64


@pytest.mark.parametrize("m", [32, 1184, 1 << 10, 1 << 26, U32 - 32])
def test_fastmod_reduces_like_modulo(m):
    c = K3.fastmod_constant(m)
    assert 0 < c < U64
    edges = {0, 1, 2, 31, 32, m - 1, m, m + 1, 2 * m - 1, 2 * m, 2**31 - 1, 2**31, U32 - 2, U32 - 1}
    top = U32 // m  # the multiples of M nearest 0 and 2**32, each with its neighbours
    for k in [*range(1, 65), *range(max(top - 64, 1), top + 1)]:
        edges |= {k * m - 1, k * m, k * m + 1}
    rng = np.random.default_rng(m % 2**31)
    randoms = rng.integers(0, U32, size=20000, dtype=np.uint64)
    xs = sorted(x for x in edges if 0 <= x < U32) + [int(x) for x in randoms]
    for x in xs:
        assert ((c * x) % U64 * m) // U64 == x % m, x  # the reciprocal, whatever M
        assert _kernel_mod(x, m) == x % m, x  # the form the kernel takes for this M


@pytest.mark.parametrize("q,n,mbits,k", [(2, 37, 1184, 3), (9, 5, 32 * 37 * 3, 8), (1, 1, 32, 1),
                                         (3, 130, 32 * 1001, 4)])
def test_bloom_query_non_power_of_two_bits_matches_reference_kernel(q, n, mbits, k):
    import jax.numpy as jnp

    from repro.core import bloom as rb
    from repro.kernels import ops
    from repro.kernels.bloom import pack_bits

    rng = np.random.default_rng(q * n + mbits)
    v = rng.integers(0, 5000, size=(q, n)).astype(np.int32)
    i = rng.integers(0, 64, size=(q, n)).astype(np.int32)
    mask = rng.random((q, n)) < 0.5
    salt = np.arange(q, dtype=np.int32) * 7 + 1
    flt = rb.insert(rb.make((q,), mbits, num_hashes=k), jnp.asarray(v), jnp.asarray(i), jnp.asarray(mask),
                    salt=jnp.asarray(salt)[:, None])
    words = K3.pack_bits(torch.from_numpy(np.array(flt.bits)))
    got = K3.bloom_query(words, torch.from_numpy(v), torch.from_numpy(i), torch.from_numpy(salt), num_hashes=k)
    want = ops.bloom(pack_bits(flt.bits), jnp.asarray(v), jnp.asarray(i), jnp.asarray(salt), num_hashes=k,
                     block_n=256, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy()[mask].all()  # no false negatives


# ---------------------------------------------------------------- on the card
# (Q, N, M, k, operands off 16 bytes): N empty, shorter than a quad, one key
# past a multiple of four; M a power of two or not; k from 1 to 8; Q = 9 rows,
# whose starts fall on every offset mod 4
CUDA_CASES = [
    (3, 0, 1 << 10, 4, None),
    (3, 1, 1 << 10, 4, None),
    (3, 3, 1 << 10, 4, None),
    (3, 5, 1 << 10, 4, None),
    (9, 4097, 1 << 10, 4, None),
    (2, 4097, 1184, 4, None),
    (9, 1000, 32 * 37 * 101, 8, None),
    (4, 999, 1 << 12, 1, None),
    (4, 999, 1 << 12, 8, None),
    (9, 4097, 1 << 14, 4, "v"),
    (3, 1030, 1184, 4, "i"),
    (9, 5, 1 << 10, 8, "all"),
    (8, 100003, 1 << 20, 4, "all"),
]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("q,n,mbits,k,misaligned", CUDA_CASES)
def test_bloom_query_cuda_kernel_ragged_and_views(q, n, mbits, k, misaligned):
    """Bit-equal to the plain version with one launch (none for no key)."""
    _need_cuda()
    rng = np.random.default_rng(q * n + mbits + k)
    fill = np.linspace(0.3, 0.9, q)[:, None]  # deep probes in the fuller rows
    words = K3.pack_bits(torch.from_numpy(rng.random((q, mbits)) < fill).cuda())
    v = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=(q, n)).astype(np.int32)).cuda()
    i = torch.from_numpy(rng.integers(0, 64, size=(q, n)).astype(np.int32)).cuda()
    salt = torch.from_numpy(rng.integers(0, 2**31 - 1, size=q).astype(np.int32)).cuda()
    if misaligned in ("v", "all"):
        v = _misaligned(v)
    if misaligned in ("i", "all"):
        i = _misaligned(i)
    if misaligned == "all":
        words, salt = _misaligned(words), _misaligned(salt)
    n0 = K3.LAUNCHES
    got = K3.bloom_query(words, v, i, salt, num_hashes=k)
    torch.cuda.synchronize()
    assert K3.LAUNCHES == n0 + (1 if q * n else 0)
    assert got.shape == (q, n) and got.dtype == torch.bool
    assert torch.equal(got, K3.bloom_query_ref(words, v, i, salt, num_hashes=k))
