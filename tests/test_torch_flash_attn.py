"""Port parity: the attention kernel K5 (``flash_attention``).

On the CPU ``flash_attention`` runs its plain version, held against the
reference's Pallas kernel in interpret mode on the cases of
``tests/test_kernels.py::test_flash_attention_matches_ref`` plus causal
attention with Sq != Sk, ragged lengths and a strided cache-prefix view.
Tolerances are the reference test's: 2e-5 in float32 (the two sum the
same products in another order), 2e-2 in bfloat16 (one rounding of the
output, where an order difference can move it by one bf16 step).  The CUDA
kernel is held against the plain version on the card (``gpu`` marker:
skips without a CUDA device) at the same tolerances, and in bfloat16 also
within two bf16 steps (2^-6) of each output row's largest value, which
stays below the outputs as they shrink with Sk.  The reference is
imported inside the tests that use it, so ``pytest -m gpu`` runs this file
where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attn as K5

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
BF16_ROW_REL_TOL = 2.0**-6
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (b, hq, hkv, sq, sk, d, causal, block_q, block_k); blocks only for the
# reference kernel, whose wrapper needs Sq, Sk divisible by them
CASES = [
    (1, 2, 2, 128, 128, 64, True, 64, 64),  # the reference test's cases
    (2, 4, 2, 256, 256, 32, True, 64, 64),  # GQA 2:1
    (1, 8, 1, 128, 256, 64, False, 64, 64),  # MQA, cross-length
    (1, 4, 2, 64, 128, 64, True, 64, 64),  # causal, Sq < Sk: top-left mask
    (1, 4, 1, 96, 40, 16, True, 32, 40),  # causal, Sq > Sk
    (2, 6, 3, 72, 200, 64, False, 72, 40),  # ragged lengths
    (2, 4, 2, 1, 77, 64, False, 1, 77),  # one decode row
]


def _arrays(b, hq, hkv, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32))


def _reference(q, k, v, causal, dtype, block_q, block_k):
    import jax.numpy as jnp

    from repro.kernels import ops

    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    out = ops.attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), causal=causal,
                        block_q=block_q, block_k=block_k, interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,block_q,block_k", CASES)
def test_flash_attention_matches_reference_kernel(b, hq, hkv, sq, sk, d, causal, block_q, block_k, dtype):
    q, k, v = _arrays(b, hq, hkv, sq, sk, d, sq * 7 + sk + hq)
    tdt = DTYPES[dtype]
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    before = K5.LAUNCHES
    got = K5.flash_attention(tq, tk, tv, causal=causal)
    assert K5.LAUNCHES == before  # the CPU path launches no kernel
    assert got.dtype == tdt and got.shape == (b, hq, sq, d)
    assert torch.equal(got, K5.flash_attention_plain(tq, tk, tv, causal=causal))
    want = _reference(q, k, v, causal, dtype, block_q, block_k)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[tdt], rtol=TOL[tdt])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_reads_a_strided_cache_prefix(dtype):
    """Decode's form: k and v a prefix view of a longer cache (non-unit
    head and batch strides), against the reference on the prefix's copy."""
    b, hq, hkv, smax, n, d = 2, 8, 2, 100, 37, 64
    q, kc, vc = _arrays(b, hq, hkv, 1, smax, d, 5)
    tdt = DTYPES[dtype]
    tq, tkc, tvc = (torch.from_numpy(x).to(tdt) for x in (q, kc, vc))
    tk, tv = tkc[:, :, :n], tvc[:, :, :n]
    assert not tk.is_contiguous()
    got = K5.flash_attention(tq, tk, tv, causal=False)
    assert torch.equal(got, K5.flash_attention_plain(tq, tk.contiguous(), tv.contiguous(), causal=False))
    want = _reference(q, kc[:, :, :n], vc[:, :, :n], False, dtype, 1, n)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[tdt], rtol=TOL[tdt])


def test_causal_mask_is_the_kernels_not_attention_ref():
    """The TPU kernel masks row >= col (top-left); ``ref.attention_ref``
    masks tril(k=Sk-Sq) (bottom-right).  They differ when Sq != Sk, and the
    port follows the kernel (ROADMAP Queue 3)."""
    import jax.numpy as jnp

    from repro.kernels import ref

    q, k, v = _arrays(1, 4, 2, 64, 128, 64, 11)
    got = K5.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True).numpy()
    kernel = _reference(q, k, v, True, "float32", 64, 64)
    bottom_right = np.asarray(ref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    np.testing.assert_allclose(got, kernel, atol=2e-5, rtol=2e-5)
    assert np.abs(got - bottom_right).max() > 0.1


def test_flash_attention_checks_its_operands():
    q = torch.zeros(1, 4, 8, 64)
    k = torch.zeros(1, 2, 8, 64)
    with pytest.raises(TypeError):
        K5.flash_attention(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(TypeError):
        K5.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError):
        K5.flash_attention(q, torch.zeros(1, 3, 8, 64), torch.zeros(1, 3, 8, 64))  # Hq % Hkv
    with pytest.raises(ValueError):
        K5.flash_attention(q, k, torch.zeros(1, 2, 9, 64))  # k and v differ
    with pytest.raises(ValueError):
        K5.flash_attention(q, torch.zeros(1, 2, 8, 32), torch.zeros(1, 2, 8, 32))  # D differs
    with pytest.raises(ValueError):
        K5.flash_attention(q, k[:, :, :0], k[:, :, :0])  # no keys
    with pytest.raises(ValueError):
        K5.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))


# ---------------------------------------------------------------- on the card
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,hq,hkv,sq,sk,causal", [
    (1, 2, 2, 128, 128, True), (2, 4, 2, 256, 256, True), (1, 8, 1, 128, 256, False),
    (1, 4, 2, 64, 128, True), (1, 4, 1, 96, 40, True), (2, 6, 3, 72, 200, False),
    (2, 32, 8, 1, 4161, False), (3, 8, 1, 1, 5, True), (1, 32, 8, 1000, 1000, True),
])
def test_flash_attention_cuda_kernel_matches_plain(b, hq, hkv, sq, sk, causal, dtype):
    _need_cuda()
    q, k, v = _arrays(b, hq, hkv, sq, sk + 3, 64, sq + sk)
    tdt = DTYPES[dtype]
    tq = torch.from_numpy(q).to("cuda", tdt)
    kc, vc = (torch.from_numpy(x).to("cuda", tdt) for x in (k, v))
    for tk, tv in ((kc[:, :, :sk].contiguous(), vc[:, :, :sk].contiguous()), (kc[:, :, :sk], vc[:, :, :sk])):
        n = K5.LAUNCHES
        got = K5.flash_attention(tq, tk, tv, causal=causal)
        torch.cuda.synchronize()
        assert K5.LAUNCHES == n + 1
        want = K5.flash_attention_plain(tq, tk, tv, causal=causal)
        torch.testing.assert_close(got.float(), want.float(), atol=TOL[tdt], rtol=TOL[tdt])
        if tdt == torch.bfloat16:
            scale = want.float().abs().amax(dim=-1, keepdim=True)
            assert float(((got.float() - want.float()).abs() / scale).max()) <= BF16_ROW_REL_TOL
