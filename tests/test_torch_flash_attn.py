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
stays below the outputs as they shrink with Sk, at each head dim the
kernel is built for (16, 64, 128).  On the CPU a plain-torch emulation of
the kernel's bf16 rounding points (scores in float32 from bf16 q.k, the
scale applied to the scores, P rounded to bf16 before P.V, sums in
float32, the decode form's per-chunk partials merged) is held against the
reference at that same row-relative limit, so the design's bf16 P is shown
to fit it before the card runs.  The reference is imported inside the
tests that use it, so ``pytest -m gpu`` runs this file where JAX is not
installed.
"""

import math

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


# the pre-repair gap at D = 128 (K5 scaling q in float32 while the model
# scaled it in bf16), measured on the CPU: the largest absolute difference
# and the largest of a row's largest difference over its largest |value|
Q_SCALE_GAP_D128 = {"prefill": (2.0**-6, 2.0**-7), "decode": (2.0**-9, 2.0**-7)}


@pytest.mark.parametrize("form", ["prefill", "decode"])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_model_kernel_path_scales_q_as_chunked_attention(d, form):
    """At qwen2-moe's attention shape (16 query and KV heads, bf16) the
    transformer's card-path form of K5 -- q scaled by ``D**-0.5`` in q's
    dtype, then ``flash_attention_plain`` with ``scale=1.0`` -- against the
    model's ``chunked_attention``, which scales q the same way, as the
    reference does.  Over one key block the two sum the same float32
    products in the same order, so they agree bit for bit at every head
    dim.  At D = 128, where 128**-0.5 is no power of two, K5's default
    float32 scaling still differs by the gap the repair removed (at most
    :data:`Q_SCALE_GAP_D128`), so the check can tell the two apart."""
    from repro_torch.models import common as cm

    sq, causal = (256, True) if form == "prefill" else (1, False)
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
               for shape in ((2, 16, sq, d), (2, 16, 256, d), (2, 16, 256, d)))
    model = cm.chunked_attention(q, k, v, causal=causal)
    kernel_path = K5.flash_attention_plain(q * d**-0.5, k, v, causal=causal, scale=1.0)
    assert torch.equal(model, kernel_path)
    assert torch.equal(K5.flash_attention(q * d**-0.5, k, v, causal=causal, scale=1.0), kernel_path)
    f32_scaled = K5.flash_attention_plain(q, k, v, causal=causal)
    if d != 128:
        assert torch.equal(model, f32_scaled)
        return
    diff = (model.float() - f32_scaled.float()).abs()
    row_rel = float((diff / f32_scaled.float().abs().amax(dim=-1, keepdim=True)).max())
    max_abs, max_row_rel = Q_SCALE_GAP_D128[form]
    assert 0 < float(diff.max()) <= max_abs and row_rel <= max_row_rel


# (b, hq, hkv, sq, sk): GQA and MQA, sized for the reference's blocks
GROUPS = {"gqa": (1, 4, 2, 192, 192), "mqa": (1, 4, 1, 32, 96)}


@pytest.mark.parametrize("group", list(GROUPS))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 128])
def test_plain_version_matches_reference_at_head_dims(d, causal, group):
    """The plain version against the Pallas kernel in float32 at the other
    head dims the kernel is built for: 16 (the smoke configs) and 128
    (qwen2-moe, qwen2-72b, arctic), whose scale 128**-0.5 is no power of
    two.  (bfloat16 at these dims: the emulation test below.)"""
    b, hq, hkv, sq, sk = GROUPS[group]
    q, k, v = _arrays(b, hq, hkv, sq, sk, d, d + sq)
    got = K5.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    want = _reference(q, k, v, causal, "float32", sq, sk)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL[torch.float32], rtol=TOL[torch.float32])


LOG2E = 1.4426950408889634
BK = 64  # the kernel's key tile


def _emulated_kernel_bf16(q, k, v, causal, chunk=None):
    """The CUDA kernel's arithmetic on bf16 q, k, v in plain torch.  Prefill
    (Sq > 1, the tensor-core form): S = q.k in float32 from the bf16
    values, scaled there by D**-0.5 log2(e), online over 64-key tiles with
    exp2, P rounded to bf16 before P.V, l summed from the float32 P.
    Decode (Sq = 1, the CUDA-core form): q scaled in float32, P in float32,
    each ``chunk`` of keys reduced to a partial (m, l, acc) and the partials
    merged in chunk order.  Output rounded once to bf16."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g * sq, d)
    kf, vf = k.float(), v.float()
    rows = torch.arange(sq).repeat(g)[:, None]

    def reduce(k0, k1, qs, scale, exp, p_round):
        m = torch.full((b, hkv, g * sq, 1), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hkv, g * sq, d))
        for t0 in range(k0, k1, BK):
            t1 = min(k1, t0 + BK)
            s = (qs @ kf[:, :, t0:t1].transpose(-1, -2)) * scale
            if causal:
                s = torch.where(rows >= torch.arange(t0, t1)[None, :], s, -1e30)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = exp(s - m_new)
            alpha = exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p_round(p) @ vf[:, :, t0:t1]
            m = m_new
        return m, l, acc

    if sq > 1:
        _, l, acc = reduce(0, sk, qf, d**-0.5 * LOG2E, torch.exp2, lambda p: p.bfloat16().float())
    else:
        n = 1 if causal else sk
        parts = [reduce(c0, min(n, c0 + chunk), qf * d**-0.5, 1.0, torch.exp, lambda p: p)
                 for c0 in range(0, n, chunk)]
        m = torch.stack([p[0] for p in parts]).amax(0)
        l, acc = 0.0, 0.0
        for mc, lc, ac in parts:
            f = torch.exp(mc - m)
            l, acc = l + lc * f, acc + ac * f
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, hq, sq, d).bfloat16()


@pytest.mark.parametrize("form,causal", [("prefill", True), ("prefill", False), ("decode", False)])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_kernel_rounding_points_fit_the_bf16_limit(d, form, causal):
    """The emulated kernel (bf16 P in the prefill, split-K partials in the
    decode) on bf16 inputs against the reference kernel on the same values
    in float32 (its bf16 output before the last rounding), within 2^-6 of
    each output row's largest value: the limit ``chip_smoke.py`` holds the
    card to.  (A causal decode row sees one key: nothing to split.)"""
    b, hq, hkv, sq, sk = GROUPS["gqa"] if form == "prefill" else (2, 8, 2, 1, 320)
    q, k, v = _arrays(b, hq, hkv, sq, sk, d, d + sq)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = _emulated_kernel_bf16(tq, tk, tv, causal, chunk=64).float()
    want = torch.from_numpy(_reference(*(t.float().numpy() for t in (tq, tk, tv)), causal, "float32", sq, sk))
    row_max = want.abs().amax(dim=-1, keepdim=True)
    assert float(((got - want).abs() / row_max).max()) <= BF16_ROW_REL_TOL


class _CudaShaped(torch.Tensor):
    """A tensor that reports a CUDA device, a shape and a dtype, and holds no
    data: any operation on it fails."""

    @staticmethod
    def __new__(cls, *shape, dtype=torch.bfloat16):
        return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=dtype, device="cuda")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise AssertionError(f"{func} ran on a tensor with no data")


@pytest.mark.parametrize("d", [8, 32, 96, 256])
def test_cuda_path_refuses_head_dims_it_is_not_built_for(monkeypatch, d):
    """On a CUDA tensor a head dim outside {16, 64, 128} raises before any
    launch (no fall-back to the plain version).  The card is stubbed:
    ``torch.cuda.is_available`` answers True and the operands only report a
    CUDA device, so this runs without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(K5, "_lib", lambda: pytest.fail("the wrapper reached the kernel"))
    assert d not in K5.HEAD_DIMS
    q, k = _CudaShaped(1, 4, 8, d), _CudaShaped(1, 2, 8, d)
    with pytest.raises(ValueError, match="built for D in"):
        K5.flash_attention(q, k, k)


def _cache_view(dtype, **kw):
    """A [2, 4, 10, 64] view into a bigger buffer: ``offset`` elements in,
    sequence stride ``pitch``."""
    offset, pitch = kw.get("offset", 0), kw.get("pitch", 64)
    flat = torch.zeros(offset + 2 * 4 * 10 * pitch, dtype=dtype)
    return flat[offset:].view(2, 4, 10, pitch)[..., :64]


@pytest.mark.parametrize("case,copied", [
    ("contiguous", False), ("cache_prefix", False), ("odd_sequence_pitch", True),
    ("misaligned_base", True), ("strided_head_dim", True), ("size_one_axis", False),
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_wrapper_copies_only_what_16_byte_loads_cannot_read(case, copied, dtype):
    """The kernel reads q, k, v with 16-byte loads: a 16-byte-aligned base and
    batch, head and sequence strides in whole 16 bytes (an axis of length 1
    has no stride to honour).  The wrapper passes such a view as it is and
    copies any other operand contiguously, never falling back."""
    tdt = DTYPES[dtype]
    per16 = 16 // torch.empty(0, dtype=tdt).element_size()
    t = {
        "contiguous": lambda: torch.zeros(2, 4, 10, 64, dtype=tdt),
        "cache_prefix": lambda: torch.zeros(2, 4, 30, 64, dtype=tdt)[:, :, :10],
        "odd_sequence_pitch": lambda: _cache_view(tdt, pitch=64 + per16 // 2 + 1),
        "misaligned_base": lambda: _cache_view(tdt, offset=1),
        "strided_head_dim": lambda: torch.zeros(2, 4, 64, 10, dtype=tdt).transpose(2, 3),
        "size_one_axis": lambda: torch.zeros(512, dtype=tdt).as_strided((1, 4, 1, 64), (3, 128, 5, 1)),
    }[case]()
    assert K5.aligned_for_kernel(t) is not copied
    got = K5._aligned(t)
    assert (got is not t) is copied
    assert torch.equal(got, t) and K5.aligned_for_kernel(got)


@pytest.mark.parametrize("b,hq,hkv,n,chunks", [
    (8, 32, 8, 4097, 17), (32, 32, 8, 32753, 5), (32, 16, 16, 32753, 3), (1, 64, 8, 4097, 65),
    (3, 8, 1, 1, 1),
])
def test_decode_split_fills_the_card(b, hq, hkv, n, chunks):
    """The decode form's key chunks: multiples of 64 keys, covering the
    prefix once, enough of them for about 8 x 132 CTAs."""
    chunk, count = K5.decode_split(b, hq, hkv, n)
    assert chunk % 64 == 0 and count == math.ceil(n / chunk) == chunks
    ctas = count * b * hkv * math.ceil(hq // hkv / 8)
    assert ctas >= 2 * 132 or count * 64 >= n


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
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,causal", [
    (1, 2, 2, 128, 128, True), (2, 4, 2, 256, 256, True), (1, 8, 1, 128, 256, False),
    (1, 4, 2, 64, 128, True), (1, 4, 1, 96, 40, True), (2, 6, 3, 72, 200, False),
    (2, 32, 8, 1, 4161, False), (3, 8, 1, 1, 5, True), (1, 32, 8, 1000, 1000, True),
    (1, 24, 2, 1, 700, False),
])
def test_flash_attention_cuda_kernel_matches_plain(b, hq, hkv, sq, sk, causal, d, dtype):
    _need_cuda()
    q, k, v = _arrays(b, hq, hkv, sq, sk + 3, d, sq + sk)
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("sq", [1, 77])
def test_flash_attention_cuda_copies_a_misaligned_view(sq, d, dtype):
    """k and v one element into their buffer (no 16-byte-aligned base) and q
    with an odd sequence pitch: the wrapper copies them and the kernel
    matches the plain version; a second call is bit-equal to the first
    (the decode's split-K merge runs in a fixed order)."""
    _need_cuda()
    tdt = DTYPES[dtype]
    rng = np.random.default_rng(d + sq)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to("cuda", tdt)  # noqa: E731
    q = t(2, 8, sq, d + 1)[..., :d]
    k = t(2 * 2 * 300 * d + 1)[1:].view(2, 2, 300, d)
    v = t(2 * 2 * 300 * d + 1)[1:].view(2, 2, 300, d)
    assert not any(K5.aligned_for_kernel(x) for x in (q, k, v))
    got = K5.flash_attention(q, k, v, causal=sq > 1)
    again = K5.flash_attention(q, k, v, causal=sq > 1)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = K5.flash_attention_plain(q, k, v, causal=sq > 1)
    err = (got.float() - want.float()).abs()
    if tdt == torch.float32:
        assert float(err.max()) <= TOL[tdt]
    else:
        assert float((err / want.float().abs().amax(dim=-1, keepdim=True)).max()) <= BF16_ROW_REL_TOL

