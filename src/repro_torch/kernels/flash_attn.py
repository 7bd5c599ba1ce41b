"""Online-softmax attention with GQA (K5).

The port of ``repro/kernels/flash_attn.py::flash_attention``: q ``[B, Hq,
Sq, D]``, k/v ``[B, Hkv, Sk, D]``, query head ``h`` reading KV head
``h // (Hq // Hkv)``, scores ``D**-0.5 q.k`` and sums in float32, the causal
mask ``row >= col`` aligned top-left as the TPU kernel's
(``kernels/ref.py::attention_ref`` aligns it bottom-right; the two agree
only when Sq == Sk), masked scores at ``-1e30``, the denominator floored at
``1e-30``, the output cast to ``q.dtype``.

The CUDA kernel is ``csrc/flash_attn.cu``, built for D in
:data:`HEAD_DIMS`; its note gives the bound and the design (a bf16
tensor-core prefill, a float32 CUDA-core prefill, and a decode form split
over the keys whose partials a second kernel merges, all reading strided
views).  :func:`flash_attention` launches it for CUDA tensors and runs
:func:`flash_attention_plain`, the plain PyTorch version, for CPU tensors.

The reference's kernel has no backward pass.  For training,
:class:`FlashAttention` is a ``torch.autograd.Function`` whose forward is
that same dispatch (K5 on the card) and whose backward is
:func:`flash_attention_backward_plain`, plain PyTorch that recomputes the
softmax from q and k.  :func:`flash_attention` goes through it whenever
grad mode is on and an operand requires grad, so the kernel's output,
written through ``ctypes`` into a fresh tensor, never reaches autograd
detached.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

SOURCE = "flash_attn.cu"
NEG_INF = -1e30
HEAD_DIMS = frozenset({16, 64, 128})  # the head dims the CUDA kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# decode: CTAs to aim for across the key chunks (8 x the H100's 132 SMs),
# and the chunk granule (the bf16 key tile)
_DECODE_CTAS = 8 * 132
_DECODE_GRANULE = 64
_DECODE_HEADS = 8  # query heads a decode CTA takes (the kernel's Decode::GH)
# the plain version's score block, in float32 elements (1 GiB)
_PLAIN_BLOCK = 1 << 28

# kernel launches since the last reset
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32 for float32 and bfloat16 operands; float64 stays float64 (the
    CPU's ``gradcheck`` of :class:`FlashAttention`)."""
    return torch.promote_types(dtype, torch.float32)


def _row_blocks(b: int, hq: int, sq: int, sk: int):
    """Blocks ``(r0, r1)`` of query rows whose scores ``[B, Hq, r1 - r0,
    Sk]`` stay within :data:`_PLAIN_BLOCK` elements."""
    rows = max(1, _PLAIN_BLOCK // max(1, b * hq * sk))
    return [(r0, min(sq, r0 + rows)) for r0 in range(0, sq, rows)]


def _exp_scores(qb: Tensor, kb: Tensor, r0: int, r1: int, causal: bool) -> tuple[Tensor, Tensor]:
    """``(p, l)``: the softmax numerators ``exp(s - max s)`` of the scaled
    query block ``qb [B, Hkv, G * (r1 - r0), D]`` (query heads grouped onto
    their KV head) over ``kb``, with K5's top-left causal mask ``row >=
    col`` and masked scores at ``-1e30``, and their row sums floored at
    ``1e-30``."""
    s = qb @ kb.transpose(-1, -2)
    if causal:
        group = qb.shape[2] // (r1 - r0)
        rows = torch.arange(r0, r1, device=qb.device).repeat(group)
        cols = torch.arange(kb.shape[2], device=qb.device)
        s = torch.where(rows[:, None] >= cols[None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p, p.sum(dim=-1, keepdim=True).clamp(min=1e-30)


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                          scale: float | None = None) -> Tensor:
    """Plain version: a direct softmax per row in float32 with K5's mask,
    GQA map, ``-1e30`` masking and ``1e-30`` floor, over blocks of query
    rows so the score matrix stays under 1 GiB.  q is multiplied by
    ``scale`` (default ``D**-0.5``) in float32, as the kernel does."""
    b, hq, sq, d = q.shape
    scale = 1.0 / d**0.5 if scale is None else scale
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    acc = _compute_dtype(q.dtype)
    kf, vf = k.to(acc), v.to(acc)
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    for r0, r1 in _row_blocks(b, hq, sq, sk):
        qb = (q[:, :, r0:r1].to(acc) * scale).reshape(b, hkv, group * (r1 - r0), d)
        p, l = _exp_scores(qb, kf, r0, r1, causal)
        o = (p @ vf) / l
        out[:, :, r0:r1] = o.reshape(b, hq, r1 - r0, d).to(q.dtype)
    return out


def flash_attention_backward_plain(q: Tensor, k: Tensor, v: Tensor, out: Tensor, dout: Tensor, *,
                                   causal: bool = True, scale: float | None = None):
    """Gradients ``(dq, dk, dv)`` of :func:`flash_attention` at ``(q, k, v)``
    given its output ``out`` and the output's gradient ``dout``; plain
    PyTorch in float32 over the plain version's blocks of query rows.

    Each block recomputes P from q and k (:func:`_exp_scores`: K5's mask
    and floors), then ``dV += Pᵀ dO``, ``dP = dO Vᵀ``, ``dS = P ∘ (dP −
    rowsum(dO ∘ O))``, ``dQ = scale · dS K`` and ``dK += scale · dSᵀ Q``;
    with the query heads of a KV head grouped into one matrix, dK and dV
    sum over the group (GQA).  A causal block reads only the keys its last
    row sees: the rest have P = 0 exactly."""
    b, hq, sq, d = q.shape
    scale = 1.0 / d**0.5 if scale is None else scale
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    acc = _compute_dtype(q.dtype)
    kf, vf = k.to(acc), v.to(acc)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.zeros(k.shape, dtype=acc, device=q.device)
    dv = torch.zeros(v.shape, dtype=acc, device=q.device)
    for r0, r1 in _row_blocks(b, hq, sq, sk):
        n = group * (r1 - r0)
        c1 = min(sk, r1) if causal else sk
        kb, vb = kf[:, :, :c1], vf[:, :, :c1]
        qb = (q[:, :, r0:r1].to(acc) * scale).reshape(b, hkv, n, d)
        dob = dout[:, :, r0:r1].to(acc).reshape(b, hkv, n, d)
        ob = out[:, :, r0:r1].to(acc).reshape(b, hkv, n, d)
        p, l = _exp_scores(qb, kb, r0, r1, causal)
        p.div_(l)  # P
        dv[:, :, :c1] += p.transpose(-1, -2) @ dob
        ds = dob @ vb.transpose(-1, -2)
        ds.sub_((dob * ob).sum(dim=-1, keepdim=True)).mul_(p)
        del p
        dq[:, :, r0:r1] = ((ds @ kb) * scale).reshape(b, hq, r1 - r0, d).to(q.dtype)
        dk[:, :, :c1] += ds.transpose(-1, -2) @ qb  # qb holds the scale already
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """K5 with a backward pass: the forward is :func:`flash_attention`'s
    dispatch (the kernel for CUDA tensors, the plain version for CPU ones),
    the backward :func:`flash_attention_backward_plain` on the saved q, k,
    v and output.  ``apply(q, k, v, causal, scale)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale):
        out = _forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward_plain(q, k, v, out, dout, causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    scale: float | None = None) -> Tensor:
    """Attention of ``q [B, Hq, Sq, D]`` over ``k, v [B, Hkv, Sk, D]``.

    The scores are scaled by ``scale`` in float32 (default ``D**-0.5``); a
    caller that scales q in its own dtype first, as the reference model
    does, passes ``scale=1.0``.

    float32 or bfloat16 (one dtype for all three), ``Hq % Hkv == 0``, any
    Sq, Sk >= 1.  q, k and v may be strided views (a cache prefix); one the
    kernel's 16-byte loads cannot read (:func:`aligned_for_kernel`) is
    copied first.  CUDA tensors launch the kernel (built on first use; D in
    :data:`HEAD_DIMS`), a decode call (Sq = 1) with float32 scratch for its
    per-chunk partials; CPU tensors take the plain version.  Anything else
    raises.  Under grad mode with an operand that requires grad the call
    goes through :class:`FlashAttention`, whose backward is plain PyTorch.
    """
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"need q [B,Hq,Sq,D] and k, v of one shape [B,Hkv,Sk,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: batch and D must match "
                         f"and Hq must be a multiple of Hkv")
    if min(b, sq, sk) < 1:
        raise ValueError(f"empty attention: B={b}, Sq={sq}, Sk={sk}")
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {dev}")
    if dev.type == "cuda":
        if d not in HEAD_DIMS:
            raise ValueError(f"the CUDA kernel is built for D in {sorted(HEAD_DIMS)}, got {d}")
        if b > 65535 or hkv > 65535 or sq > 64 * 65535:
            raise ValueError(f"B, Hkv and Sq / 64 must be at most 65535 (grid limits), "
                             f"got {b}, {hkv}, {sq}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, scale)
    return _forward(q, k, v, causal, scale)


def _forward(q: Tensor, k: Tensor, v: Tensor, causal: bool, scale: float | None) -> Tensor:
    """The plain version for CPU tensors, the kernel for CUDA ones (operands
    checked by :func:`flash_attention`); no autograd graph either way."""
    if q.device.type == "cpu":
        with torch.no_grad():
            return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    return _launch(q, k, v, causal, scale)


def _launch(q: Tensor, k: Tensor, v: Tensor, causal: bool, scale: float | None) -> Tensor:
    """K5 on the card into a fresh output, counted in :data:`LAUNCHES`."""
    dev = q.device
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=dev)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    chunk = nchunks = 0
    part = None
    if sq == 1:
        chunk, nchunks = decode_split(b, hq, hkv, 1 if causal else sk)
        part = torch.empty(b * hq * nchunks * (d + 2), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
            b, hq, hkv, sq, sk, int(causal), _DTYPES[q.dtype], d,
            1.0 / d**0.5 if scale is None else scale,
            None if part is None else part.data_ptr(), chunk, nchunks, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def decode_split(b: int, hq: int, hkv: int, n: int) -> tuple[int, int]:
    """Key chunks of a decode call over ``n`` keys: (chunk, count), the chunk
    a multiple of 64 keys and the count enough that the (chunk, head group,
    KV head, batch) grid has about :data:`_DECODE_CTAS` CTAs."""
    per_chunk = b * hkv * -(-(hq // hkv) // _DECODE_HEADS)
    want = max(1, -(-_DECODE_CTAS // per_chunk))
    chunk = -(-n // want)
    chunk = -(-chunk // _DECODE_GRANULE) * _DECODE_GRANULE
    return chunk, -(-n // chunk)


def aligned_for_kernel(t: Tensor) -> bool:
    """Whether the kernel's 16-byte loads can read ``t`` as it is: a unit
    D stride, a 16-byte-aligned base, and every other stride of an axis
    longer than 1 a whole number of 16 bytes."""
    per16 = 16 // t.element_size()
    st = t.stride()
    if st[3] != 1 or t.data_ptr() % 16:
        return False
    b, h, s, _ = t.shape  # written out: a decode step checks 3 operands a layer
    return ((st[0] % per16 == 0 or b == 1) and (st[1] % per16 == 0 or h == 1)
            and (st[2] % per16 == 0 or s == 1))


def _aligned(t: Tensor) -> Tensor:
    """``t``, or a contiguous copy where the kernel cannot read it as it is."""
    if aligned_for_kernel(t):
        return t
    return t.contiguous() if not t.is_contiguous() else t.clone()


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.flash_attn_launch
    if fn.argtypes is None:  # typed once a process: a decode step calls this per layer
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib
