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
    kf, vf = k.float(), v.float()
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    rows_per_block = max(1, _PLAIN_BLOCK // max(1, b * hq * sk))
    cols = torch.arange(sk, device=q.device)
    for r0 in range(0, sq, rows_per_block):
        r1 = min(sq, r0 + rows_per_block)
        # query heads grouped onto their KV head: [B, Hkv, G * rows, D]
        qb = (q[:, :, r0:r1].float() * scale).reshape(b, hkv, group * (r1 - r0), d)
        s = qb @ kf.transpose(-1, -2)
        if causal:
            rows = torch.arange(r0, r1, device=q.device).repeat(group)
            s = torch.where(rows[:, None] >= cols[None, :], s, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        o = (p @ vf) / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
        out[:, :, r0:r1] = o.reshape(b, hq, r1 - r0, d).to(q.dtype)
    return out


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
    raises.
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
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {dev}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel is built for D in {sorted(HEAD_DIMS)}, got {d}")
    if b > 65535 or hkv > 65535 or sq > 64 * 65535:
        raise ValueError(f"B, Hkv and Sq / 64 must be at most 65535 (grid limits), "
                         f"got {b}, {hkv}, {sq}")
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
