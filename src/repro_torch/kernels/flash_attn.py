"""Online-softmax attention with GQA (K5).

The port of ``repro/kernels/flash_attn.py::flash_attention``: q ``[B, Hq,
Sq, D]``, k/v ``[B, Hkv, Sk, D]``, query head ``h`` reading KV head
``h // (Hq // Hkv)``, ``q`` scaled by ``D**-0.5`` in float32, scores and sums
in float32, the causal mask ``row >= col`` aligned top-left as the TPU
kernel's (``kernels/ref.py::attention_ref`` aligns it bottom-right; the two
agree only when Sq == Sk), masked scores at ``-1e30``, the denominator
floored at ``1e-30``, the output cast to ``q.dtype``.

The CUDA kernel is ``csrc/flash_attn.cu``; its note gives the bound and the
design (a prefill form and a one-row decode form, both reading strided
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
HEAD_DIM = 64  # the only head dim the CUDA kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the plain version's score block, in float32 elements (1 GiB)
_PLAIN_BLOCK = 1 << 28

# kernel launches since the last reset
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True) -> Tensor:
    """Plain version: a direct softmax per row in float32 with K5's mask,
    GQA map, ``-1e30`` masking and ``1e-30`` floor, over blocks of query
    rows so the score matrix stays under 1 GiB."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    kf, vf = k.float(), v.float()
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    rows_per_block = max(1, _PLAIN_BLOCK // max(1, b * hq * sk))
    cols = torch.arange(sk, device=q.device)
    for r0 in range(0, sq, rows_per_block):
        r1 = min(sq, r0 + rows_per_block)
        # query heads grouped onto their KV head: [B, Hkv, G * rows, D]
        qb = (q[:, :, r0:r1].float() * (1.0 / d**0.5)).reshape(b, hkv, group * (r1 - r0), d)
        s = qb @ kf.transpose(-1, -2)
        if causal:
            rows = torch.arange(r0, r1, device=q.device).repeat(group)
            s = torch.where(rows[:, None] >= cols[None, :], s, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        o = (p @ vf) / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
        out[:, :, r0:r1] = o.reshape(b, hq, r1 - r0, d).to(q.dtype)
    return out


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True) -> Tensor:
    """Attention of ``q [B, Hq, Sq, D]`` over ``k, v [B, Hkv, Sk, D]``.

    float32 or bfloat16 (one dtype for all three), ``Hq % Hkv == 0``, any
    Sq, Sk >= 1.  k and v may be strided views (a cache prefix); the D axis
    of each must be unit-stride or the tensor is copied.  CUDA tensors
    launch the kernel (built on first use; D must be 64); CPU tensors take
    the plain version.  Anything else raises.
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
        return flash_attention_plain(q, k, v, causal=causal)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {dev}")
    if d != HEAD_DIM:
        raise ValueError(f"the CUDA kernel is built for D = {HEAD_DIM}, got {d}")
    if b > 65535 or hkv > 65535 or hq > 65535:
        raise ValueError(f"B, Hq and Hkv must be at most 65535 (grid limits), got {b}, {hq}, {hkv}")
    q, k, v = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=dev)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
            b, hq, hkv, sq, sk, int(causal), _DTYPES[q.dtype], 1.0 / d**0.5, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.flash_attn_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib
