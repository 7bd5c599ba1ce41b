"""Multi-probe Bloom-filter query over packed 32-bit words (Prob-Drop, K3).

The port of ``repro/kernels/bloom.py::bloom_query``: k double-hashed probes
per (vertex, iteration) key into one packed filter row per query, combined
by AND.  The packed layout (M/32 words a row) is the size the accountant
charges; :func:`pack_bits` packs the engine's ``bool [Q, M]`` filter into it.
Words are uint32 bit patterns held in int32 (bit ``b`` of word ``w`` is
filter bit ``32 w + b``).

The CUDA kernel is ``csrc/bloom.cu``; its hash is ``csrc/bloom_hash.cuh``,
which K2's prob stage probes with too.  It takes a group of keys a thread
and overlaps their probes, streams the keys as 16-byte vectors, and reduces
a probe modulo M without a division: a mask for a power-of-two M, else the
exact reciprocal :func:`fastmod_constant` computes for the call.  No engine
path calls this kernel, as in the reference: the fused sweep probes the
bool filter inside K2.

:func:`bloom_query` launches the kernel for CUDA tensors and runs
:func:`bloom_query_ref`, the plain PyTorch version, for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.bloom import M32, hash_key
from repro_torch.kernels import _build

Tensor = torch.Tensor

SOURCE = "bloom.cu"

# kernel launches since the last reset
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def pack_bits(bits: Tensor) -> Tensor:
    """bool [..., M] → int32 [..., M/32] (uint32 bit patterns; M must be a
    multiple of 32)."""
    *lead, m = bits.shape
    if m % 32:
        raise ValueError(f"pack_bits needs a multiple of 32 bits, got {m}")
    b = bits.reshape(*lead, m // 32, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return (b << shifts).sum(dim=-1).to(torch.int32)


def fastmod_constant(num_bits: int) -> int:
    """The kernel's reciprocal of ``num_bits`` (Lemire, Kaser and Kurz, 2019):
    ``c = floor((2**64 - 1) / num_bits) + 1``, with which ``x % num_bits ==
    (((c * x) % 2**64) * num_bits) >> 64`` for every 32-bit ``x``."""
    return (2**64 - 1) // num_bits + 1


def bloom_query_ref(words: Tensor, v: Tensor, i: Tensor, salt: Tensor, *, num_hashes: int) -> Tensor:
    """Plain version: the same double hashing over the unpacked words.  The
    counterpart of ``repro/kernels/ref.py::bloom_query_ref``."""
    num_bits = words.shape[-1] * 32
    h1, h2 = hash_key(v, i, salt[:, None])
    j = torch.arange(num_hashes, dtype=torch.int64, device=words.device)
    probes = ((h1[..., None] + ((j * h2[..., None]) & M32)) & M32) % num_bits  # [Q, N, k]
    q, n = v.shape
    word = torch.gather(words.to(torch.int64) & M32, -1, (probes >> 5).reshape(q, -1))
    bit = (word.reshape(probes.shape) >> (probes & 31)) & 1
    return (bit == 1).all(dim=-1)


def bloom_query(words: Tensor, v: Tensor, i: Tensor, salt: Tensor, *, num_hashes: int = 4) -> Tensor:
    """``out[q, n]``: may key ``(v[q, n], i[q, n])`` be in filter row ``q``
    (salted by ``salt[q]``)?  bool [Q, N], no false negatives.

    CUDA tensors launch the kernel (built on first use); CPU tensors take
    the plain version.  Anything else raises.
    """
    if words.dtype != torch.int32 or v.dtype != torch.int32 or i.dtype != torch.int32:
        raise TypeError(f"words/v/i must be int32, got {words.dtype}/{v.dtype}/{i.dtype}")
    if salt.dtype != torch.int32:
        raise TypeError(f"salt must be int32, got {salt.dtype}")
    if words.ndim != 2 or v.ndim != 2 or tuple(i.shape) != tuple(v.shape):
        raise ValueError(f"need words [Q, W] and v/i [Q, N]; got {tuple(words.shape)}, "
                         f"{tuple(v.shape)}, {tuple(i.shape)}")
    q, n = v.shape
    if words.shape[0] != q or tuple(salt.shape) != (q,):
        raise ValueError(f"words {tuple(words.shape)} / salt {tuple(salt.shape)} do not match Q={q}")
    if not 0 < words.shape[1] * 32 < 2**32 or num_hashes < 1:
        raise ValueError("bloom_query takes 1 .. 2**32-1 bits a row and num_hashes >= 1")
    devices = {t.device for t in (words, v, i, salt)}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return bloom_query_ref(words, v, i, salt, num_hashes=num_hashes)
    if dev.type != "cuda":
        raise ValueError(f"bloom_query runs on cuda or cpu tensors, not {dev}")
    if q >= 65536:
        raise ValueError("bloom_query takes fewer than 65536 filter rows")
    words, v, i, salt = (t.contiguous() for t in (words, v, i, salt))
    out = torch.empty((q, n), dtype=torch.bool, device=dev)
    if out.numel() == 0:  # no key: nothing to launch
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bloom_query_launch(
            words.data_ptr(), v.data_ptr(), i.data_ptr(), salt.data_ptr(), out.data_ptr(),
            q, n, words.shape[1], int(num_hashes), fastmod_constant(words.shape[1] * 32), stream,
        )
    if err != 0:
        raise RuntimeError(f"bloom_query launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.bloom_query_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                                           ctypes.c_int, ctypes.c_uint64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
