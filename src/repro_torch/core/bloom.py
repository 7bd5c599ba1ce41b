"""Bloom filter for Prob-Drop (paper §5.1.2), in PyTorch.

The port of ``repro/core/bloom.py``: a flat bit array per query with k probes
by double hashing (Kirsch–Mitzenmacher), ``probe_j = h1 + j·h2 mod M``, from
murmur3-finalizer mixes of the (vertex, iteration) key.  The state is a
``bool[..., M]`` tensor; the *accounted* memory is the packed size, M/8 bytes
per filter, which is the layout :mod:`repro_torch.kernels.bloom` probes.

The hashes are uint32 arithmetic.  torch's uint32 lacks ``>>`` on the CPU, so
every value is held in int64 and cut back to 32 bits (``& 0xFFFFFFFF``) after
each ``*``, ``+`` and ``<<``.  A product of two 32-bit values may pass 2**63
and wrap in int64; its low 32 bits are still the uint32 product.

Guarantee: no false negatives (a dropped VT pair always probes positive), so
Prob-Drop can only cause spurious recomputation — never a wrong answer.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor

M32 = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_C3 = 0x27D4EB2F


def u32(x: Tensor | int) -> Tensor:
    """``x`` as uint32 values held in int64 (negative int32 wraps, as a
    uint32 cast does)."""
    return torch.as_tensor(x).to(torch.int64) & M32


def _mix(x: Tensor) -> Tensor:
    """murmur3 fmix32 on uint32 values held in int64."""
    x = u32(x)
    x = x ^ (x >> 16)
    x = (x * _C1) & M32
    x = x ^ (x >> 13)
    x = (x * _C2) & M32
    return x ^ (x >> 16)


def hash_key(v, i, salt=0) -> tuple[Tensor, Tensor]:
    """(h1, h2) for double hashing of the (vertex, iteration) key; ``salt``
    decorrelates the per-query filters sharing one array."""
    v, i, s = u32(v), u32(i), u32(salt)
    h1 = _mix(((v * _C3) & M32) ^ _mix((i + s) & M32))
    h2 = _mix(((i * _C1) & M32) ^ _mix(v ^ ((s * _C2) & M32))) | 1  # odd → full cycle
    return h1, h2


class BloomFilter(NamedTuple):
    """bits: bool [..., M]; ``num_hashes`` is static."""

    bits: Tensor
    num_hashes: int

    @property
    def num_bits(self) -> int:
        return int(self.bits.shape[-1])

    @property
    def nbytes_accounted(self) -> int:
        """Packed size — what a production filter occupies (M/8 per filter)."""
        lead = 1
        for n in self.bits.shape[:-1]:
            lead *= int(n)
        return lead * ((self.num_bits + 7) // 8)


def make(shape: tuple[int, ...], num_bits: int, num_hashes: int = 4, device=None) -> BloomFilter:
    return BloomFilter(torch.zeros((*shape, num_bits), dtype=torch.bool, device=device), num_hashes)


def _probes(flt: BloomFilter, v, i, salt) -> Tensor:
    """int64 [..., k] bit indices of the keys' probes."""
    h1, h2 = hash_key(v, i, salt)
    j = torch.arange(flt.num_hashes, dtype=torch.int64, device=h1.device)
    return ((h1[..., None] + ((j * h2[..., None]) & M32)) & M32) % flt.num_bits


def insert(flt: BloomFilter, v, i, mask: Tensor, salt=0) -> BloomFilter:
    """Set the bits of keys (v, i) where ``mask``.

    ``v``/``i``/``salt`` broadcast against ``mask``, whose leading dims match
    the filter's; inserts scatter along the last axis.  Probes are computed
    only for the masked keys (the reference scatters every key, the masked-off
    ones to a sacrificial bit); the OR is idempotent, so the bits agree.
    """
    out = flt._replace(bits=flt.bits.clone())
    insert_(out, v, i, mask, salt)
    return out


def insert_(flt: BloomFilter, v, i, mask: Tensor, salt=0) -> None:
    """:func:`insert` into ``flt.bits`` in place."""
    where = mask.nonzero(as_tuple=True)
    pick = lambda x: torch.as_tensor(x, device=mask.device).expand(mask.shape)[where]  # noqa: E731
    probes = _probes(flt, pick(v), pick(i), pick(salt))  # [n, k]
    flt.bits[(*(ix[:, None] for ix in where[:-1]), probes)] = True


def query(flt: BloomFilter, v, i, salt=0) -> Tensor:
    """True where (v, i) *may* have been inserted (no false negatives)."""
    probes = _probes(flt, v, i, salt)  # [..., N, k]
    lead = probes.shape[:-2]
    bits = flt.bits.expand(*lead, flt.num_bits) if lead else flt.bits
    got = torch.gather(bits, -1, probes.reshape(*lead, -1))
    return got.reshape(probes.shape).all(dim=-1)


def fill_fraction(flt: BloomFilter) -> Tensor:
    return flt.bits.to(torch.float32).mean(dim=-1)
