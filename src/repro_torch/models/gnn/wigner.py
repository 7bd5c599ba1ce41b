"""Real Wigner-D rotation matrices for spherical-harmonic (irrep) features.

The port of ``repro/models/gnn/wigner.py``.  Acting on *real* spherical
harmonics of degree l, a rotation R_z(α)R_y(β) has the block form
D_l = C_l · e^{iα m} · d_l(β) · C_l^H, where d_l(β) = exp(-iβ J_y).  J_y is
eigendecomposed once per l on the host (numpy, the same ``np.linalg.eigh``
as the reference, cached), so the per-edge cost is a batched complex
diagonal product.  The reference runs with float64 off, so its host
constants enter its products as float32/complex64; the port casts them so
and runs the products in complex64 (complex128 would be slow on the card).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

Tensor = torch.Tensor


@functools.lru_cache(maxsize=None)
def _jy_eig(l: int) -> tuple[np.ndarray, np.ndarray]:
    """Eigendecomposition of J_y in the complex |l m⟩ basis: J_y = V Λ V^H."""
    m = np.arange(-l, l + 1)
    dim = 2 * l + 1
    jp = np.zeros((dim, dim), complex)  # J_+ |l m⟩ = c |l m+1⟩
    for i in range(dim - 1):
        mm = m[i]
        jp[i + 1, i] = np.sqrt(l * (l + 1) - mm * (mm + 1))
    jm = jp.conj().T
    jy = (jp - jm) / 2j
    lam, v = np.linalg.eigh(jy)
    return lam, v


@functools.lru_cache(maxsize=None)
def _real_to_complex(l: int) -> np.ndarray:
    """Unitary C with  Y_real = C · Y_complex  (Condon–Shortley)."""
    dim = 2 * l + 1
    c = np.zeros((dim, dim), complex)
    s2 = 1.0 / np.sqrt(2.0)
    for i, mm in enumerate(range(-l, l + 1)):
        if mm < 0:
            c[i, l + mm] = 1j * s2
            c[i, l - mm] = -1j * s2 * (-1) ** mm
        elif mm == 0:
            c[i, l] = 1.0
        else:
            c[i, l - mm] = s2
            c[i, l + mm] = s2 * (-1) ** mm
    return c


@functools.lru_cache(maxsize=None)
def _constants(l: int, device: torch.device) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """(Λ float32, V complex64, C complex64, m float32) on ``device``."""
    lam, v = _jy_eig(l)
    return (torch.from_numpy(lam.astype(np.float32)).to(device),
            torch.from_numpy(v.astype(np.complex64)).to(device),
            torch.from_numpy(_real_to_complex(l).astype(np.complex64)).to(device),
            torch.arange(-l, l + 1, dtype=torch.float32, device=device))


def wigner_d_real(l: int, alpha: Tensor, beta: Tensor) -> Tensor:
    """Real-basis Wigner D_l(R_z(α)R_y(β)) for batched angles. [..., 2l+1, 2l+1]

    Rows/cols are ordered m = -l..l in the real convention."""
    lam, v, c, m = _constants(l, alpha.device)
    # d(β) = V e^{-iβΛ} V^H
    phase = torch.exp(torch.complex(torch.zeros_like(beta), -beta)[..., None] * lam)  # [..., dim]
    d_beta = torch.einsum("ik,...k,jk->...ij", v, phase, v.conj())
    ez = torch.exp(torch.complex(torch.zeros_like(alpha), alpha)[..., None] * m)  # [..., dim]
    d_cplx = ez[..., :, None] * d_beta  # R_z(α) is diagonal in m
    d_real = torch.einsum("ab,...bc,dc->...ad", c, d_cplx, c.conj())
    return d_real.real.to(torch.float32)


def align_to_z_angles(rvec: Tensor) -> tuple[Tensor, Tensor]:
    """(α', β'), the polar angles of the unit edge vector: r = (sinβ' cosα',
    sinβ' sinα', cosβ').  ``wigner_d_real(l, 0, -β') @ wigner_d_real(l, -α',
    0)`` rotates it onto +z."""
    r = rvec / torch.clamp(torch.linalg.vector_norm(rvec, dim=-1, keepdim=True), min=1e-9)
    beta_p = torch.arccos(torch.clamp(r[..., 2], -1.0, 1.0))
    alpha_p = torch.arctan2(r[..., 1], r[..., 0])
    return alpha_p, beta_p


def rotate_block(feats: Tensor, d_mats: dict[int, Tensor], l_max: int, inverse: bool = False) -> Tensor:
    """Apply per-l Wigner blocks to irrep features [..., (l_max+1)^2, C]."""
    out = []
    off = 0
    for l in range(l_max + 1):
        dim = 2 * l + 1
        blk = feats[..., off : off + dim, :]
        d = d_mats[l]
        if inverse:
            d = d.transpose(-1, -2)  # orthogonal → inverse = transpose
        out.append(d @ blk)
        off += dim
    return torch.cat(out, dim=-2)
