"""DimeNet (arXiv:2003.03123): directional message passing on edge triplets.

The port of ``repro/models/gnn/dimenet.py``.  Messages live on directed
edges; interaction blocks aggregate, for each edge a = (j→i), over incoming
edges b = (k→j), modulated by a joint radial × angular basis of (d_kj,
∠kji).  Bases: Bessel RBF (n_radial=6) and the spherical basis from
spherical Bessel × Legendre (n_spherical=7); the bilinear interaction uses
an n_bilinear=8 bottleneck.  Triplet lists are built on the host with a
per-graph cap (fixed shapes), by :func:`build_triplets`: the reference's
loop in numpy array passes, bit-equal to it.

The reference runs with float64 off, so its numpy constants (the Bessel
zeros) enter as float32; here they are cast to float32 explicitly.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models.gnn import common as g

Tensor = torch.Tensor

# first zeros of spherical Bessel j_l, l = 0..7 (n-th zero ≈ first + (n-1)π)
_J_ZEROS = np.array([3.14159, 4.49341, 5.76346, 6.98793, 8.18256, 9.35581, 10.51284, 11.65703])


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    num_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    num_species: int = 16
    num_targets: int = 1


# ------------------------------------------------------------------- bases
def bessel_rbf(d: Tensor, n_radial: int, cutoff: float) -> Tensor:
    """sqrt(2/c)·sin(nπ d/c)/d — DimeNet's radial Bessel basis. [E, n]"""
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d.device)
    d = torch.clamp(d, min=1e-6)[:, None]
    return math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * d / cutoff) / d


def _sph_bessel(l_max: int, x: Tensor) -> Tensor:
    """j_l(x) for l = 0..l_max via upward recurrence. [..., l_max+1]

    The recurrence is unstable for x ≲ l, so the argument is clamped at 1
    and values below a per-degree threshold are zeroed, as the reference
    does."""
    xs = torch.clamp(x, min=1.0)
    j0 = torch.sin(xs) / xs
    j1 = torch.sin(xs) / xs**2 - torch.cos(xs) / xs
    js = [j0, j1]
    for l in range(1, l_max):
        js.append((2 * l + 1) / xs * js[l] - js[l - 1])
    out = torch.stack(js[: l_max + 1], dim=-1)
    thresh = torch.tensor([max(l - 1.0, 0.0) for l in range(l_max + 1)], dtype=torch.float32,
                          device=x.device)
    return torch.where(x[..., None] >= thresh, out, 0.0)


def _legendre(l_max: int, c: Tensor) -> Tensor:
    """P_l(c) for l = 0..l_max. [..., l_max+1]"""
    ps = [torch.ones_like(c), c]
    for l in range(1, l_max):
        ps.append(((2 * l + 1) * c * ps[l] - l * ps[l - 1]) / (l + 1))
    return torch.stack(ps[: l_max + 1], dim=-1)


def spherical_basis(d: Tensor, cos_angle: Tensor, cfg: DimeNetConfig) -> Tensor:
    """Joint radial-angular basis. [T, n_spherical * n_radial]"""
    s, r = cfg.n_spherical, cfg.n_radial
    zeros = (_J_ZEROS[:s, None] + np.arange(r)[None, :] * np.pi).astype(np.float32)  # [S, R]
    zeros = torch.from_numpy(zeros).to(d.device)
    x = d[:, None, None] / cfg.cutoff * zeros[None]  # [T, S, R]
    jl = _sph_bessel(s - 1, x.reshape(-1, r)).reshape(d.shape[0], s, r, s)
    # j_l evaluated at its own l row: the diagonal over the stacked l axis
    idx = torch.arange(s, device=d.device).view(1, s, 1, 1).expand(d.shape[0], s, r, 1)
    jl = torch.gather(jl, -1, idx)[..., 0]
    pl = _legendre(s - 1, cos_angle)  # [T, S]
    return (jl * pl[:, :, None]).reshape(d.shape[0], -1)


# ------------------------------------------------------------------ triplets
def build_triplets(
    src: np.ndarray, dst: np.ndarray, mask: np.ndarray, max_triplets: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side: (b_idx, a_idx, t_mask) — edge b=(k→j) feeds edge a=(j→i).

    The reference's loop (for each live edge a in index order, each live b
    into a's source in index order, k == i skipped, stopping at the cap)
    as array passes over blocks of a: the same triplets in the same order."""
    src, dst = np.asarray(src), np.asarray(dst)
    live = np.nonzero(mask)[0]
    by_dst = live[np.argsort(dst[live], kind="stable")]  # live edges grouped by dst, in index order
    keys = dst[by_dst]
    b_parts, a_parts, t = [], [], 0
    if max_triplets <= 0:  # the reference's loop tests the cap after its first edge's candidates
        live = live[:1]
    limit = max(max_triplets, 1)  # ... and within them, after its first append
    block = 1 << 16
    for a0 in range(0, live.shape[0], block):
        a = live[a0 : a0 + block]
        lo = np.searchsorted(keys, src[a], "left")
        cnt = np.searchsorted(keys, src[a], "right") - lo
        first = np.cumsum(cnt) - cnt
        inner = np.arange(int(cnt.sum())) - np.repeat(first, cnt)
        b = by_dst[np.repeat(lo, cnt) + inner]
        a = np.repeat(a, cnt)
        keep = src[b] != dst[a]  # exclude the k == i backtrack
        b, a = b[keep][: limit - t], a[keep][: limit - t]
        b_parts.append(b)
        a_parts.append(a)
        t += b.shape[0]
        if t >= limit:
            break
    pad = max_triplets - t
    b_idx = np.concatenate(b_parts + [np.zeros(max(pad, 0), np.int64)]).astype(np.int32)
    a_idx = np.concatenate(a_parts + [np.zeros(max(pad, 0), np.int64)]).astype(np.int32)
    # an empty list, as the reference's at a cap of 0, becomes a float64 array
    t_mask = np.arange(b_idx.shape[0]) < t if b_idx.shape[0] else np.asarray([])
    return b_idx, a_idx, t_mask


def triplets_to(triplets, device=None) -> tuple[Tensor, Tensor, Tensor]:
    """Host triplets as the port's tensors (indices int64) on ``device``."""
    dev = resolve_device(device)
    b, a, m = triplets
    return (torch.from_numpy(np.asarray(b, np.int64)).to(dev), torch.from_numpy(np.asarray(a, np.int64)).to(dev),
            torch.from_numpy(np.asarray(m, bool)).to(dev))


# -------------------------------------------------------------------- params
def init_params(cfg: DimeNetConfig, generator: torch.Generator | None, device=None) -> dict:
    """The reference's tree (names, shapes, ``N(0, 1) / sqrt(fan_in)``,
    the species table at 0.5), float32, drawn from ``generator`` on
    ``device`` (default: the CUDA device)."""
    dev = resolve_device(device)
    d, nb = cfg.d_hidden, cfg.n_bilinear
    nsr = cfg.n_spherical * cfg.n_radial
    rnd = lambda *shape: torch.randn(shape, generator=generator, device=dev).mul_(shape[0] ** -0.5)  # noqa: E731
    zeros = lambda n: torch.zeros((n,), device=dev)  # noqa: E731
    p = {
        "species_emb": torch.randn((cfg.num_species, d), generator=generator, device=dev).mul_(0.5),
        "emb_rbf": rnd(cfg.n_radial, d),
        "emb_w": rnd(3 * d, d),
        "emb_b": zeros(d),
        "blocks": [],
        "out_rbf": rnd(cfg.n_radial, d),
        "head_w": rnd(d, cfg.num_targets),
        "head_b": zeros(cfg.num_targets),
    }
    for _ in range(cfg.num_blocks):
        p["blocks"].append({
            "w_msg": rnd(d, d),
            "w_down": rnd(d, nb),
            "w_sbf": rnd(nsr, nb),
            "w_up": rnd(nb, d),
            "w_rbf_gate": rnd(cfg.n_radial, d),
            "upd_w1": rnd(d, d),
            "upd_b1": zeros(d),
            "upd_w2": rnd(d, d),
            "upd_b2": zeros(d),
            "out_w": rnd(d, d),
        })
    return p


# ------------------------------------------------------------------- forward
def forward(cfg: DimeNetConfig, params: dict, batch: g.GraphBatch, triplets) -> Tensor:
    """Per-node scalar predictions [N, num_targets] (their masked sum is the
    molecule-level target)."""
    n = batch.num_nodes
    src, dst = batch.edge_src, batch.edge_dst
    b_idx, a_idx, t_mask = triplets
    silu = torch.nn.functional.silu

    # species from labels (molecule graphs store atomic numbers in labels)
    z = g.gather(params["species_emb"], torch.clamp(batch.labels, 0, params["species_emb"].shape[0] - 1))
    rvec = g.gather(batch.pos, dst) - g.gather(batch.pos, src)  # [E, 3]
    dist = torch.linalg.vector_norm(rvec + 1e-12, dim=-1)
    rbf = bessel_rbf(dist, cfg.n_radial, cfg.cutoff) * batch.edge_mask[:, None]

    m = torch.cat([g.gather(z, src), g.gather(z, dst), rbf @ params["emb_rbf"]], dim=-1)
    m = silu(m @ params["emb_w"] + params["emb_b"])  # [E, d]

    # triplet geometry: the angle between edge b=(k→j) and a=(j→i)
    ra = g.gather(rvec, a_idx)
    rb = -g.gather(rvec, b_idx)  # from j to k
    cosang = (ra * rb).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(ra, dim=-1) * torch.linalg.vector_norm(rb, dim=-1), min=1e-6)
    sbf = spherical_basis(g.gather(dist, b_idx), cosang, cfg) * t_mask[:, None]

    def block_fn(m_, h_, w):
        mt = silu(m_ @ w["w_msg"])
        a_feat = (g.gather(mt, b_idx) @ w["w_down"]) * (sbf @ w["w_sbf"])  # [T, nb]
        agg = g.segment_sum(a_feat, a_idx, m_.shape[0]) @ w["w_up"]
        gate = rbf @ w["w_rbf_gate"]
        upd = silu((mt + agg * gate) @ w["upd_w1"] + w["upd_b1"])
        m_ = m_ + silu(upd @ w["upd_w2"] + w["upd_b2"])
        h_ = h_ + g.segment_sum(m_ * (rbf @ w["out_rbf"]), dst, n) @ w["out_w"]
        return m_, h_

    h_out = torch.zeros((n, cfg.d_hidden), device=m.device)
    for w in params["blocks"]:  # remat the O(T) triplet tensors, as jax.checkpoint
        m, h_out = g.remat(block_fn, m, h_out, dict(w, out_rbf=params["out_rbf"]))

    pred = silu(h_out) @ params["head_w"] + params["head_b"]
    return pred * batch.node_mask[:, None]


def loss_fn(cfg: DimeNetConfig, params: dict, batch: g.GraphBatch, triplets) -> Tensor:
    pred = forward(cfg, params, batch, triplets)
    target = (batch.labels.to(torch.float32) * batch.node_mask)[:, None] * 0.01
    return torch.mean((pred - target) ** 2)
