"""EquiformerV2 (arXiv:2306.12059): equivariant graph attention with eSCN.

The port of ``repro/models/gnn/equiformer_v2.py``.  Node features are
real-spherical-harmonic irreps ``x [N, (l_max+1)², C]``.  Per edge, features
are rotated into the edge-aligned frame (Wigner-D, ``wigner.py``); there the
tensor-product convolution collapses to SO(2) linear maps that couple only
components of equal |m|, and eSCN's m_max truncation drops the rest.
Attention weights come from the invariant (m=0) channel; messages are
attention-aggregated, rotated back, and fed through an equivariant gated
FFN.

The reference's in-place array updates (``.at[].set/.add``) become
out-of-place constructions (``torch.cat``, ``index_copy``), so no tensor that
autograd saved is written.  The chunked layer's ``lax.scan`` over edge
chunks becomes a Python loop whose bodies run under checkpoint, as the
reference's scan bodies run under ``jax.checkpoint``.  The reference's
``constrain`` of the saved residual to a node sharding is the identity on
one device (the mesh path is ROADMAP Queue 1 item 9(f)).

Config: n_layers=12, d_hidden=128, l_max=6, m_max=2, 8 heads.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models.gnn import common as g
from repro_torch.models.gnn.wigner import align_to_z_angles, wigner_d_real

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EquiformerV2Config:
    name: str = "equiformer-v2"
    num_layers: int = 12
    d_hidden: int = 128
    l_max: int = 6
    m_max: int = 2
    num_heads: int = 8
    num_species: int = 16
    num_targets: int = 1
    cutoff: float = 5.0
    n_radial: int = 8
    # process edges in chunks of this size (bounds the [chunk, K, C] message
    # tensors on huge graphs; 0 = single pass).  Softmax runs as two chunked
    # passes (max, then exp-sum+aggregate): 2× edge compute for O(chunk) memory.
    edge_chunk: int = 0

    @property
    def num_components(self) -> int:
        return (self.l_max + 1) ** 2


def _l_index(l_max: int) -> np.ndarray:
    """Component index → its degree l."""
    out = []
    for l in range(l_max + 1):
        out += [l] * (2 * l + 1)
    return np.asarray(out, np.int32)


def _m_slots(l_max: int, m: int) -> tuple[np.ndarray, np.ndarray]:
    """Component indices of (+m, −m) across degrees l ≥ m (real basis: the
    index of (l, m) is l² + l + m)."""
    ls = np.arange(m, l_max + 1)
    return (ls * ls + ls + m).astype(np.int32), (ls * ls + ls - m).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _index(l_max: int, m_max: int, device: torch.device) -> dict:
    """The component index tensors on ``device``: ``l_of``, the m = 0 slots
    and, per m ≥ 1, the (+m, −m) slots; ``so2`` all of them in the order
    :func:`_so2_conv` writes its blocks."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(device)  # noqa: E731
    out = {"l_of": t(_l_index(l_max)), "p0": t(_m_slots(l_max, 0)[0])}
    order = [_m_slots(l_max, 0)[0]]
    for m in range(1, m_max + 1):
        pp, pm = _m_slots(l_max, m)
        out[f"pp{m}"], out[f"pm{m}"] = t(pp), t(pm)
        order += [pp, pm]
    out["so2"] = t(np.concatenate(order))
    return out


# -------------------------------------------------------------------- params
def init_params(cfg: EquiformerV2Config, generator: torch.Generator | None, device=None) -> dict:
    """The reference's tree (names, shapes, ``N(0, 1) / sqrt(fan_in)`` with
    fan-in the second-to-last axis, the species table at 0.5, the FFN mix at
    C^-1/2), float32, drawn from ``generator`` on ``device`` (default: the
    CUDA device)."""
    dev = resolve_device(device)
    c, lm = cfg.d_hidden, cfg.l_max
    normal = lambda shape, scale: torch.randn(shape, generator=generator, device=dev).mul_(scale)  # noqa: E731
    rnd = lambda *shape: normal(shape, shape[-2] ** -0.5)  # noqa: E731
    p = {
        "species_emb": normal((cfg.num_species, c), 0.5),
        "edge_rbf_w": rnd(cfg.n_radial, c),
        "layers": [],
        "head_w1": rnd(c, c),
        "head_b1": torch.zeros((c,), device=dev),
        "head_w2": rnd(c, cfg.num_targets),
    }
    for _ in range(cfg.num_layers):
        lay = {"ln_g": torch.ones((lm + 1, c), device=dev)}
        n0 = lm + 1
        lay["so2_w0"] = rnd(n0 * c, n0 * c)
        for m in range(1, cfg.m_max + 1):
            nl = lm + 1 - m
            lay[f"so2_wr{m}"] = rnd(nl * c, nl * c)
            lay[f"so2_wi{m}"] = normal((nl * c, nl * c), (nl * c) ** -0.5)
        lay["alpha_w"] = rnd(n0 * c, cfg.num_heads)
        lay["val_w"] = rnd(c, c)  # per-channel value mix (shared across lm)
        lay["out_w"] = rnd(c, c)
        lay["ffn_gate_w"] = rnd(c, (lm + 1) * c)
        lay["ffn_mix"] = normal((lm + 1, c, c), c**-0.5)
        lay["ffn_b"] = torch.zeros((c,), device=dev)
        p["layers"].append(lay)
    return p


def _equi_layernorm(x: Tensor, gamma: Tensor, l_of: Tensor, eps: float = 1e-5) -> Tensor:
    """Per-degree RMS over (m, channel); scalars keep their mean. [N, K, C]"""
    nl = gamma.shape[0]
    per_l = g.segment_sum(torch.square(x).movedim(1, 0), l_of, nl)  # [L, N, C]
    counts = g.segment_sum(torch.ones(l_of.shape, dtype=torch.float32, device=x.device), l_of, nl)
    rms = torch.sqrt(per_l.movedim(0, 1) / counts[None, :, None] + eps)  # [N, L, C]
    return x / g.gather(rms, l_of, 1) * g.gather(gamma, l_of)[None]


def _so2_conv(cfg: EquiformerV2Config, w: dict, msg: Tensor) -> Tensor:
    """SO(2) linear conv in the edge frame; m > m_max components are zero."""
    e, _, c = msg.shape
    ix = _index(cfg.l_max, cfg.m_max, msg.device)
    blocks = [(g.gather(msg, ix["p0"], 1).reshape(e, -1) @ w["so2_w0"]).reshape(e, -1, c)]  # m = 0
    for m in range(1, cfg.m_max + 1):  # m > 0: complex-structured 2-channel maps
        xp = g.gather(msg, ix[f"pp{m}"], 1).reshape(e, -1)
        xm = g.gather(msg, ix[f"pm{m}"], 1).reshape(e, -1)
        wr, wi = w[f"so2_wr{m}"], w[f"so2_wi{m}"]
        blocks += [(xp @ wr - xm @ wi).reshape(e, -1, c), (xp @ wi + xm @ wr).reshape(e, -1, c)]
    return torch.zeros_like(msg).index_copy(1, ix["so2"], torch.cat(blocks, dim=1))


def _ffn(cfg: EquiformerV2Config, w: dict, x: Tensor, l_of: Tensor) -> Tensor:
    s = x[:, 0, :]  # scalars
    gates = torch.sigmoid((s @ w["ffn_gate_w"]).reshape(-1, cfg.l_max + 1, x.shape[-1]))
    y = x * g.gather(gates, l_of, 1)
    y = torch.einsum("nkc,kcd->nkd", y, g.gather(w["ffn_mix"], l_of))
    y0 = torch.nn.functional.silu(y[:, 0, :] + w["ffn_b"])
    return x + torch.cat([y0[:, None], y[:, 1:]], dim=1)


def forward(cfg: EquiformerV2Config, params: dict, batch: g.GraphBatch) -> Tensor:
    n = batch.num_nodes
    l_of = _index(cfg.l_max, cfg.m_max, batch.pos.device)["l_of"]
    z = g.gather(params["species_emb"], torch.clamp(batch.labels, 0, params["species_emb"].shape[0] - 1))
    x = torch.cat([z[:, None], z.new_zeros((n, cfg.num_components - 1, cfg.d_hidden))], dim=1)

    layer = _attention_layer_chunked if cfg.edge_chunk else _attention_layer_exact

    def block(x_, w_):
        x_ = layer(cfg, w_, x_, batch, l_of)
        return _ffn(cfg, w_, x_, l_of)

    for w in params["layers"]:  # remat: per-layer edge tensors recomputed
        x = g.remat(block, x, dict(w, edge_rbf_w=params["edge_rbf_w"]))

    s = x[:, 0, :]
    out = torch.nn.functional.silu(s @ params["head_w1"] + params["head_b1"]) @ params["head_w2"]
    return out * batch.node_mask[:, None]


def _edge_geometry(cfg: EquiformerV2Config, batch: g.GraphBatch, src, dst, mask):
    """Wigner alignment blocks + radial basis for an edge (chunk)."""
    rvec = g.gather(batch.pos, dst) - g.gather(batch.pos, src)
    alpha, beta = align_to_z_angles(rvec)
    zeros = torch.zeros_like(beta)
    d_mats = {}
    for l in range(cfg.l_max + 1):
        d_y = wigner_d_real(l, zeros, -beta)
        d_z = wigner_d_real(l, -alpha, zeros)
        d_mats[l] = d_y @ d_z  # R_y(-β)·R_z(-α)
    dist = torch.linalg.vector_norm(rvec + 1e-12, dim=-1)
    nr = torch.arange(1, cfg.n_radial + 1, dtype=torch.float32, device=rvec.device)
    rbf = torch.sin(nr * math.pi * dist[:, None] / cfg.cutoff) / torch.clamp(dist, min=1e-6)[:, None]
    return d_mats, rbf * mask[:, None]


def _rot_blocks(cfg: EquiformerV2Config, d_mats: dict, feats: Tensor, inverse: bool = False) -> Tensor:
    out, off = [], 0
    for l in range(cfg.l_max + 1):
        dim = 2 * l + 1
        d = d_mats[l]
        if inverse:
            d = d.transpose(-1, -2)
        out.append(d @ feats[:, off : off + dim, :])
        off += dim
    return torch.cat(out, dim=-2)


def _edge_messages(cfg, w, xs, batch, src, dst, mask):
    """Per edge: geometry → rotate → SO(2) conv → (msg, attention logits)."""
    d_mats, rbf = _edge_geometry(cfg, batch, src, dst, mask)
    msg = _rot_blocks(cfg, d_mats, g.gather(xs, src))
    msg = torch.cat([msg[:, :1] + (rbf @ w["edge_rbf_w"])[:, None], msg[:, 1:]], dim=1)
    msg = _so2_conv(cfg, w, msg)
    p0 = _index(cfg.l_max, cfg.m_max, msg.device)["p0"]
    inv = torch.nn.functional.silu(g.gather(msg, p0, 1).reshape(msg.shape[0], -1))
    logits = torch.where(mask[:, None], inv @ w["alpha_w"], -1e30)
    return msg, logits, d_mats


def _attention_layer_exact(cfg, w, x, batch, l_of):
    """Rotate → SO(2) conv → attention → rotate back per edge → aggregate."""
    n = x.shape[0]
    src, dst = batch.edge_src, batch.edge_dst
    xs = _equi_layernorm(x, w["ln_g"], l_of)
    msg, logits, d_mats = _edge_messages(cfg, w, xs, batch, src, dst, batch.edge_mask)

    # read only at edges' destinations, so no empty segment is read
    lmax_per_dst = g.segment_max(logits, dst, n)
    ex = torch.exp(logits - g.gather(lmax_per_dst, dst))
    denom = g.segment_sum(ex, dst, n)
    alpha = ex / torch.clamp(g.gather(denom, dst), min=1e-9)

    e_, k_, c_ = msg.shape
    h = cfg.num_heads
    val = (msg @ w["val_w"]).reshape(e_, k_, h, c_ // h)
    val = (val * alpha[:, None, :, None]).reshape(e_, k_, c_)
    val = val * batch.edge_mask[:, None, None]
    val = _rot_blocks(cfg, d_mats, val, inverse=True)  # back to the global frame
    agg = g.segment_sum(val, dst, n)
    return x + agg @ w["out_w"]


def _attention_layer_chunked(cfg, w, x, batch, l_of):
    """Memory-bounded variant for huge graphs: edges in fixed chunks.

    Pass 1 takes the per-destination softmax max chunk by chunk; pass 2
    recomputes each chunk's messages and accumulates the denominator and
    the aggregate.  Peak edge tensors are O(edge_chunk · K · C).  Both
    passes' bodies run under checkpoint: without it each chunk would save
    its message tensors for the backward and the chunking would buy
    nothing."""
    n = x.shape[0]
    e = batch.num_edges
    ch = cfg.edge_chunk
    nch = -(-e // ch)
    pad = nch * ch - e
    src = torch.nn.functional.pad(batch.edge_src, (0, pad))
    dst = torch.nn.functional.pad(batch.edge_dst, (0, pad))
    mask = torch.nn.functional.pad(batch.edge_mask, (0, pad))
    xs = _equi_layernorm(x, w["ln_g"], l_of)
    k_, c_ = cfg.num_components, cfg.d_hidden
    h = cfg.num_heads

    def chunk_ids(i):
        return src[i * ch : (i + 1) * ch], dst[i * ch : (i + 1) * ch], mask[i * ch : (i + 1) * ch]

    def pass1(lmax, xs_, i):
        s, d, m = chunk_ids(i)
        _, logits, _ = _edge_messages(cfg, w, xs_, batch, s, d, m)
        return torch.maximum(lmax, g.segment_max(logits, d, n))

    lmax = torch.full((n, h), -1e30, device=x.device)
    for i in range(nch):
        lmax = g.remat(pass1, lmax, xs, i)

    def pass2(denom, agg, xs_, lmax_, i):
        s, d, m = chunk_ids(i)
        msg, logits, d_mats = _edge_messages(cfg, w, xs_, batch, s, d, m)
        ex = torch.exp(logits - g.gather(lmax_, d)) * m[:, None]
        denom = denom + g.segment_sum(ex, d, n)
        val = (msg @ w["val_w"]).reshape(ch, k_, h, c_ // h)
        val = (val * ex[:, None, :, None]).reshape(ch, k_, c_)
        val = _rot_blocks(cfg, d_mats, val, inverse=True)
        return denom, agg + g.segment_sum(val, d, n)

    denom = torch.zeros((n, h), device=x.device)
    agg = torch.zeros((n, k_, c_), device=x.device)
    for i in range(nch):
        denom, agg = g.remat(pass2, denom, agg, xs, lmax, i)
    # normalise: heads were folded into channels; expand denom per head
    agg = agg.reshape(n, k_, h, c_ // h) / torch.clamp(denom, min=1e-9)[:, None, :, None]
    agg = agg.reshape(n, k_, c_)
    return x + agg @ w["out_w"]


def loss_fn(cfg: EquiformerV2Config, params: dict, batch: g.GraphBatch) -> Tensor:
    pred = forward(cfg, params, batch)
    target = (batch.labels.to(torch.float32) * batch.node_mask)[:, None] * 0.01
    return torch.mean((pred - target) ** 2)
