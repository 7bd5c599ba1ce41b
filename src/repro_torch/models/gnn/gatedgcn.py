"""GatedGCN (arXiv:2003.00982): anisotropic gated message passing.

The port of ``repro/models/gnn/gatedgcn.py``:

    ê_ij = C e_ij + D h_i + E h_j          (edge gate features)
    η_ij = σ(ê_ij) / (Σ_{j'∈N(i)} σ(ê_ij') + ε)
    h_i' = h_i + ReLU(LN(A h_i + Σ_j η_ij ⊙ (B h_j)))

Config: n_layers=16, d_hidden=70, gated aggregator.  Edge features are
updated residually alongside nodes (the benchmark-standard variant).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models.gnn import common as g

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GatedGCNConfig:
    name: str = "gatedgcn"
    num_layers: int = 16
    d_hidden: int = 70
    d_in: int = 128
    d_edge: int = 8
    num_classes: int = 16


def init_params(cfg: GatedGCNConfig, generator: torch.Generator | None, device=None) -> dict:
    """The reference's tree (names, shapes, scales), float32, drawn from
    ``generator`` on ``device`` (default: the CUDA device)."""
    dev = resolve_device(device)
    d = cfg.d_hidden
    rnd = lambda shape, scale: torch.randn(shape, generator=generator, device=dev).mul_(scale)  # noqa: E731
    zeros = lambda n: torch.zeros((n,), device=dev)  # noqa: E731
    ones = lambda n: torch.ones((n,), device=dev)  # noqa: E731
    p = {
        "enc_w": rnd((cfg.d_in, d), cfg.d_in**-0.5),
        "enc_b": zeros(d),
        "edge_enc_w": rnd((cfg.d_edge, d), cfg.d_edge**-0.5),
        "edge_enc_b": zeros(d),
        "layers": [],
        "head_w": rnd((d, cfg.num_classes), d**-0.5),
        "head_b": zeros(cfg.num_classes),
    }
    for _ in range(cfg.num_layers):
        lay = {name: rnd((d, d), d**-0.5) for name in "ABCDE"}
        lay.update(ln_g=ones(d), ln_b=zeros(d), ln_ge=ones(d), ln_be=zeros(d))
        p["layers"].append(lay)
    return p


def _layer(batch: g.GraphBatch, h: Tensor, e: Tensor, w: dict) -> tuple[Tensor, Tensor]:
    n = h.shape[0]
    src, dst = batch.edge_src, batch.edge_dst
    h_src = g.gather(h, src)
    e_hat = e @ w["C"] + g.gather(h, dst) @ w["D"] + h_src @ w["E"]  # [E, d]
    sig = torch.sigmoid(e_hat) * batch.edge_mask[:, None]
    denom = g.segment_sum(sig, dst, n) + 1e-6  # [N, d]
    msgs = g.segment_sum(sig * (h_src @ w["B"]), dst, n)
    upd = h @ w["A"] + msgs / denom
    h_new = h + torch.relu(g.layer_norm(upd, w["ln_g"], w["ln_b"]))
    e_new = e + torch.relu(g.layer_norm(e_hat, w["ln_ge"], w["ln_be"]))
    return h_new, e_new


def forward(cfg: GatedGCNConfig, params: dict, batch: g.GraphBatch) -> Tensor:
    h = batch.node_feat[:, : cfg.d_in] @ params["enc_w"] + params["enc_b"]
    e = batch.edge_feat[:, : cfg.d_edge] @ params["edge_enc_w"] + params["edge_enc_b"]
    for w in params["layers"]:  # remat over (h, e), as jax.checkpoint
        h, e = g.remat(lambda h_, e_, w_: _layer(batch, h_, e_, w_), h, e, w)
    return h @ params["head_w"] + params["head_b"]


def loss_fn(cfg: GatedGCNConfig, params: dict, batch: g.GraphBatch) -> Tensor:
    logits = forward(cfg, params, batch)
    return g.node_classification_loss(logits, batch.labels, batch.node_mask)
