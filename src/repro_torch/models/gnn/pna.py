"""Principal Neighbourhood Aggregation (arXiv:2004.05718).

The port of ``repro/models/gnn/pna.py``.  Per layer: edge messages from an
MLP over [h_u ‖ h_v ‖ e_uv], aggregated with {mean, max, min, std} and
scaled by {identity, amplification, attenuation} (log-degree scalers),
concatenated with h (13 × d) and projected back to d, with a residual.
Max and min mask padded edges with ∓1e30 and read 0 where a node has no
edge, as the reference does.  Config: n_layers=4, d_hidden=75.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models.gnn import common as g

Tensor = torch.Tensor

AGGREGATORS = ("mean", "max", "min", "std")
SCALERS = ("identity", "amplification", "attenuation")


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    num_layers: int = 4
    d_hidden: int = 75
    d_in: int = 128
    d_edge: int = 8
    num_classes: int = 16
    avg_deg_log: float = 2.0  # δ: E[log(deg+1)] over the training set


def init_params(cfg: PNAConfig, generator: torch.Generator | None, device=None) -> dict:
    """The reference's tree (names, shapes, ``N(0, 1) · scale``, zeros and
    ones), float32, drawn from ``generator`` on ``device`` (default: the
    CUDA device)."""
    dev = resolve_device(device)
    d = cfg.d_hidden
    n_agg = len(AGGREGATORS) * len(SCALERS)
    rnd = lambda shape, scale: torch.randn(shape, generator=generator, device=dev).mul_(scale)  # noqa: E731
    zeros = lambda n: torch.zeros((n,), device=dev)  # noqa: E731
    p = {
        "enc_w": rnd((cfg.d_in, d), cfg.d_in**-0.5),
        "enc_b": zeros(d),
        "layers": [],
        "head_w": rnd((d, cfg.num_classes), d**-0.5),
        "head_b": zeros(cfg.num_classes),
    }
    for _ in range(cfg.num_layers):
        p["layers"].append({
            "msg_w1": rnd((2 * d + cfg.d_edge, d), (2 * d) ** -0.5),
            "msg_b1": zeros(d),
            "msg_w2": rnd((d, d), d**-0.5),
            "msg_b2": zeros(d),
            "upd_w": rnd(((n_agg + 1) * d, d), ((n_agg + 1) * d) ** -0.5),
            "upd_b": zeros(d),
            "ln_g": torch.ones((d,), device=dev),
            "ln_b": zeros(d),
        })
    return p


def _layer(cfg: PNAConfig, batch: g.GraphBatch, h: Tensor, w: dict) -> Tensor:
    n = h.shape[0]
    src, dst = batch.edge_src, batch.edge_dst
    emask = batch.edge_mask[:, None]
    m_in = torch.cat([g.gather(h, src), g.gather(h, dst), batch.edge_feat[:, : cfg.d_edge]], dim=-1)
    m = g.mlp(m_in, [w["msg_w1"], w["msg_w2"]], [w["msg_b1"], w["msg_b2"]])
    m = torch.where(emask, m, 0.0)

    deg = g.degrees(dst, batch.edge_mask, n)  # [N]
    has = deg[:, None] > 0
    mean = g.segment_sum(m, dst, n) / torch.clamp(deg, min=1.0)[:, None]
    mx = g.segment_max(torch.where(emask, m, -1e30), dst, n)
    mx = torch.where(has, mx, 0.0)
    mn = g.segment_min(torch.where(emask, m, 1e30), dst, n)
    mn = torch.where(has, mn, 0.0)
    sq = g.segment_sum(m * m, dst, n) / torch.clamp(deg, min=1.0)[:, None]
    std = torch.sqrt(torch.clamp(sq - mean * mean, min=0.0) + 1e-5)

    logd = torch.log(deg + 1.0)[:, None]
    amp = logd / cfg.avg_deg_log
    att = cfg.avg_deg_log / torch.clamp(logd, min=1e-3)
    scaled = []
    for a in (mean, mx, mn, std):
        scaled += [a, a * amp, a * att]
    z = torch.cat(scaled + [h], dim=-1)
    out = z @ w["upd_w"] + w["upd_b"]
    out = g.layer_norm(out, w["ln_g"], w["ln_b"])
    return h + torch.relu(out)


def forward(cfg: PNAConfig, params: dict, batch: g.GraphBatch) -> Tensor:
    h = torch.relu(batch.node_feat[:, : cfg.d_in] @ params["enc_w"] + params["enc_b"])
    # remat per layer, as jax.checkpoint: the backward recomputes each
    # layer; the saved state is one [N, d] per layer
    for w in params["layers"]:
        h = g.remat(lambda h_, w_: _layer(cfg, batch, h_, w_), h, w)
    return h @ params["head_w"] + params["head_b"]


def loss_fn(cfg: PNAConfig, params: dict, batch: g.GraphBatch) -> Tensor:
    logits = forward(cfg, params, batch)
    return g.node_classification_loss(logits, batch.labels, batch.node_mask)
