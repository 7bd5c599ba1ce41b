"""MIND: Multi-Interest Network with Dynamic routing (arXiv:1904.08030).

The port of ``repro/models/recsys/mind.py`` for one device: user behaviour
sequence → item-table gathers → Behaviour-to-Interest (B2I) capsule routing
(``capsule_iters`` rounds, squash nonlinearity, shared bilinear map; the
reference's ``lax.scan`` is a Python loop) → K interest capsules →
label-aware attention for training / max-dot scoring for retrieval.
Parameters are float32, as the reference's.  :func:`loss_fn` is the
training loss; ``configs/mind.make_train_step`` takes its gradient by
autograd, through the item table's gathers (a dense table gradient, as
the reference's ``jnp.take``), and the AdamW step.

``retrieval_scores`` scores one user against 10⁶ candidates with a single
[K, D] × [D, N] product.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.engine import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    num_items: int = 8_388_608  # sparse table rows
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    seq_len: int = 50
    hidden: int = 256


def init_params(cfg: MINDConfig, generator: torch.Generator | None, device=None) -> dict:
    """The reference's parameters (same names, shapes and distributions),
    float32, drawn from ``generator`` on ``device`` (default: the CUDA
    device)."""
    dev = resolve_device(device)
    d = cfg.embed_dim

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=torch.float32, device=dev).mul_(scale)

    return {
        "item_table": normal((cfg.num_items, d), 0.01),
        "bilinear_s": normal((d, d), d**-0.5),  # shared B2I map
        "mlp_w1": normal((d, cfg.hidden), d**-0.5),
        "mlp_b1": torch.zeros((cfg.hidden,), dtype=torch.float32, device=dev),
        "mlp_w2": normal((cfg.hidden, d), cfg.hidden**-0.5),
        "mlp_b2": torch.zeros((d,), dtype=torch.float32, device=dev),
    }


def _squash(x: Tensor, dim: int = -1) -> Tensor:
    n2 = torch.sum(torch.square(x), dim=dim, keepdim=True)
    return (n2 / (1.0 + n2)) * x / torch.sqrt(n2 + 1e-9)


def user_interests(cfg: MINDConfig, params: dict, behavior: Tensor, valid: Tensor) -> Tensor:
    """behavior int [B, L], valid bool [B, L] → interests [B, K, D].

    B2I dynamic routing: logits b_kj updated by agreement ⟨u_k, ŝ_j⟩ over
    ``capsule_iters`` rounds; behaviour capsules ŝ_j = S e_j (shared S).
    """
    emb = params["item_table"][behavior]  # [B, L, D]
    emb = torch.where(valid[..., None], emb, 0.0)
    s_hat = emb @ params["bilinear_s"]  # [B, L, D]

    b, l, d = s_hat.shape
    logits = torch.zeros((b, cfg.n_interests, l), dtype=s_hat.dtype, device=s_hat.device)
    u = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(logits, dim=1)  # over interests
        w = torch.where(valid[:, None, :], w, 0.0)
        u = _squash(torch.einsum("bkl,bld->bkd", w, s_hat))
        logits = logits + torch.einsum("bkd,bld->bkl", u, s_hat)
    h = torch.relu(u @ params["mlp_w1"] + params["mlp_b1"])
    return u + h @ params["mlp_w2"] + params["mlp_b2"]  # residual interest MLP


def label_aware_attention(interests: Tensor, target_emb: Tensor, p: float = 2.0) -> Tensor:
    """Train-time pooling: softmax(⟨u_k, e_t⟩^p) weighted interests. [B, D]"""
    scores = torch.einsum("bkd,bd->bk", interests, target_emb)
    w = torch.softmax(torch.pow(torch.abs(scores) + 1e-9, p) * torch.sign(scores), dim=-1)
    return torch.einsum("bk,bkd->bd", w, interests)


def loss_fn(cfg: MINDConfig, params: dict, behavior: Tensor, valid: Tensor, target: Tensor,
            negatives: Tensor) -> Tensor:
    """Sampled-softmax training loss: the positive item ``target [B]``
    against ``negatives [B, M]``."""
    interests = user_interests(cfg, params, behavior, valid)
    t_emb = params["item_table"][target]
    user = label_aware_attention(interests, t_emb)  # [B, D]
    n_emb = params["item_table"][negatives]  # [B, M, D]
    pos = torch.einsum("bd,bd->b", user, t_emb)
    neg = torch.einsum("bd,bmd->bm", user, n_emb)
    logits = torch.cat([pos[:, None], neg], dim=1)
    return -torch.log_softmax(logits, dim=1)[:, 0].mean()


def serve_scores(cfg: MINDConfig, params: dict, behavior: Tensor, valid: Tensor,
                 candidates: Tensor) -> Tensor:
    """Online/offline scoring: [B] users × their [B, C] candidates → [B, C]."""
    interests = user_interests(cfg, params, behavior, valid)
    c_emb = params["item_table"][candidates]  # [B, C, D]
    scores = torch.einsum("bkd,bcd->bkc", interests, c_emb)
    return scores.amax(dim=1)  # max over interests (MIND's retrieval rule)


def retrieval_scores(cfg: MINDConfig, params: dict, behavior: Tensor, valid: Tensor,
                     candidates: Tensor) -> Tensor:
    """Users against one candidate slab ``[C]``: one [K, D] × [D, C]
    product per user. [B, C]"""
    interests = user_interests(cfg, params, behavior, valid)  # [B, K, D]
    c_emb = params["item_table"][candidates]  # [C, D]
    scores = torch.einsum("bkd,cd->bkc", interests, c_emb)
    return scores.amax(dim=1)
