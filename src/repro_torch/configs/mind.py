"""mind [recsys]: embed_dim=64, 4 interests, 3 capsule iterations,
multi-interest interaction. [arXiv:1904.08030; unverified]  The numbers of
``repro/configs/mind.py``.

Shapes: train_batch (B=65,536 sampled-softmax training), serve_p99 (B=512
online scoring), serve_bulk (B=262,144 offline scoring), retrieval_cand
(1 query × 1,000,000 candidates — one batched product).
:func:`build_cell` is the reference's cell (the item table's rows over
``table_rows``, the rest replicated; its ids are int64, the port's, where
the reference's are int32); the port runs the train, serve and retrieval
steps directly (:func:`make_train_step`, :func:`make_serve`,
:func:`make_retrieval`).
"""

import torch

from repro_torch.configs.common import (
    ArchSpec,
    Cell,
    ShapeDef,
    batch_sharding,
    named,
    replicated,
    tree_struct,
    value_and_grad,
)
from repro_torch.models.recsys import mind as model
from repro_torch.optim import adamw_update
from repro_torch.optim.adamw import adamw_init

SHAPES = {
    "train_batch": ShapeDef("train", dict(batch=65536)),
    "serve_p99": ShapeDef("serve", dict(batch=512, candidates=1024)),
    "serve_bulk": ShapeDef("serve", dict(batch=262144, candidates=128)),
    "retrieval_cand": ShapeDef("retrieval", dict(batch=1, candidates=1_000_000)),
}


def full() -> model.MINDConfig:
    return model.MINDConfig(
        num_items=8_388_608, embed_dim=64, n_interests=4, capsule_iters=3, seq_len=50
    )


def smoke() -> model.MINDConfig:
    return model.MINDConfig(num_items=512, embed_dim=16, seq_len=8, hidden=32)


def make_train_step(cfg: model.MINDConfig):
    """The train shape's step: ``(params, opt_state, behavior, valid,
    target, negatives)`` → (new params, new optimizer state, ``{"loss",
    "gnorm"}``): the sampled-softmax loss and its gradient by autograd
    (through the item table's gathers: a dense table gradient), then AdamW
    at lr 1e-3."""

    def train_step(params, opt_state, behavior, valid, target, neg):
        loss, grads = value_and_grad(lambda p: model.loss_fn(cfg, p, behavior, valid, target, neg), params)
        new_p, new_o, gnorm = adamw_update(params, grads, opt_state, lr=1e-3)
        return new_p, new_o, {"loss": loss, "gnorm": gnorm}

    return train_step


def make_serve(cfg: model.MINDConfig):
    """The serve shapes' step: ``[B]`` users' behaviour ``[B, L]`` (with its
    validity mask) and their candidates ``[B, C]`` → scores ``[B, C]``."""

    def serve_step(params, behavior, valid, candidates):
        return model.serve_scores(cfg, params, behavior, valid, candidates)

    return serve_step


def make_retrieval(cfg: model.MINDConfig):
    """The retrieval shape's step: users ``[B, L]`` against one candidate
    slab ``[C]`` → scores ``[B, C]``."""

    def retrieval_step(params, behavior, valid, candidates):
        return model.retrieval_scores(cfg, params, behavior, valid, candidates)

    return retrieval_step


def _shardings(mesh) -> dict:
    rep = replicated(mesh)
    return {"item_table": named(mesh, "table_rows", None), "bilinear_s": rep, "mlp_w1": rep, "mlp_b1": rep,
            "mlp_w2": rep, "mlp_b2": rep}


def _ids(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int64, device="meta")


def build_cell(cfg: model.MINDConfig, shape_name: str, mesh) -> Cell:
    """The reference's cell of a shape: the step, its meta arguments and
    their shardings; ``model_flops`` its useful products (the bilinear
    map, the routing agreements and the interest MLP, plus the scores)."""
    meta = SHAPES[shape_name].meta
    b = meta["batch"]
    d, L, K = cfg.embed_dim, cfg.seq_len, cfg.n_interests
    fwd_interests = b * (L * 2 * d * d + cfg.capsule_iters * 2 * K * L * 2 * d
                         + K * (2 * d * cfg.hidden + 2 * cfg.hidden * d))
    ps = model.init_params(cfg, None, device="meta")
    psh, bsh, rep = _shardings(mesh), batch_sharding(mesh), replicated(mesh)
    valid = torch.empty((b, L), dtype=torch.bool, device="meta")
    kind = SHAPES[shape_name].kind
    name = f"mind:{shape_name}"
    if kind == "train":
        os_ = tree_struct(adamw_init, ps)
        args = (ps, os_, _ids(b, L), valid, _ids(b), _ids(b, 20))
        in_sh = (psh, os_._replace(step=rep, mu=psh, nu=psh), bsh, bsh, bsh, bsh)
        return Cell(name, make_train_step(cfg), args, in_sh, mesh=mesh,
                    model_flops=3.0 * (fwd_interests + b * 21 * 2 * d))  # + sampled softmax
    c = meta["candidates"]
    mf = fwd_interests + b * K * c * 2 * d
    if kind == "serve":
        return Cell(name, make_serve(cfg), (ps, _ids(b, L), valid, _ids(b, c)), (psh, bsh, bsh, bsh), mesh=mesh,
                    model_flops=mf)
    # retrieval: the candidate slab over the model axis (one batched product)
    return Cell(name, make_retrieval(cfg), (ps, _ids(b, L), valid, _ids(c)),
                (psh, rep, rep, named(mesh, "table_rows")), mesh=mesh, model_flops=mf)


ARCH = ArchSpec(
    name="mind", family="recsys", full=full, smoke=smoke, shapes=SHAPES, build_cell=build_cell,
    notes="EmbeddingBag = gather + sum (embeddingbag.py); the table lives whole on one card.",
)
