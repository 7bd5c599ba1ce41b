"""mind [recsys]: embed_dim=64, 4 interests, 3 capsule iterations,
multi-interest interaction. [arXiv:1904.08030; unverified]  The numbers of
``repro/configs/mind.py``.

Shapes: train_batch (B=65,536 sampled-softmax training), serve_p99 (B=512
online scoring), serve_bulk (B=262,144 offline scoring), retrieval_cand
(1 query × 1,000,000 candidates — one batched product).  The reference's
``build_cell`` lowers jitted cells on a mesh for its dry-run; the port runs
the train, serve and retrieval steps directly (:func:`make_train_step`,
:func:`make_serve`, :func:`make_retrieval`).
"""

from repro_torch.configs.common import ArchSpec, ShapeDef, value_and_grad
from repro_torch.models.recsys import mind as model
from repro_torch.optim import adamw_update

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


ARCH = ArchSpec(
    name="mind", family="recsys", full=full, smoke=smoke, shapes=SHAPES,
    notes="EmbeddingBag = gather + sum (embeddingbag.py); the table lives whole on one card.",
)
