"""Deterministic synthetic token/feature pipelines (numpy only).

The port of ``repro/data/synthetic.py``, draw for draw.  Batches are keyed
on (seed, step) so a restarted run replays the exact failed step — the
property the fault supervisor relies on.
"""

from __future__ import annotations

import numpy as np


def lm_batch(step: int, *, batch: int, seq_len: int, vocab: int, seed: int = 0):
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    tokens = rng.integers(0, vocab, size=(batch, seq_len + 1), dtype=np.int32)
    return tokens[:, :-1], tokens[:, 1:]


def mind_batch(step: int, *, batch: int, seq_len: int, num_items: int,
               num_negatives: int = 20, seed: int = 0):
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 1]))
    behavior = rng.integers(0, num_items, size=(batch, seq_len), dtype=np.int32)
    valid = rng.random((batch, seq_len)) < 0.9
    target = rng.integers(0, num_items, size=batch, dtype=np.int32)
    neg = rng.integers(0, num_items, size=(batch, num_negatives), dtype=np.int32)
    return behavior, valid, target, neg
