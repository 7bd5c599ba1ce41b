"""Optimizers and distributed-optimization tricks: the port of
``repro.optim``."""

from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update, global_norm  # noqa: F401
from repro_torch.optim.schedules import cosine_with_warmup  # noqa: F401
