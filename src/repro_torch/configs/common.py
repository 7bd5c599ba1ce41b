"""Architecture registry protocol of the port.

Every architecture module exposes an :class:`ArchSpec` as the reference's
``repro/configs/common.py`` does: ``name``, ``family``, ``full`` (the
published widths), ``smoke`` (a reduced config for CPU tests), ``shapes``
(the assigned input shapes) and ``notes``.  The reference's ``build_cell``,
``Cell`` and sharding helpers lower jitted cells on a mesh for its dry-run;
the port runs its cells directly (``configs/lm_harness.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class ShapeDef:
    kind: str  # train | prefill | decode | serve | retrieval
    meta: dict


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str
    full: Callable[[], Any]
    smoke: Callable[[], Any]
    shapes: dict
    notes: str = ""
