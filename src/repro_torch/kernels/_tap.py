"""The counting taps of the hand-written kernels and the mesh's collectives.

A counting run (``launch/hlo_analysis.Counter``) registers itself in
:data:`ACTIVE`; each kernel wrapper and each ``launch/mesh`` collective
adds its own operations and bytes through :func:`tap_kernel` /
:func:`tap_collective`, and runs its plain version's ops under
:func:`uncounted`.  The state lives here, below the kernels, so that the
kernel layer imports nothing of the launchers; a wrapper works its counts
out only ``if counting()``, so a run with no counter pays one list check a
call.
"""

from __future__ import annotations

import contextlib

ACTIVE: list = []  # the counters now counting, innermost last
PAUSED = [0]


@contextlib.contextmanager
def uncounted():
    """Ops run inside count nothing (a kernel's plain version, a
    collective's own copies)."""
    PAUSED[0] += 1
    try:
        yield
    finally:
        PAUSED[0] -= 1


def counting() -> bool:
    return bool(ACTIVE) and not PAUSED[0]


def tap_kernel(name: str, flops: float, nbytes: float, *, tensor_core: bool = False) -> None:
    """A hand-written kernel's call: its operations and bytes, into every
    active counter."""
    if not counting():
        return
    for c in ACTIVE:
        c.kernels[name] = c.kernels.get(name, 0) + 1
        c.flops += flops
        c.tc_flops += flops if tensor_core else 0.0
        c.bytes += nbytes


def tap_collective(kind: str, nbytes: float) -> None:
    """A collective's result bytes, into every active counter."""
    if not counting():
        return
    for c in ACTIVE:
        c.coll_bytes += nbytes
        c.collectives[kind] = c.collectives.get(kind, 0) + 1
