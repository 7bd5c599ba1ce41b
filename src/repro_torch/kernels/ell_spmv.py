"""Fused semiring SpMV over ELL in-adjacency (the IFE inner loop).

The port of ``repro/kernels/ell_spmv.py::ell_spmv``: ExpandFrontier = Join +
Min (§3.2) with the per-edge Join output never materialized (JOD, §4).
The CUDA kernel is ``csrc/ell_spmv.cu``; its note gives the bound and the
design.  Layout (see ``GraphSnapshot.to_ell``):

    states [Q, Vp]      vertex states; index Vp - 1 (= V for an unsharded
                        graph) holds the reduce identity, and ELL padding
                        cells point there
    nbr    [V, D]       in-neighbour ids (int32)
    w      [V, D]       edge weights (float32)
    carry  [Q, V]       previous states (min family) or the teleport base
    out    [Q, V]

:func:`ell_spmv` launches the kernel for CUDA tensors and runs
:func:`ell_spmv_ref`, the plain PyTorch version, for CPU tensors.  The
kernel reads the states transposed, ``[Vp, Q]``: the public function
transposes them, and the engine builds them so in one pass
(:func:`transpose_states`) and passes ``transposed=True``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SEMIRINGS = ("min_plus", "min_hop", "min_label", "pr_sum")
SOURCE = "ell_spmv.cu"

# kernel launches since the last reset (the count a run reads to show that
# its main path went through the kernel)
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def ell_spmv_ref(
    states: torch.Tensor,
    nbr: torch.Tensor,
    w: torch.Tensor,
    carry: torch.Tensor,
    *,
    semiring: str,
    hop_cap: float = float("inf"),
    transposed: bool = False,
) -> torch.Tensor:
    """Plain version: gather ``states[:, nbr]`` → msg → reduce → carry.
    The counterpart of ``repro/kernels/ref.py::ell_spmv_ref``
    (``transposed``: ``states`` comes as ``[Vp, Q]``)."""
    if transposed:
        states = states.t()
    s = states[:, nbr.long()]  # [Q, V, D]
    if semiring == "min_plus":
        return torch.minimum(torch.amin(s + w[None], dim=-1), carry)
    if semiring == "min_hop":
        msgs = s + 1.0
        msgs = torch.where(msgs > hop_cap, float("inf"), msgs)
        return torch.minimum(torch.amin(msgs, dim=-1), carry)
    if semiring == "min_label":
        return torch.minimum(torch.amin(s, dim=-1), carry)
    if semiring == "pr_sum":
        return torch.sum(s * w[None], dim=-1) + carry
    raise ValueError(semiring)


def _check(states, nbr, w, carry) -> tuple[int, int, int]:
    if states.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"states/w must be float32, got {states.dtype}/{w.dtype}")
    if carry.dtype != torch.float32 or nbr.dtype != torch.int32:
        raise TypeError(f"carry must be float32 and nbr int32, got {carry.dtype}/{nbr.dtype}")
    if states.ndim != 2 or nbr.ndim != 2:
        raise ValueError(f"states/nbr must be 2-D, got {tuple(states.shape)}/{tuple(nbr.shape)}")
    q, vp = states.shape
    v, d = nbr.shape
    if tuple(w.shape) != (v, d):
        raise ValueError(f"w shape {tuple(w.shape)} != nbr shape {(v, d)}")
    if vp < v + 1 or tuple(carry.shape) != (q, v):
        raise ValueError(
            f"need states [Q, >=V+1] and carry [Q, V]; got {tuple(states.shape)}, "
            f"{tuple(carry.shape)} for V={v}"
        )
    return q, v, d


def transpose_states(cur: torch.Tensor, identity: float) -> torch.Tensor:
    """The expand's states as the kernels read them: ``[V+1, Q]``, row ``v <
    V`` holding ``cur[:, v]`` and row ``V`` the reduce identity (the row
    padding cells point at).  One pass over ``cur``; equal to
    ``torch.cat([cur, identity column], 1).t()``."""
    q, v = cur.shape
    out = torch.empty((v + 1, q), dtype=cur.dtype, device=cur.device)
    out[:v].copy_(cur.t())
    out[v].fill_(identity)
    return out


def ell_spmv(
    states: torch.Tensor,
    nbr: torch.Tensor,
    w: torch.Tensor,
    carry: torch.Tensor,
    *,
    semiring: str = "min_plus",
    hop_cap: float = float("inf"),
    transposed: bool = False,
) -> torch.Tensor:
    """``out[q, v] = carry[q, v] ⊕ ⊕_d msg(states[q, nbr[v, d]], w[v, d])``.

    ``transposed``: ``states`` comes as ``[Vp, Q]``, the kernel's layout
    (the engine's path: :func:`transpose_states` builds it in one pass);
    otherwise the CUDA path makes one transposing copy.  CUDA tensors launch
    the kernel (built on first use); CPU tensors take the plain version.
    Anything else raises.
    """
    if semiring not in SEMIRINGS:
        raise ValueError(f"unknown semiring {semiring!r}")
    states_t = states if transposed else states.t()
    q, v, d = _check(states_t.t(), nbr, w, carry)
    devices = {t.device for t in (states_t, nbr, w, carry)}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return ell_spmv_ref(states_t, nbr, w, carry, semiring=semiring, hop_cap=hop_cap,
                            transposed=True)
    if dev.type != "cuda":
        raise ValueError(f"ell_spmv runs on cuda or cpu tensors, not {dev}")
    return _launch(states_t, nbr, w, carry, semiring, hop_cap, dev)


def _launch(states_t, nbr, w, carry, semiring, hop_cap, dev) -> torch.Tensor:
    (vp, q), (v, d) = states_t.shape, nbr.shape
    if max(q, vp, d) >= 2**31:
        raise ValueError("ell_spmv takes extents below 2**31")
    states_t, nbr, w, carry = (t.contiguous() for t in (states_t, nbr, w, carry))
    out = torch.empty((q, v), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ell_spmv_launch(
            states_t.data_ptr(), nbr.data_ptr(), w.data_ptr(), carry.data_ptr(),
            out.data_ptr(), q, v, d, vp, SEMIRINGS.index(semiring), float(hop_cap), stream,
        )
    if err != 0:
        raise RuntimeError(f"ell_spmv launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.ell_spmv_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
