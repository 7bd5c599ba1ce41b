"""Latest change point ≤ i per sorted store row (K4).

The port of ``repro/kernels/diff_lookup.py::diff_lookup``: for each row of
sorted, IMAX-padded iterations ``iters [N, S]`` with values ``vals [N, S]``,
the latest stored iteration ≤ ``qi`` and its value — ``diffstore.lookup_le``
on flattened rows.  It is the J store's lookup in VDC mode (twice per sweep
iteration, N = Q·E_cap, S = S_J) and the Det store's in
``dropping.latest_dropped_le`` (N = Q·V, S = S_d).

The CUDA kernel is ``csrc/diff_lookup.cu``; its note gives the bound and
the design.  The index is a ≤-count over the row, so a repeated iteration
resolves to its last repeat, and the value is a gather: the TPU body's
one-hot sum would turn a stored -0.0 into +0.0, the gather keeps it.

:func:`diff_lookup` launches the kernel for CUDA tensors and runs
:func:`diff_lookup_ref`, the plain PyTorch version, for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _tap

Tensor = torch.Tensor

SOURCE = "diff_lookup.cu"
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1

# kernel launches since the last reset
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def diff_lookup_ref(iters: Tensor, vals: Tensor, qi: Tensor | int) -> tuple[Tensor, Tensor, Tensor]:
    """Plain version: ``(val, iter, found)``, ``val`` 0 and ``iter`` -1
    where nothing is stored at or before ``qi``.  The counterpart of
    ``repro/kernels/ref.py::diff_lookup_ref``."""
    q = qi[:, None] if isinstance(qi, Tensor) else qi
    idx = (iters <= q).sum(dim=1) - 1
    found = idx >= 0
    safe = idx.clamp(min=0)[:, None]
    val = torch.gather(vals, 1, safe)[:, 0]
    it = torch.gather(iters, 1, safe)[:, 0]
    return torch.where(found, val, 0.0), torch.where(found, it, -1), found


def diff_lookup(iters: Tensor, vals: Tensor, qi: Tensor | int) -> tuple[Tensor, Tensor, Tensor]:
    """Per row, the latest change point at an iteration ≤ ``qi``.

    ``iters`` int32 ``[N, S]`` sorted ascending and IMAX-padded, ``vals``
    float32 ``[N, S]``, ``qi`` int32 ``[N]`` or one Python int for every
    row (passed to the kernel as a scalar).  Returns ``(val f32 [N], iter
    i32 [N], found bool [N])``.  CUDA tensors launch the kernel (built on
    first use); CPU tensors take the plain version (meta tensors too, for
    the outputs' shapes).  Anything else raises.  A counting run
    (``launch/hlo_analysis``) sees the kernel's bytes.
    """
    if iters.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError(f"iters/vals must be int32/float32, got {iters.dtype}/{vals.dtype}")
    if iters.ndim != 2 or tuple(vals.shape) != tuple(iters.shape):
        raise ValueError(f"need iters and vals of one shape [N, S]; got {tuple(iters.shape)}, "
                         f"{tuple(vals.shape)}")
    n = iters.shape[0]
    tensors = [iters, vals]
    if isinstance(qi, Tensor):
        if qi.dtype != torch.int32:
            raise TypeError(f"qi must be int32, got {qi.dtype}")
        if tuple(qi.shape) != (n,):
            raise ValueError(f"qi shape {tuple(qi.shape)} != {(n,)}")
        tensors.append(qi)
    elif not isinstance(qi, int) or not INT32_MIN <= qi <= INT32_MAX:
        raise TypeError(f"qi must be an int32 tensor [N] or an int in int32's range, got {qi!r}")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"diff_lookup runs on cuda or cpu tensors (meta: shapes), not {dev}")
    s = iters.shape[1]
    # its bound's bytes with a value gathered for every row: each row's S
    # iterations read, val + iter + found written
    if _tap.counting():
        _tap.tap_kernel("diff_lookup", 0.0, float(n * s * 4 + n * 4 + n * 9))
    if dev.type != "cuda":
        with _tap.uncounted():
            return diff_lookup_ref(iters, vals, qi)
    iters, vals = iters.contiguous(), vals.contiguous()
    qi_t = qi.contiguous() if isinstance(qi, Tensor) else None
    out_val = torch.empty(n, dtype=torch.float32, device=dev)
    out_iter = torch.empty(n, dtype=torch.int32, device=dev)
    out_found = torch.empty(n, dtype=torch.bool, device=dev)
    vec = int(s % 4 == 0 and iters.data_ptr() % 16 == 0)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.diff_lookup_launch(
            iters.data_ptr(), vals.data_ptr(), None if qi_t is None else qi_t.data_ptr(),
            0 if qi_t is not None else qi, out_val.data_ptr(), out_iter.data_ptr(),
            out_found.data_ptr(), n, s, vec, stream,
        )
    if err != 0:
        raise RuntimeError(f"diff_lookup launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out_val, out_iter, out_found


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.diff_lookup_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib
