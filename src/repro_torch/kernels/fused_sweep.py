"""Fused per-iteration maintenance kernel (the maintenance megakernel, K2).

The port of ``repro/kernels/fused_sweep.py::fused_sweep``.  One launch per
sweep iteration runs the whole per-vertex inner loop of the paper's
maintenance procedure:

    frontier expand over the ELL in-adjacency (Join + semiring reduce, all
    four semirings — the row body shared with :mod:`ell_spmv`)
      → DroppedVT probe (Det store rows or Bloom bits) → ``repair``
      → change-point detection vs the frozen pre-update store
      → per-query drop selection (the ``DropParams`` rows)
      → difference-store upsert (oldest eviction) / remove
      → Det-Drop register/unregister (det mode)
      → exact-front advance (``cur``)

The ``new=`` variant (VDC's partial fusion) takes the candidate ``new``
[Q, V] in place of the expand: the VDC engine aggregates the J store's
messages itself, and the kernel runs the stages after the expand.

The CUDA kernel is ``csrc/fused_sweep.cu``; its note gives the bound and the
design.  What stays outside, as in the reference: ``sched`` and the frontier
push, and the Bloom *insert* (prob mode: the engine folds ``to_drop`` and
``evicted`` into the filter).

:func:`fused_sweep` launches the kernel for CUDA tensors and runs
:func:`fused_sweep_ref`, the plain PyTorch version (the reference's kernel
body written with the port's store, drop and Bloom functions), for CPU
tensors.

Where the reference returns new stores, the port may update the working
stores in place (``inplace=True``: the D store, and the Det store in det
mode, are written where they change and come back as the outputs); the
engine does so from a sweep's second iteration on, when the working stores
are the sweep's own buffers and not its input state's.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch

from repro_torch.core import bloom as bloom_lib
from repro_torch.core import diffstore as ds
from repro_torch.core import dropping as dr
from repro_torch.kernels import _build
from repro_torch.kernels.ell_spmv import SEMIRINGS, ell_spmv_ref

Tensor = torch.Tensor

SOURCE = "fused_sweep.cu"
DROP_MODES = ("none", "det", "prob")
MAX_STORE_CAPACITY = 32  # S and S_d the CUDA kernel takes

# kernel launches since the last reset (the count a run reads to show that
# its main path went through the kernel)
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


class FusedOut(NamedTuple):
    """Per-vertex outputs of one fused sweep iteration ([Q, V], stores
    [Q, V, S]); the engine derives the stats and the next frontier from the
    masks."""

    d_iters: Tensor  # int32 [Q, V, S] — updated diff-store rows
    d_vals: Tensor  # f32  [Q, V, S]
    d_count: Tensor  # int32 [Q, V]
    cur: Tensor  # f32 [Q, V] — exact D_i (the advanced front)
    old: Tensor  # f32 [Q, V] — pre-update trajectory value at i
    stale: Tensor  # bool — old trajectory obscured by a dropped diff
    changed: Tensor  # bool — value differs from the old trajectory
    repair: Tensor  # bool — dropped change point recomputed at i
    to_store: Tensor  # bool — change point written at i
    to_drop: Tensor  # bool — change point dropped at i
    vanish: Tensor  # bool — stored change point cancelled at i
    evicted: Tensor  # bool — row shed its oldest point on insert
    evicted_iter: Tensor  # int32 — that row's column-0 iteration
    det_iters: Tensor | None = None  # int32 [Q, V, S_d] (det mode)
    det_count: Tensor | None = None  # int32 [Q, V]
    det_overflow: Tensor | None = None  # int32 [Q] — Det evictions per query
    det_max_iter: Tensor | None = None  # int32 [Q] — highest registered iteration (-1: none)


def fused_sweep_ref(
    i: int,
    sched: Tensor,
    active: Tensor,
    cur: Tensor,
    cur_old: Tensor,
    stale_old: Tensor,
    dstore: ds.DiffStore,
    old_dstore: ds.DiffStore,
    *,
    states: Tensor | None = None,
    nbr: Tensor | None = None,
    w: Tensor | None = None,
    kcarry: Tensor | None = None,
    new: Tensor | None = None,
    degree: Tensor | None = None,
    params: dr.DropParams | None = None,
    det: ds.DiffStore | None = None,
    bloom_bits: Tensor | None = None,
    bloom_hashes: int = 4,
    semiring: str = "min_plus",
    hop_cap: float = float("inf"),
    drop_mode: str = "none",
    inplace: bool = False,
    transposed: bool = False,
    off: int = 0,
    expand: Callable[..., Tensor] = ell_spmv_ref,
) -> FusedOut:
    """Plain version: the reference kernel body, stage for stage.

    Stages 2-5 repeat ``engine._stitched_step`` on purpose: the stitched
    path is what ``backend="fused"`` is held against, so neither is built
    from the other, and each stays an independent witness for the kernel.

    ``expand`` computes stage 1 unless ``new`` is given; a check on the
    card passes the ELL kernel's wrapper, whose expand is the CUDA kernel's
    own, so that ``pr_sum`` can be compared bit for bit.  ``inplace``
    computes the same and then copies the stores into ``dstore`` (and
    ``det``), which come back as the outputs; ``transposed`` as for
    :func:`fused_sweep`; ``off`` too.
    """
    if new is None:
        new = expand(states, nbr, w, kcarry, semiring=semiring, hop_cap=hop_cap,
                     transposed=transposed)
    q, v = sched.shape
    dev = sched.device
    v_ids = off + torch.arange(v, dtype=torch.int32, device=dev)[None, :]  # global ids
    q_ids = torch.arange(q, dtype=torch.int32, device=dev)[:, None]

    # ---- stage 2: DroppedVT probe → repair mask
    if drop_mode == "det":
        dropped_here = ds.has_at(det, i)
    elif drop_mode == "prob":
        flt = bloom_lib.BloomFilter(bloom_bits, bloom_hashes)
        dropped_here = bloom_lib.query(flt, v_ids, i, salt=q_ids)
    else:
        dropped_here = torch.zeros_like(sched)
    repair = dropped_here & active[:, None] & ~sched

    # ---- stage 3: change-point detection vs the frozen old trajectory
    old_has, old_val = ds.value_at(old_dstore, i)
    old_i = torch.where(old_has, old_val, cur_old)
    stale = (stale_old | dropped_here) & ~old_has
    changed = sched & ((new != old_i) | stale)

    # ---- stage 4: drop selection + diff-store append/remove
    want_point = sched & (new != cur)
    has_cur, cur_stored_val = ds.value_at(dstore, i)
    if drop_mode != "none":
        to_drop = want_point & dr.select_to_drop(params, degree[None, :], q_ids, v_ids, i)
        to_store = want_point & ~to_drop
    else:
        to_drop = torch.zeros_like(want_point)
        to_store = want_point
    out_store, evicted, evicted_iter = ds.upsert(dstore, i, to_store, new)
    vanish = sched & ~want_point & has_cur
    out_store = ds.remove_at(out_store, i, (to_drop & has_cur) | vanish)

    # ---- stage 5: exact-front advance
    cur_next = torch.where(sched | repair, new, torch.where(has_cur, cur_stored_val, cur))
    out = FusedOut(
        *out_store, cur_next, old_i, stale, changed, repair,
        to_store, to_drop, vanish, evicted, evicted_iter,
    )
    if drop_mode != "det":
        return _into(out, dstore, None) if inplace else out

    # ---- stage 6 (det): register the dropped and evicted points, then
    #      unregister what was stored or vanished
    zeros = torch.zeros(to_drop.shape, dtype=torch.float32, device=dev)
    det1, ev1, _ = ds.upsert(det, i, to_drop, zeros)
    det2, ev2, _ = ds.upsert(det1, evicted_iter, evicted, zeros)
    det3 = ds.remove_at(det2, i, to_store | vanish)
    hi1 = torch.where(to_drop, i, -1).amax(dim=-1)
    hi2 = torch.where(evicted, evicted_iter, -1).amax(dim=-1)
    out = out._replace(
        det_iters=det3.iters,
        det_count=det3.count,
        det_overflow=(ev1.sum(dim=-1) + ev2.sum(dim=-1)).to(torch.int32),
        det_max_iter=torch.maximum(hi1, hi2).to(torch.int32),
    )
    return _into(out, dstore, det) if inplace else out


def _into(out: FusedOut, dstore: ds.DiffStore, det: ds.DiffStore | None) -> FusedOut:
    """``out`` with its stores copied into ``dstore`` (and ``det``), which
    take their place."""
    # upsert's evicted_iter is a view of the input row's column 0: keep it
    out = out._replace(evicted_iter=out.evicted_iter.clone())
    dstore.iters.copy_(out.d_iters)
    dstore.vals.copy_(out.d_vals)
    dstore.count.copy_(out.d_count)
    out = out._replace(d_iters=dstore.iters, d_vals=dstore.vals, d_count=dstore.count)
    if det is None:
        return out
    det.iters.copy_(out.det_iters)
    det.count.copy_(out.det_count)
    return out._replace(det_iters=det.iters, det_count=det.count)


# --------------------------------------------------------------------------- the CUDA kernel
_PTRS = (
    "states_t", "nbr", "w", "kcarry", "new",
    "sched", "active", "cur", "cur_old", "stale_old",
    "d_iters", "d_vals", "d_count", "o_iters", "o_vals",
    "degree", "p", "tau_min", "tau_max", "degree_sel", "seed",
    "det_iters", "det_count", "bloom",
    "out_iters", "out_vals", "out_count", "out_cur", "out_old",
    "out_stale", "out_changed", "out_repair", "out_to_store", "out_to_drop",
    "out_vanish", "out_evicted", "out_evicted_iter",
    "out_det_iters", "out_det_count", "out_det_overflow", "out_det_max_iter",
)
_INTS = ("q", "v", "d", "s", "s_old", "s_det", "num_hashes", "i", "semiring", "mode", "vp",
         "inplace", "off")


class _FusedArgs(ctypes.Structure):
    """``struct FusedArgs`` of ``csrc/fused_sweep.cu``, field for field."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in _PTRS]
        + [("bloom_bits", ctypes.c_longlong)]
        + [(name, ctypes.c_int) for name in _INTS]
        + [("hop_cap", ctypes.c_float)]
    )


def _expect(name: str, t: Tensor | None, dtype: torch.dtype, shape: tuple) -> None:
    if t is None:
        raise ValueError(f"fused_sweep needs {name}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")


def _check(sched, active, cur, cur_old, stale_old, dstore, old_dstore, states_t, nbr, w,
           kcarry, new, degree, params, det, bloom_bits, drop_mode, inplace) -> list[Tensor]:
    """Validate every operand; returns the tensors to check for one device."""
    expand_ops = (states_t, nbr, w, kcarry)
    if (new is not None) == any(t is not None for t in expand_ops):
        raise ValueError("fused_sweep takes exactly one of new= or the expand's "
                         "states/nbr/w/kcarry")
    if sched.ndim != 2:
        raise ValueError(f"sched must be 2-D, got {tuple(sched.shape)}")
    q, v = sched.shape
    s, s_old = dstore.capacity, old_dstore.capacity
    f32, i32, b = torch.float32, torch.int32, torch.bool
    _expect("sched", sched, b, (q, v))
    _expect("active", active, b, (q,))
    for name, t in (("cur", cur), ("cur_old", cur_old)):
        _expect(name, t, f32, (q, v))
    _expect("stale_old", stale_old, b, (q, v))
    if new is not None:
        _expect("new", new, f32, (q, v))
        tensors = [new]
    else:
        if nbr is None or nbr.ndim != 2:
            raise ValueError(f"nbr must be 2-D, got {None if nbr is None else tuple(nbr.shape)}")
        d = nbr.shape[1]
        _expect("kcarry", kcarry, f32, (q, v))
        _expect("nbr", nbr, i32, (v, d))
        _expect("w", w, f32, (v, d))
        if (states_t is None or states_t.dtype != f32 or states_t.ndim != 2
                or states_t.shape[1] != q or states_t.shape[0] < v + 1):
            got = None if states_t is None else (states_t.dtype, tuple(states_t.t().shape))
            raise ValueError(f"states must be float32 [Q, >=V+1], got {got}")
        tensors = [kcarry, states_t, nbr, w]
    _expect("dstore.iters", dstore.iters, i32, (q, v, s))
    _expect("dstore.vals", dstore.vals, f32, (q, v, s))
    _expect("dstore.count", dstore.count, i32, (q, v))
    _expect("old_dstore.iters", old_dstore.iters, i32, (q, v, s_old))
    _expect("old_dstore.vals", old_dstore.vals, f32, (q, v, s_old))
    tensors += [sched, active, cur, cur_old, stale_old, *dstore, old_dstore.iters, old_dstore.vals]
    if inplace and any(_shares(x, y) for x in dstore for y in old_dstore):
        raise ValueError("fused_sweep(inplace=True) would write into old_dstore: dstore shares "
                         "its storage")
    if drop_mode == "none":
        return tensors
    _expect("degree", degree, f32, (v,))
    if params is None:
        raise ValueError("fused_sweep needs params in a drop mode")
    for name in ("p", "tau_min", "tau_max"):
        _expect(f"params.{name}", getattr(params, name), f32, (q,))
    _expect("params.degree_sel", params.degree_sel, b, (q,))
    _expect("params.seed", params.seed, torch.int64, (q,))
    tensors += [degree, *params]
    if drop_mode == "det":
        if det is None:
            raise ValueError("fused_sweep needs det in det mode")
        _expect("det.iters", det.iters, i32, (q, v, det.capacity))
        _expect("det.count", det.count, i32, (q, v))
        return tensors + [det.iters, det.count]
    if bloom_bits is None or bloom_bits.ndim != 2:
        raise ValueError("fused_sweep needs bloom_bits [Q, M] in prob mode")
    _expect("bloom_bits", bloom_bits, b, (q, bloom_bits.shape[1]))
    return tensors + [bloom_bits]


def _shares(x: Tensor, y: Tensor) -> bool:
    """Do two (nonempty) tensors lie in one storage?"""
    return (x.numel() > 0 and y.numel() > 0
            and x.untyped_storage().data_ptr() == y.untyped_storage().data_ptr())


def fused_sweep(
    i: int,
    sched: Tensor,
    active: Tensor,
    cur: Tensor,
    cur_old: Tensor,
    stale_old: Tensor,
    dstore: ds.DiffStore,
    old_dstore: ds.DiffStore,
    *,
    states: Tensor | None = None,
    nbr: Tensor | None = None,
    w: Tensor | None = None,
    kcarry: Tensor | None = None,
    new: Tensor | None = None,
    degree: Tensor | None = None,
    params: dr.DropParams | None = None,
    det: ds.DiffStore | None = None,
    bloom_bits: Tensor | None = None,
    bloom_hashes: int = 4,
    semiring: str = "min_plus",
    hop_cap: float = float("inf"),
    drop_mode: str = "none",
    inplace: bool = False,
    transposed: bool = False,
    off: int = 0,
) -> FusedOut:
    """One fused maintenance iteration: a single kernel launch.

    Exactly one of two forms: ``states`` [Q, >=V+1] (the identity in column
    V), ``nbr``/``w`` [V, D] and ``kcarry`` [Q, V] feed the in-kernel expand
    (JOD), or ``new`` [Q, V] is the candidate computed outside (VDC: the
    aggregate over the J store's messages).  ``transposed``: ``states``
    comes as [>=V+1, Q], the kernel's layout (the engine builds it so in
    one pass); otherwise the card's path makes one transposing copy.
    ``degree`` [V] (f32 total degree) and ``params`` feed the drop
    selection; ``det`` (det mode) or ``bloom_bits`` bool [Q, M] (prob mode)
    is the DroppedVT.  ``off`` is the global id of row 0 (a vertex-sharded
    sweep passes its shard's block): the drop coin and the Bloom key hash
    global ids, while rows, stores and ``degree`` stay local.

    ``inplace``: the outputs' stores are ``dstore`` (and ``det``) themselves,
    updated where they change; it raises if ``dstore`` shares storage with
    ``old_dstore``, which must stay frozen.  Otherwise they are new tensors
    and the inputs stay as they were.

    CUDA tensors launch the kernel (built on first use); CPU tensors take
    the plain version.  Anything else raises.
    """
    if semiring not in SEMIRINGS:
        raise ValueError(f"unknown semiring {semiring!r}")
    if drop_mode not in DROP_MODES:
        raise ValueError(f"unknown drop mode {drop_mode!r}")
    states_t = states if states is None or transposed else states.t()
    tensors = _check(sched, active, cur, cur_old, stale_old, dstore, old_dstore, states_t, nbr,
                     w, kcarry, new, degree, params, det, bloom_bits, drop_mode, inplace)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    kw = dict(nbr=nbr, w=w, kcarry=kcarry, new=new, degree=degree, params=params,
              det=det, bloom_bits=bloom_bits, bloom_hashes=bloom_hashes,
              semiring=semiring, hop_cap=hop_cap, drop_mode=drop_mode, inplace=inplace, off=off)
    if off < 0 or off + sched.shape[1] > 2**31 - 1:
        raise ValueError(f"fused_sweep takes global vertex ids below 2**31, got off={off}")
    if dev.type == "cpu":
        return fused_sweep_ref(i, sched, active, cur, cur_old, stale_old, dstore, old_dstore,
                               states=states_t, transposed=True, **kw)
    if dev.type != "cuda":
        raise ValueError(f"fused_sweep runs on cuda or cpu tensors, not {dev}")
    return _launch(i, sched, active, cur, cur_old, stale_old, dstore, old_dstore, dev,
                   states_t=states_t, **kw)


def _launch(i, sched, active, cur, cur_old, stale_old, dstore, old_dstore, dev, *, states_t,
            nbr, w, kcarry, new, degree, params, det, bloom_bits, bloom_hashes, semiring,
            hop_cap, drop_mode, inplace, off) -> FusedOut:
    q, v = sched.shape
    s = dstore.capacity
    s_det = det.capacity if drop_mode == "det" else 0
    if max(s, s_det) > MAX_STORE_CAPACITY:
        raise ValueError(
            f"the fused_sweep kernel takes store capacities up to {MAX_STORE_CAPACITY}, "
            f"got S={s}, S_d={s_det}"
        )
    if max(q * v * max(s, s_det, old_dstore.capacity), 0 if new is not None else states_t.numel()) >= 2**62:
        raise ValueError("fused_sweep extents too large")
    if new is None and states_t.shape[0] >= 2**31:
        raise ValueError("fused_sweep takes state rows below 2**31")
    m_bits = bloom_bits.shape[1] if drop_mode == "prob" else 0
    if m_bits >= 2**32:
        raise ValueError("fused_sweep takes Bloom rows below 2**32 bits")
    stores = [*dstore] + ([det.iters, det.count] if drop_mode == "det" else [])
    if inplace and not all(t.is_contiguous() for t in stores):
        raise ValueError("fused_sweep(inplace=True) writes into contiguous stores only")

    def empty(*shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    i32, f32, b = torch.int32, torch.float32, torch.bool
    if inplace:
        d_out = tuple(dstore)
    else:
        d_out = (empty(q, v, s, dtype=i32), empty(q, v, s, dtype=f32), empty(q, v, dtype=i32))
    out = FusedOut(
        *d_out,
        empty(q, v, dtype=f32), empty(q, v, dtype=f32),
        *(empty(q, v, dtype=b) for _ in range(7)),
        empty(q, v, dtype=i32),
    )
    if drop_mode == "det":
        out = out._replace(
            det_iters=det.iters if inplace else empty(q, v, s_det, dtype=i32),
            det_count=det.count if inplace else empty(q, v, dtype=i32),
            det_overflow=torch.zeros(q, dtype=i32, device=dev),
            det_max_iter=torch.full((q,), -1, dtype=i32, device=dev),
        )
    # the tensors behind the pointers, alive until the launch returns
    if new is not None:
        keep = {"new": new.contiguous()}
    else:
        keep = {
            "states_t": states_t.contiguous(),  # [Vp, Q]: one sector per gathered vertex
            "nbr": nbr.contiguous(), "w": w.contiguous(), "kcarry": kcarry.contiguous(),
        }
    keep.update({
        "sched": sched.contiguous(), "active": active.contiguous(),
        "cur": cur.contiguous(), "cur_old": cur_old.contiguous(),
        "stale_old": stale_old.contiguous(),
        "d_iters": dstore.iters.contiguous(), "d_vals": dstore.vals.contiguous(),
        "d_count": dstore.count.contiguous(),
        "o_iters": old_dstore.iters.contiguous(), "o_vals": old_dstore.vals.contiguous(),
    })
    if drop_mode != "none":
        keep.update(degree=degree.contiguous(),
                    **{f: getattr(params, f).contiguous() for f in dr.DropParams._fields})
    if drop_mode == "det":
        keep.update(det_iters=det.iters.contiguous(), det_count=det.count.contiguous())
    if drop_mode == "prob":
        keep["bloom"] = bloom_bits.contiguous()
    for f in FusedOut._fields:
        if getattr(out, f) is not None:
            keep[f"out_{f[2:] if f.startswith('d_') else f}"] = getattr(out, f)
    args = _FusedArgs(
        **{name: keep[name].data_ptr() if name in keep else None for name in _PTRS},
        bloom_bits=m_bits, q=q, v=v, d=0 if new is not None else nbr.shape[1], s=s,
        s_old=old_dstore.capacity, s_det=s_det, num_hashes=int(bloom_hashes), i=int(i),
        semiring=SEMIRINGS.index(semiring), mode=DROP_MODES.index(drop_mode),
        vp=0 if new is not None else states_t.shape[0], inplace=int(inplace), off=int(off),
        hop_cap=float(hop_cap),
    )
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.fused_sweep_launch(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_sweep launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.fused_sweep_launch
    fn.argtypes = [ctypes.POINTER(_FusedArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
