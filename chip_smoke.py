#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py        # from the repo root; needs one CUDA device and nvcc

Phases, each printing one JSON line (any failure raises and exits nonzero):

1. ``env``     torch/CUDA versions, the card, its power limit.
2. ``build``   every CUDA source under ``src/repro_torch/kernels/csrc/``
               compiled by ``nvcc`` (one process each, all started together).
               ``flash_sass``: tensor-core instructions (HMMA / HGMMA) per
               kernel of the built ``flash_attn`` library (``cuobjdump
               -sass``); the bf16 prefill kernels must have them.
3. ``kernel_small``  each kernel against its plain PyTorch version at ragged
               small shapes: ``ell_spmv`` for the four semirings (min family
               bit-exact, ``pr_sum`` at rtol 1e-6); ``fused_sweep`` for four
               semirings x three drop modes on random stores with full rows,
               padding and repeated iterations (every output bit-equal;
               ``pr_sum``'s plain version takes the ELL kernel's expand,
               which is the same device code); ``bloom_query`` bit-equal;
               ``diff_lookup`` bit-equal.  ``kernel_small_flash``: K5
               (``flash_attention``) against its plain version at head
               dims 16, 64 and 128 over causal and not, GQA/MQA, ragged
               Sq/Sk, decode rows, bf16 and f32, contiguous and strided k/v
               (288 cases; float32: 2e-5 absolute; bfloat16: 2^-6 of each
               output row's largest value).
4. ``main``    the slice at real size: 8 SSSP queries
               (``repro_torch.core.queries.sssp``, ``backend="ell"``,
               ``max_iters=48``, ``batch_capacity=32``, S=16) on a uniform
               directed graph at the size of SNAP cit-Patents (3,774,768
               vertices, 16,518,948 edges, weights 1..10, split 90/10), fed
               256 updates with 20% deletes in chunks of 32 through
               ``apply_updates_batched`` (chunk 0 is warm-up); launch counts
               are zeroed just before and read just after.  The answers must
               equal SCRATCH on the final graph bit for bit.  One more chunk
               runs under ``torch.profiler`` for the device-busy share.
5. ``main_fused``  (one line per run) the same graph, sources and stream on
               ``backend="fused"`` with no dropping, Det-Drop and Prob-Drop
               (``benchmarks/common.py``'s ``DROP_DEGREE`` policy; 2**26
               Bloom bits a query): answers equal SCRATCH, one
               ``fused_sweep`` launch per sweep iteration and no
               ``ell_spmv``, ``none`` leaf-equal to the ``main`` engine;
               throughput, latency, accounted bytes split into differences
               and DroppedVT, device memory, one profiled chunk.
6. ``parity_fused``  ``ell`` against ``fused`` at V = 2**16 for the four
               semirings x three drop modes: every state leaf and stat.
7. ``main_lm``  llama3.2-1b serving at its published widths in bf16
               (weights from a seeded generator): ``make_prefill`` on 8 x
               4096 tokens, 64 greedy ``make_decode`` steps, then
               ``lm_serve`` at the CLI defaults on ``arch.full()``; K5's
               launches must equal layers x calls; prefill tokens/s, decode
               step p50/p99, peak memory, one profiled prefill and decode
               step, and the plain path (attention through
               ``chunked_attention``) teacher-forced on the same tokens,
               picking the kernel path's token at least 0.9 of the time.
               ``main_lm_long``: prefill 1 x 32768, then 16 decode steps at
               batch 32 against a 32768-position cache from the generator,
               held to the same floor.
               ``main_lm_f32``: full width in float32, TF32 off, 2 x 1024
               and 8 steps; logits within 1e-4 of the plain path's.
8. ``kernel_real``  each kernel against its plain version at the main
               path's shapes, timed with CUDA events, beside its bound:
               ``ell_spmv`` on the ``main`` engine's ELL arrays (for
               ``pr_sum`` also one ``torch.sparse.mm`` over the same CSR);
               ``fused_sweep`` on one captured call of each ``main_fused``
               run (the function's bound, counted on that call's data, and
               beside it the floor of this design's out-of-place stores);
               ``bloom_query`` on the prob run's filter, packed, also
               held against ``core.bloom.query`` for every (v, i) probe of
               one query; ``diff_lookup`` on the J and Det stores;
               ``flash_attention`` on the first prefill and decode call of
               ``main_lm`` and ``main_lm_long``, whose operands are kept by
               running those two calls again after the timed run, and on
               random bf16 operands at head dims 128 (qwen2-moe's 16/16
               heads at 8 x 4096 and a 32 x 32,753-key cache view;
               qwen2-72b's 64/8 at 1 x 4096) and 16 (the smoke config's
               4/2 at 8 x 4096, prefill and decode); the float32 forms on
               ``main_lm_f32``'s first calls and at D = 128 and 16 (bound
               at the float32 rate); each called twice and
               bit-equal (bound: bf16 tensor-core operations or bytes;
               ``scaled_dot_product_attention`` timed as a yardstick only;
               beside the CUDA-event time each call's device time with
               the calls queued back to back, which leaves out host gaps).
9. ``other_semirings``  K-hop (k=6) and PageRank (10 rounds) at V = 2**16
               with short batched streams, against SCRATCH.

Then the ``kernels`` line, the card's ``nvidia-smi`` name and power limit,
and last ``{"ok": true, "device": {...}}``.  There is no CPU path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "chip_smoke"  # the profiled chunks' Chrome traces

# SNAP cit-Patents: |V| and |E|
PATENTS_V = 3_774_768
PATENTS_E = 16_518_948
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
SEED = 0


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# --------------------------------------------------------------------------- data
def uniform_edges(num_vertices: int, num_edges: int, rng) -> np.ndarray:
    """``[E, 3]`` int64 (u, v, w): distinct directed pairs without self loops,
    weights uniform in 1..10 — ``graphgen.uniform_graph``'s distribution,
    drawn in bulk."""
    keys = np.zeros(0, np.int64)
    while keys.shape[0] < num_edges:
        m = int((num_edges - keys.shape[0]) * 1.02) + 64
        u = rng.integers(0, num_vertices, size=m, dtype=np.int64)
        v = rng.integers(0, num_vertices, size=m, dtype=np.int64)
        cand = np.concatenate([keys, (u * num_vertices + v)[u != v]])
        _, first = np.unique(cand, return_index=True)
        keys = cand[np.sort(first)]  # first occurrences, in draw order
    keys = keys[:num_edges]
    w = rng.integers(1, 11, size=num_edges, dtype=np.int64)
    return np.stack([keys // num_vertices, keys % num_vertices, w], axis=1)


def split_and_stream(edges: np.ndarray, num_updates: int, delete_fraction: float, rng):
    """90/10 split as ``graphgen.split_90_10``; the stream deletes random
    distinct initial edges and inserts held-out ones, in the paper's
    ``(u, v, label, w, ±1)`` form."""
    order = rng.permutation(edges.shape[0])
    cut = int(edges.shape[0] * 0.9)
    initial, pool = edges[order[:cut]], edges[order[cut:]]
    is_del = rng.random(num_updates) < delete_fraction
    dels = initial[rng.choice(cut, size=int(is_del.sum()), replace=False)]
    ins = pool[: num_updates - dels.shape[0]]
    stream, di, ii = [], 0, 0
    for d in is_del:
        if d:
            u, v, w = (int(x) for x in dels[di])
            stream.append((u, v, 0, float(w), -1))
            di += 1
        else:
            u, v, w = (int(x) for x in ins[ii])
            stream.append((u, v, 0, float(w), +1))
            ii += 1
    return initial, stream


def pick_sources(graph, count: int, rng) -> list[int]:
    has_out = np.nonzero(graph.out_degree > 0)[0]
    return [int(x) for x in rng.choice(has_out, size=count, replace=False)]


def device_busy(prof, path: Path, k5: bool = False) -> dict:
    """Device-busy time of a profiled window from its Chrome trace (kernels,
    copies and sets on the card), plus the top kernels by time and, with
    ``k5``, the time of K5's kernels."""
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    by_name: dict[str, float] = {}
    busy = 0.0
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            busy += float(ev["dur"])
            key = ev["name"][:80]
            by_name[key] = by_name.get(key, 0.0) + float(ev["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"device_busy_ms": busy / 1e3, "top_device_ms": {k: v / 1e3 for k, v in top}}
    if k5:  # every K5 kernel's time, not only the top names'
        out["flash_attention_ms"] = sum(t for k, t in by_name.items() if "flash_attn" in k) / 1e3
    return out


# --------------------------------------------------------------------------- kernel checks
def ell_inputs(rng, q, v, d, semiring, device):
    import torch

    nbr = rng.integers(0, v + 1, size=(v, d)).astype(np.int32)
    w = rng.integers(1, 10, size=(v, d)).astype(np.float32)
    if semiring == "pr_sum":
        states = np.concatenate([rng.random((q, v), np.float32), np.zeros((q, 1), np.float32)], 1)
        carry = np.full((q, v), 0.15, np.float32)
    else:
        states = np.concatenate(
            [rng.random((q, v), np.float32) * 10, np.full((q, 1), np.inf, np.float32)], 1
        )
        carry = rng.random((q, v)).astype(np.float32) * 10
    return [torch.from_numpy(x).to(device) for x in (states, nbr, w, carry)]


IMAX = 2**31 - 1


def random_store(rng, q, v, s, max_iter):
    """Sorted IMAX-padded store rows: about 30% full, the rest ragged, a few
    with a repeated iteration (the store ops take the first match), values
    small integers so that candidates tie with stored points."""
    iters = np.full((q, v, s), IMAX, np.int64)
    count = np.where(rng.random((q, v)) < 0.3, s, rng.integers(0, s + 1, size=(q, v)))
    pts = np.sort(rng.random((q, v, max(max_iter, s))).argsort(-1)[..., :s] + 1, axis=-1)
    dup = rng.random((q, v)) < 0.05
    pts[dup, 1:] = pts[dup, :-1]  # [a, a, b, ...]: still sorted
    live = np.arange(s)[None, None, :] < count[..., None]
    iters[live] = pts[live]
    vals = np.where(live, rng.integers(0, 7, size=(q, v, s)), 0).astype(np.float32)
    return iters.astype(np.int32), vals, count.astype(np.int32)


def fused_inputs(rng, q, v, d, s, semiring, drop_mode, device, *, s_det=None, m_bits=1 << 10):
    """Random operands of one ``fused_sweep`` call, as (args, kwargs)."""
    import torch

    from repro_torch.core import diffstore as ds
    from repro_torch.core import dropping as dr

    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    i = 5
    nbr = rng.integers(0, v + 1, size=(v, d)).astype(np.int32)
    w = rng.integers(1, 4, size=(v, d)).astype(np.float32)
    if semiring == "pr_sum":
        states = np.concatenate([rng.random((q, v), np.float32), np.zeros((q, 1), np.float32)], 1)
        cur = rng.random((q, v)).astype(np.float32)
        kcarry = np.full((q, v), 0.15, np.float32)
    else:
        states = np.concatenate(
            [rng.integers(0, 6, size=(q, v)).astype(np.float32), np.full((q, 1), np.inf, np.float32)], 1
        )
        cur = rng.integers(0, 7, size=(q, v)).astype(np.float32)
        kcarry = cur
    max_iter = max(12, s + 4)
    args = (
        i,
        t(rng.random((q, v)) < 0.5),  # sched
        t(np.r_[True, rng.random(q - 1) < 0.7]),  # active
        t(cur),
        t(rng.integers(0, 7, size=(q, v)).astype(np.float32)),  # cur_old
        t(rng.random((q, v)) < 0.2),  # stale_old
        ds.DiffStore(*map(t, random_store(rng, q, v, s, max_iter))),
        ds.DiffStore(*map(t, random_store(rng, q, v, s, max_iter))),
    )
    hop_cap = 4.0 if semiring == "min_hop" else float("inf")
    kw = dict(states=t(states), nbr=t(nbr), w=t(w), kcarry=t(kcarry), semiring=semiring,
              hop_cap=hop_cap, drop_mode=drop_mode)
    if drop_mode != "none":
        seeds = rng.integers(0, 2**32, size=q)
        seeds[0] = 2**32 - 1
        kw["degree"] = t(rng.integers(0, 30, size=v).astype(np.float32))
        kw["params"] = dr.DropParams(
            p=t(rng.uniform(0.2, 0.8, size=q).astype(np.float32)),
            tau_min=t(rng.integers(2, 6, size=q).astype(np.float32)),
            tau_max=t(np.where(rng.random(q) < 0.5, np.inf, rng.integers(10, 26, size=q)).astype(np.float32)),
            degree_sel=t(rng.random(q) < 0.5),
            seed=t(seeds.astype(np.int64)),
        )
    if drop_mode == "det":
        it, _, co = random_store(rng, q, v, s_det or min(32, 2 * s), max_iter)
        kw["det"] = ds.DiffStore(t(it), torch.zeros(it.shape, dtype=torch.float32, device=device), t(co))
    if drop_mode == "prob":
        kw["bloom_bits"] = t(rng.random((q, m_bits)) < 0.5)
        kw["bloom_hashes"] = 3
    return args, kw


def lookup_inputs(rng, n: int, s: int, device):
    """Random sorted IMAX-padded rows for ``diff_lookup``: ragged counts,
    repeated iterations, values with -0.0 among them, and per-row query
    iterations below, at, between and above the row's points (and IMAX)."""
    import torch

    count = np.where(rng.random(n) < 0.3, s, rng.integers(0, s + 1, size=n))
    pts = np.sort(rng.integers(0, 40, size=(n, s)), axis=1)  # repeats on purpose
    live = np.arange(s)[None, :] < count[:, None]
    iters = np.where(live, pts, IMAX).astype(np.int32)
    vals = rng.integers(-3, 4, size=(n, s)).astype(np.float32)
    vals[rng.random((n, s)) < 0.1] = -0.0
    pick = iters[np.arange(n), rng.integers(0, s, size=n)].astype(np.int64)
    kind = rng.integers(0, 5, size=n)
    qi = np.select([kind == 0, kind == 1, kind == 2, kind == 3],
                   [np.minimum(pick, 2**31 - 2) - 1, pick, pick + 1, np.full(n, -5)], np.full(n, 2**31 - 2))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    return t(iters), t(vals), t(np.clip(qi, -(2**31), 2**31 - 1).astype(np.int32))


def same_lookup(got, want) -> float:
    """Raise unless two ``diff_lookup`` results are bit-equal (values
    compared as bit patterns, so -0.0 differs from +0.0)."""
    import torch

    gv, gi, gf = got
    wv, wi, wf = want
    if not (torch.equal(gv.view(torch.int32), wv.view(torch.int32)) and torch.equal(gi, wi)
            and torch.equal(gf, wf)):
        raise AssertionError("diff_lookup differs from its plain version")
    return max(max_abs_diff(gv, wv), max_abs_diff(gi, wi), max_abs_diff(gf, wf))


def max_abs_diff(got, want) -> float:
    """Largest ``|got - want|`` over the cells where the two differ (0.0 when
    every cell is equal, infinities included); a bool counts as 0 or 1."""
    ne = got != want
    if not bool(ne.any()):
        return 0.0
    return float((got[ne].double() - want[ne].double()).abs().max())


def same_fused(got, want) -> float:
    """Raise unless two ``FusedOut`` agree in every output, bit for bit;
    returns the largest absolute difference over all outputs."""
    err = 0.0
    for name, g, w in zip(got._fields, got, want):
        if (g is None) != (w is None):
            raise AssertionError(f"fused_sweep output {name}: present in one version only")
        if g is None:
            continue
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"fused_sweep output {name}: {g.dtype}{list(g.shape)} against "
                                 f"the plain version's {w.dtype}{list(w.shape)}")
        err = max(err, max_abs_diff(g, w))
        if err != 0.0:
            bad = int((g != w).sum())
            raise AssertionError(f"fused_sweep output {name} differs from the plain version ({bad} cells)")
    return err


def compare(semiring, got, want) -> float:
    """Raise unless the kernel agrees with its plain version; returns the
    max abs difference (over finite cells)."""
    import torch

    if semiring == "pr_sum":
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    elif not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"{semiring}: kernel differs from plain version in {bad} cells")
    finite = torch.isfinite(want)
    return float((got[finite] - want[finite]).abs().max()) if bool(finite.any()) else 0.0


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event-timed calls, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def ell_bound_ms(q: int, v: int, d: int, semiring: str) -> float:
    """Least time for one ELL SpMV: each input read once, the output written
    once (w only where the semiring reads it), against the float32 rate for
    one msg + one reduce per cell."""
    uses_w = semiring in ("min_plus", "pr_sum")
    nbytes = v * d * 4 * (2 if uses_w else 1) + q * (v + 1) * 4 + 2 * q * v * 4
    ops = 2 * q * v * d
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def kernel_small(device) -> dict:
    """Every kernel against its plain version at ragged small shapes."""
    import torch

    from repro_torch.kernels import bloom as K3
    from repro_torch.kernels import diff_lookup as K4
    from repro_torch.kernels import ell_spmv as K1
    from repro_torch.kernels import fused_sweep as K2

    rng = np.random.default_rng(SEED)
    err1 = 0.0
    for semiring in K1.SEMIRINGS:
        cap = 4.0 if semiring == "min_hop" else float("inf")
        for q, v, d in [(1, 16, 4), (3, 100, 8), (2, 257, 16), (4, 128, 32)]:
            args = ell_inputs(rng, q, v, d, semiring, device)
            got = K1.ell_spmv(*args, semiring=semiring, hop_cap=cap)
            err1 = max(err1, compare(semiring, got, K1.ell_spmv_ref(*args, semiring=semiring, hop_cap=cap)))

    # K2: all outputs bit-equal; pr_sum's plain version takes the ELL
    # kernel's expand (the same device code), and that expand is held
    # against the plain sum at rtol 1e-6
    cases2, err2, expand_err = 0, 0.0, 0.0
    for q, v, d, s in [(1, 16, 4, 4), (3, 100, 8, 16), (2, 257, 16, 16)]:
        for semiring in K1.SEMIRINGS:
            for mode in K2.DROP_MODES:
                args, kw = fused_inputs(rng, q, v, d, s, semiring, mode, device)
                got = K2.fused_sweep(*args, **kw)
                if semiring == "pr_sum":
                    ops = [kw[k] for k in ("states", "nbr", "w", "kcarry")]
                    expand_err = max(expand_err, compare(
                        semiring, K1.ell_spmv(*ops, semiring=semiring),
                        K1.ell_spmv_ref(*ops, semiring=semiring)))
                    want = K2.fused_sweep_ref(*args, **kw, expand=K1.ell_spmv)
                else:
                    want = K2.fused_sweep_ref(*args, **kw)
                err2 = max(err2, same_fused(got, want))
                cases2 += 1

    # K2's new= variant (VDC): the candidate comes in, nothing depends on
    # the semiring, so one case per drop mode and shape
    cases2n, err2n = 0, 0.0
    for q, v, d, s in [(1, 16, 4, 4), (3, 100, 8, 16), (2, 257, 16, 16), (3, 131, 8, 32)]:
        for mode in K2.DROP_MODES:
            args, kw = fused_inputs(rng, q, v, d, s, "min_plus", mode, device)
            for k in ("states", "nbr", "w", "kcarry"):
                del kw[k]
            kw["new"] = torch.from_numpy(rng.integers(0, 7, size=(q, v)).astype(np.float32)).to(device)
            err2n = max(err2n, same_fused(K2.fused_sweep(*args, **kw), K2.fused_sweep_ref(*args, **kw)))
            cases2n += 1

    # K4: ragged N (no multiple of the 256-thread block), S from 1 to 32
    # (6 takes the scalar loads), per-row and scalar query iterations
    cases4, err4 = 0, 0.0
    for n, s in [(1, 1), (1000, 1), (777, 6), (4097, 8), (300, 32)]:
        iters, vals, qi = lookup_inputs(rng, n, s, device)
        for q_arg in (qi, 7, int(iters[0, 0]) if n else 0, -1, 2**31 - 1):
            err4 = max(err4, same_lookup(K4.diff_lookup(iters, vals, q_arg), K4.diff_lookup_ref(iters, vals, q_arg)))
            cases4 += 1

    cases3, err3 = 0, 0.0
    for q, n, mbits, k in [(1, 64, 1 << 10, 2), (3, 500, 1 << 12, 4), (2, 1024, 1 << 14, 6)]:
        t = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
        words = K3.pack_bits(t(rng.random((q, mbits)) < 0.4))
        v = t(rng.integers(0, 2**31 - 1, size=(q, n)).astype(np.int32))
        it = t(rng.integers(0, 64, size=(q, n)).astype(np.int32))
        salt = torch.arange(q, dtype=torch.int32, device=device)
        got = K3.bloom_query(words, v, it, salt, num_hashes=k)
        want = K3.bloom_query_ref(words, v, it, salt, num_hashes=k)
        err3 = max(err3, max_abs_diff(got, want))
        if not torch.equal(got, want):
            raise AssertionError("bloom_query differs from its plain version")
        cases3 += 1
    torch.cuda.synchronize()
    return {
        "ell_spmv": {"max_abs_err": err1, "semirings": list(K1.SEMIRINGS)},
        "fused_sweep": {"cases": cases2, "bit_equal": True, "max_abs_err": err2,
                        "pr_sum_expand_max_abs_err": expand_err},
        "fused_sweep_new": {"cases": cases2n, "bit_equal": True, "max_abs_err": err2n},
        "diff_lookup": {"cases": cases4, "bit_equal": True, "max_abs_err": err4},
        "bloom_query": {"cases": cases3, "bit_equal": True, "max_abs_err": err3},
    }


def kernel_real(eng, rng) -> dict:
    """The kernel at the main path's shapes: the engine's own ELL arrays and
    its answers as states."""
    import torch

    from repro_torch.core import engine as E
    from repro_torch.core.semiring import pagerank
    from repro_torch.kernels import ell_spmv as K

    g, cur = eng.g, eng.state.cur
    q, v = cur.shape
    d = g.ell_width
    out = {}
    for semiring in K.SEMIRINGS:
        if semiring == "pr_sum":
            pr_cfg = E.EngineConfig(
                num_queries=q, num_vertices=v, max_iters=1,
                semiring=pagerank(),
                weight_from_degree=True, backend="ell",
            )
            w = E._ell_weights(pr_cfg, g)
            body = torch.from_numpy(rng.random((q, v), np.float32)).to(cur.device)
            states = torch.cat([body, torch.zeros((q, 1), device=cur.device)], 1)
            carry = torch.full((q, v), 0.15, device=cur.device)
        else:
            w = g.ell_w
            states = torch.cat([cur, torch.full((q, 1), float("inf"), device=cur.device)], 1)
            carry = cur
        cap = 6.0 if semiring == "min_hop" else float("inf")
        call = lambda: K.ell_spmv(states, g.nbr, w, carry, semiring=semiring, hop_cap=cap)  # noqa: E731
        plain = lambda: K.ell_spmv_ref(states, g.nbr, w, carry, semiring=semiring, hop_cap=cap)  # noqa: E731
        got = call()
        err = compare(semiring, got, plain())
        row = {
            "max_abs_err": err,
            "ms": time_ms(call),
            "plain_ms": time_ms(plain, reps=5),
            "bound_ms": ell_bound_ms(q, v, d, semiring),
            "library_ms": None,
        }
        if semiring == "pr_sum":
            row["library_ms"], lib_err = sparse_mm_yardstick(states, g.nbr, w, carry, got)
            row["library_max_abs_err"] = lib_err
        out[semiring] = row
        del got
        torch.cuda.empty_cache()
    return out


def sparse_mm_yardstick(states, nbr, w, carry, kernel_out):
    """Time one ``torch.sparse.mm`` computing the pr_sum SpMV over the same
    adjacency as CSR (padding cells dropped).  A yardstick only: the port
    never calls it."""
    import torch

    v, d = nbr.shape
    nbr, order = torch.sort(nbr, dim=1)  # CSR wants sorted columns; padding (== V) sorts last
    w = torch.gather(w, 1, order)
    live = nbr < v
    counts = live.sum(dim=1)
    crow = torch.zeros(v + 1, dtype=torch.int64, device=nbr.device)
    crow[1:] = torch.cumsum(counts, 0)
    a = torch.sparse_csr_tensor(
        crow, nbr[live].long(), w[live], size=(v, states.shape[1]), check_invariants=True
    )
    dense = states.t().contiguous()  # [Vp, Q]
    ms = time_ms(lambda: torch.sparse.mm(a, dense))
    res = torch.sparse.mm(a, dense).t() + carry
    return ms, float((res - kernel_out).abs().max())


# --------------------------------------------------------------------------- engine phases
def copy_graph(graph):
    """An independent copy of a host ``DynamicGraph`` (arrays copied, the
    slot dictionary shallow-copied: its keys and values are immutable),
    far cheaper than rebuilding one at cit-Patents size."""
    import copy

    out = copy.copy(graph)
    for name in ("src", "dst", "weight", "label", "valid", "out_degree", "in_degree"):
        setattr(out, name, getattr(graph, name).copy())
    out._slot = dict(graph._slot)
    out._free = list(graph._free)
    return out


def make_data(num_vertices: int, num_edges: int, num_updates: int, chunk: int, num_queries: int):
    """The uniform graph, its update stream (``num_updates`` + one more chunk)
    and the SSSP sources, from the seed."""
    from repro_torch.core.graph import DynamicGraph

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    edges = uniform_edges(num_vertices, num_edges, rng)
    initial, stream = split_and_stream(edges, num_updates + chunk, 0.2, rng)
    graph = DynamicGraph(num_vertices, initial)
    sources = pick_sources(graph, num_queries, rng)
    return graph, stream, sources, time.perf_counter() - t0


def nbytes_split(eng) -> list[int]:
    """``nbytes()`` and its parts: [D-store bytes, J-store bytes, DroppedVT
    bytes, total]."""
    diff = int(eng.state.dstore.count.sum()) * 8
    join = 0 if eng.state.jstore is None else int(eng.state.jstore.count.sum()) * 8
    total = eng.nbytes()
    return [diff, join, total - diff - join, total]


class EvictionTap:
    """Wraps ``diffstore.upsert_rows_`` (the J store's upsert) to sum the
    evictions it returns on the device; it calls the function unchanged."""

    def __init__(self, fn):
        self.fn, self.total = fn, None

    def __call__(self, *args, **kw):
        n = self.fn(*args, **kw)
        self.total = n if self.total is None else self.total + n
        return n


class Capture:
    """Wraps ``fused_sweep`` to keep the operands of one call (the first at
    iteration 2, else the first) for timing the kernel at the main path's
    shapes; it calls the kernel unchanged."""

    def __init__(self, fn):
        self.fn, self.call = fn, None

    def __call__(self, i, *args, **kw):
        if self.call is None or (i == 2 and self.call[0][0] != 2):
            self.call = ((i, *args), kw)
        return self.fn(i, *args, **kw)


SCRATCH_MISMATCH_NOTE = ("the reference's VDC differs from SCRATCH under deletions; the port "
                         "reproduces it bit for bit (ROADMAP Queue 3, 'VDC is not exact under "
                         "deletions')")


def run_stream(graph, sources, stream, *, device, backend: str, num_updates: int, chunk: int,
               counters, drop=None, mode: str = "jod", profile_path: Path | None = None,
               capture: Capture | None = None):
    """Drive ``queries.sssp`` on ``graph`` (mutated) through
    ``apply_updates_batched`` and hold the answers against SCRATCH (JOD:
    equal; VDC: mismatches counted, see :data:`SCRATCH_MISMATCH_NOTE`).

    The launch counts of the kernel modules in ``counters`` are zeroed just
    before the engine is built and read just after the timed chunks; one
    more chunk then runs under ``torch.profiler``.
    """
    import torch

    from repro_torch.core import diffstore as ds
    from repro_torch.core import queries as tq
    from repro_torch.core.scratch import scratch_like

    torch.cuda.reset_peak_memory_stats()
    tap = EvictionTap(ds.upsert_rows_)
    ds.upsert_rows_ = tap
    try:
        for K in counters:
            K.reset_launches()  # ---- the main path starts here
        t0 = time.perf_counter()
        eng = tq.sssp(graph, sources, backend=backend, drop=drop, mode=mode, max_iters=48,
                      batch_capacity=chunk, store_capacity=16, device=device)
        init_s = time.perf_counter() - t0
        out = drive_chunks(eng, stream, num_updates=num_updates, chunk=chunk, counters=counters,
                           profile_path=profile_path, capture=capture)
    finally:
        ds.upsert_rows_ = tap.fn
    out.update(backend=backend, engine_mode=mode, drop=None if drop is None else dataclass_dict(drop),
               engine_init_s=init_s)
    if mode == "vdc":
        out["jstore_evictions"] = 0 if tap.total is None else int(tap.total)
        out["jstore_rows_full"] = int((eng.state.jstore.count >= eng.cfg.jstore_capacity).sum())
        out["jstore_capacity"] = eng.cfg.jstore_capacity
        out["jstore_rows"] = int(eng.state.jstore.count.numel())

    ans = eng.answers()
    if ans.shape != (len(sources), graph.num_vertices) or np.isnan(ans).any():
        raise AssertionError(f"bad answers: shape {ans.shape}")
    if not all(ans[q, s] == 0.0 for q, s in enumerate(sources)):
        raise AssertionError("a source is not at distance 0")
    want = scratch_like(eng.cfg, eng.graph, eng.state.init, device=device).answers()
    if mode == "jod":
        np.testing.assert_array_equal(ans, want)
        out["equals_scratch"] = True
    else:
        bad = np.argwhere(ans != want)
        out["scratch_mismatches"] = int(bad.shape[0])
        out["scratch_mismatch_first"] = [
            {"q": int(q), "v": int(v), "engine": float(ans[q, v]), "scratch": float(want[q, v])}
            for q, v in bad[:5]
        ]
        out["scratch_mismatch_note"] = SCRATCH_MISMATCH_NOTE
    return out, eng


def stats_row(st) -> list:
    """One chunk's ``MaintainStats`` as plain numbers, for comparing runs."""
    return [np.asarray(x).tolist() for x in st]


def drive_chunks(eng, stream, *, num_updates: int, chunk: int, counters, profile_path, capture):
    """The timed chunks (chunk 0 is warm-up), then one profiled chunk."""
    import torch

    from repro_torch.core import engine as E

    init_iters = int(eng.last_stats.iters_run)
    fields = ("repairs", "dropped", "det_overflow", "jwritten")
    totals = {k: int(getattr(eng.last_stats, k)) for k in fields}
    chunk_stats = [stats_row(eng.last_stats)]
    lat, iters = [], []
    peak = nbytes_split(eng)
    n_chunks = num_updates // chunk
    for c, lo in enumerate(range(0, num_updates, chunk)):
        if capture is not None and c == n_chunks - 1:
            E.fused_sweep = capture  # the last timed chunk keeps one call's operands
        t0 = time.perf_counter()
        try:
            st = eng.apply_updates_batched(stream[lo : lo + chunk])
        finally:
            if capture is not None:
                E.fused_sweep = capture.fn
        lat.append(time.perf_counter() - t0)
        iters.append(int(st.iters_run))
        chunk_stats.append(stats_row(st))
        for k in totals:
            totals[k] += int(getattr(st, k))
        peak = [max(a, b) for a, b in zip(peak, nbytes_split(eng))]
    launches = {K.__name__.rsplit(".", 1)[-1]: K.LAUNCHES for K in counters}  # ---- and ends here

    traced = {}
    if profile_path is not None:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            st = eng.apply_updates_batched(stream[num_updates:])
            wall = time.perf_counter() - t0
        profile_path.parent.mkdir(parents=True, exist_ok=True)
        traced = device_busy(prof, profile_path)
        traced.update(chunk_wall_ms=wall * 1e3, sweep_iters=int(st.iters_run))
        traced["device_idle_share"] = 1.0 - traced["device_busy_ms"] / traced["chunk_wall_ms"]
    else:
        st = eng.apply_updates_batched(stream[num_updates:])
    chunk_stats.append(stats_row(st))
    for k in totals:
        totals[k] += int(getattr(st, k))
    peak = [max(a, b) for a, b in zip(peak, nbytes_split(eng))]

    timed = lat[1:]  # chunk 0 is warm-up
    return {
        "init_sweep_iters": init_iters,
        "updates_per_s": chunk * len(timed) / sum(timed),
        "chunk_latency_ms": [x * 1e3 for x in lat],
        "p50_chunk_ms": float(np.percentile(timed, 50)) * 1e3,
        "p99_chunk_ms": float(np.percentile(timed, 99)) * 1e3,
        "sweep_iters_per_chunk": iters,
        "peak_nbytes": peak[3],
        "peak_diff_nbytes": peak[0],
        "peak_join_nbytes": peak[1],
        "peak_droppedvt_nbytes": peak[2],
        **totals,
        "launches": launches,
        "launches_per_sweep_iter": {k: n / (init_iters + sum(iters)) for k, n in launches.items()},
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "traced_chunk": traced,
        "chunk_stats": chunk_stats,
    }


def dataclass_dict(x) -> dict:
    import dataclasses

    return {k: (None if v == float("inf") else v) for k, v in dataclasses.asdict(x).items()}


def state_leaves(state) -> dict:
    """Every tensor leaf of an engine state, by name."""
    out = {f"dstore/{k}": getattr(state.dstore, k) for k in ("iters", "vals", "count")}
    out.update(init=state.init, cur=state.cur, repair_counts=state.repair_counts, active=state.active,
               det_overflow=state.drop.det_overflow, max_iter=state.drop.max_iter)
    if state.drop.det is not None:
        out.update({f"det/{k}": getattr(state.drop.det, k) for k in ("iters", "vals", "count")})
    if state.drop.flt is not None:
        out["bloom/bits"] = state.drop.flt.bits
    if state.drop.params is not None:
        out.update({f"params/{k}": getattr(state.drop.params, k) for k in state.drop.params._fields})
    return out


def same_leaves(got: dict, want: dict, what: str) -> None:
    import torch

    if got.keys() != want.keys():
        raise AssertionError(f"{what}: leaves {sorted(got)} != {sorted(want)}")
    for k in want:
        g, w = got[k], want[k].to(got[k].device)
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{what}: leaf {k} differs")


def drop_policy(mode: str, bloom_bits: int):
    """``benchmarks/common.py`` DROP_DEGREE (a point of fig 7's p grid) in
    ``mode``; None for no dropping."""
    from repro_torch.core import dropping as dr

    if mode == "none":
        return None
    return dr.DropConfig(mode=mode, selection="degree", p=0.6, tau_min=2.0, tau_max=24.0,
                         det_capacity=32, bloom_bits=bloom_bits, bloom_hashes=4, seed=1)


def fused_bounds_ms(args, kw) -> tuple[float, float]:
    """Least time for one ``fused_sweep`` call at 3.35 TB/s, counted two
    ways; the few integer and float operations per byte never bind.

    The function's bound reads each input once and writes each output once
    as this call's data needs them: the iterations of every store row (the
    probes at ``i``), a value only where its column matches ``i``, and the
    values and counts of the scheduled rows, which alone the upsert and the
    removal change and alone need writing back (Det rows likewise; of the
    Bloom rows one byte per probe).  The out-of-place floor is this design's
    own: the kernel reads and writes every store row each call, because the
    frozen pre-update store is also the first iteration's working store.
    Returns (function bound, out-of-place floor) in ms.
    """
    from repro_torch.core import diffstore as ds

    i, sched, active, cur, cur_old, stale_old, dstore, old = args
    q, v = sched.shape
    qv, s, so = q * v, dstore.capacity, old.capacity
    mode = kw["drop_mode"]
    n_sched = int(sched.sum())
    n_cur = int(ds.has_at(dstore, i).sum())
    n_old = int(ds.has_at(old, i).sum())
    if kw.get("new") is not None:
        # the new= variant: the candidate, active, cur + cur_old, sched + stale_old
        rd = qv * 4 + q + qv * 4 * 2 + qv * 2
    else:
        d = kw["nbr"].shape[1]
        uses_w = kw["semiring"] in ("min_plus", "pr_sum")
        # states, adjacency, active, cur + cur_old (+ kcarry), sched + stale_old
        rd = q * (v + 1) * 4 + v * d * 4 * (2 if uses_w else 1) + q
        rd += qv * 4 * (2 if kw["kcarry"].data_ptr() == cur.data_ptr() else 3) + qv * 2
    wr = qv * (4 + 4 + 4 + 7)  # cur, old, evicted_iter, seven masks
    if mode != "none":
        rd += v * 4 + q * 17  # degree, params
    if mode == "prob":
        rd += min(q * kw["bloom_bits"].shape[1], qv * kw["bloom_hashes"])
    fn_rd = rd + qv * s * 4 + n_cur * 4 + n_sched * (s * 4 + 4) + qv * so * 4 + n_old * 4
    fn_wr = wr + n_sched * (s * 8 + 4)
    oop_rd = rd + qv * (s * 8 + 4) + qv * (so * 4 + 4)
    oop_wr = wr + qv * (s * 8 + 4)
    if mode == "det":
        sd = kw["det"].capacity
        fn_rd += qv * sd * 4 + n_sched * 4
        fn_wr += n_sched * (sd + 1) * 4 + q * 8
        oop_rd += qv * (sd + 1) * 4
        oop_wr += qv * (sd + 1) * 4 + q * 8
    return (fn_rd + fn_wr) / HBM_BYTES_PER_S * 1e3, (oop_rd + oop_wr) / HBM_BYTES_PER_S * 1e3


def fused_real(capture: Capture) -> dict:
    """K2 at the main path's shapes: the operands of one captured call,
    kernel against plain version (bit-equal), timed."""
    import torch

    from repro_torch.kernels import fused_sweep as K2

    args, kw = capture.call
    call = lambda: K2.fused_sweep(*args, **kw)  # noqa: E731
    plain = lambda: K2.fused_sweep_ref(*args, **kw)  # noqa: E731
    # the kernel's outputs wait on the host while the plain version, whose
    # temporaries take tens of GB at this size, runs
    got = K2.FusedOut(*(None if x is None else x.cpu() for x in call()))
    torch.cuda.empty_cache()
    want = plain()
    err = same_fused(K2.FusedOut(*(None if x is None else x.to(w.device) for x, w in zip(got, want))), want)
    del got, want
    torch.cuda.empty_cache()
    bound, floor = fused_bounds_ms(args, kw)
    out = {
        "form": "new=" if kw.get("new") is not None else "expand",
        "i": args[0],
        "scheduled": int(args[1].sum()),
        "max_abs_err": err,
        "ms": time_ms(call),
        "plain_ms": time_ms(plain, reps=3),
        "bound_ms": bound,
        "bound_by": "bytes",
        "out_of_place_floor_ms": floor,
        "library_ms": None,
    }
    torch.cuda.empty_cache()
    return out


def bloom_real(eng) -> dict:
    """K3 on the prob run's filter, packed: every (v, i <= max_iter) probe
    of query 0 against ``core.bloom.query``, then timed over all queries."""
    import torch

    from repro_torch.core import bloom as bloom_lib
    from repro_torch.kernels import bloom as K3

    flt = eng.state.drop.flt
    q, m = flt.bits.shape
    v = eng.cfg.num_vertices
    words = K3.pack_bits(flt.bits)
    max_iter = int(eng.state.drop.max_iter)
    dev = flt.bits.device
    v_ids = torch.arange(v, dtype=torch.int32, device=dev)[None, :]
    row0 = bloom_lib.BloomFilter(flt.bits[:1], flt.num_hashes)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    hits, lib_err = 0, 0.0
    for i in range(max_iter + 1):
        got = K3.bloom_query(words[:1], v_ids, torch.full_like(v_ids, i), zero, num_hashes=flt.num_hashes)
        want = bloom_lib.query(row0, v_ids, i, salt=0)
        lib_err = max(lib_err, max_abs_diff(got, want))
        if not torch.equal(got, want):
            raise AssertionError(f"bloom_query differs from core.bloom.query at i={i}")
        hits += int(got.sum())
    keys_v = v_ids.expand(q, v).contiguous()
    keys_i = torch.full((q, v), 2, dtype=torch.int32, device=dev)
    salt = torch.arange(q, dtype=torch.int32, device=dev)
    call = lambda: K3.bloom_query(words, keys_v, keys_i, salt, num_hashes=flt.num_hashes)  # noqa: E731
    plain = lambda: K3.bloom_query_ref(words, keys_v, keys_i, salt, num_hashes=flt.num_hashes)  # noqa: E731
    got, want = call(), plain()
    err = max_abs_diff(got, want)
    if not torch.equal(got, want):
        raise AssertionError("bloom_query differs from its plain version at the real size")
    del got, want
    nbytes = q * v * 9 + q * 4 + min(q * m // 8, q * v * flt.num_hashes * 4)
    return {
        "num_bits": m,
        "num_hashes": flt.num_hashes,
        "fill_fraction": [float(x) for x in bloom_lib.fill_fraction(flt)],
        "checked_probes_query0": (max_iter + 1) * v,
        "positives_query0": hits,
        "core_query_max_abs_err": lib_err,
        "max_abs_err": err,
        "ms": time_ms(call),
        "plain_ms": time_ms(plain, reps=5),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": None,
    }


def lookup_bound_ms(n: int, s: int, found: int) -> float:
    """Least time for one ``diff_lookup`` at 3.35 TB/s: each row's S
    iterations read, one value gathered for each of the ``found`` rows that
    hold a point at or before the query (the others write 0 and read
    none), val + iter + found written."""
    return (n * s * 4 + found * 4 + n * 9) / HBM_BYTES_PER_S * 1e3


def lookup_real(iters, vals, i: int) -> dict:
    """K4 on ``[N, S]`` store rows at the main path's size, against its
    plain version (bit-equal), timed; ``torch.searchsorted`` (right=True),
    which computes the index half only, is timed beside it as a note."""
    import torch

    from repro_torch.kernels import diff_lookup as K4

    n, s = iters.shape
    call = lambda: K4.diff_lookup(iters, vals, i)  # noqa: E731
    plain = lambda: K4.diff_lookup_ref(iters, vals, i)  # noqa: E731
    got = call()
    err = same_lookup(got, plain())
    found = int(got[2].sum())
    del got
    torch.cuda.empty_cache()
    qcol = torch.full((n, 1), i, dtype=torch.int32, device=iters.device)
    search = lambda: torch.searchsorted(iters, qcol, right=True)  # noqa: E731
    return {
        "n": n,
        "s": s,
        "i": i,
        "found": found,
        "max_abs_err": err,
        "ms": time_ms(call),
        "plain_ms": time_ms(plain, reps=5),
        "bound_ms": lookup_bound_ms(n, s, found),
        "bound_by": "bytes",
        "library_ms": None,
        "searchsorted_index_only_ms": time_ms(search, reps=5),
    }


def main_fused(graph0, sources, stream, ell_leaves, *, device, num_updates: int,
               chunk: int) -> tuple[dict, dict]:
    """The slice at full width: ``backend="fused"`` with no dropping,
    Det-Drop and Prob-Drop on copies of the main path's graph and stream.
    Prints one ``main_fused`` line per run."""
    import torch

    from repro_torch.core import engine as E
    from repro_torch.kernels import bloom as K3
    from repro_torch.kernels import diff_lookup as K4
    from repro_torch.kernels import ell_spmv as K1
    from repro_torch.kernels import fused_sweep as K2

    runs, real = {}, {}
    for mode in ("none", "det", "prob"):
        t0 = time.perf_counter()
        graph = copy_graph(graph0)
        copy_s = time.perf_counter() - t0
        capture = Capture(E.fused_sweep)
        out, eng = run_stream(
            graph, sources, stream, device=device, backend="fused", drop=drop_policy(mode, 1 << 26),
            num_updates=num_updates, chunk=chunk, counters=(K1, K2, K3, K4), capture=capture,
            profile_path=OUT_DIR / f"chip_smoke_fused_{mode}_chunk_trace.json",
        )
        out["graph_copy_s"] = copy_s
        del out["chunk_stats"]
        iters_run = out["init_sweep_iters"] + sum(out["sweep_iters_per_chunk"])
        if out["launches"]["fused_sweep"] != iters_run:
            raise AssertionError(f"{mode}: {out['launches']['fused_sweep']} fused_sweep launches "
                                 f"for {iters_run} sweep iterations")
        if out["launches"]["ell_spmv"] != 0:
            raise AssertionError(f"{mode}: the fused path launched ell_spmv")
        if mode == "none":
            got = state_leaves(eng.state)
            same_leaves({k: got[k] for k in ell_leaves}, ell_leaves, "fused vs ell engine")
            out["equals_ell_engine"] = True
        if mode == "prob":
            real["bloom_query"] = bloom_real(eng)
            out["bloom_fill_fraction"] = real["bloom_query"]["fill_fraction"]
        if mode == "det":
            real["diff_lookup_det"] = det_lookup_real(eng)
        if mode != "none":
            out["peak_nbytes_vs_none"] = out["peak_nbytes"] / runs["none"]["peak_nbytes"]
        del eng  # the captured call holds what the kernel timing needs
        torch.cuda.empty_cache()
        real[mode] = fused_real(capture)
        runs[mode] = out
        emit("main_fused", mode=mode, num_vertices=graph0.num_vertices, queries=len(sources),
             chunk=chunk, **out)
        del capture
        torch.cuda.empty_cache()
    return runs, real


def det_lookup_real(eng) -> dict:
    """K4 through ``dropping.latest_dropped_le`` on the det run's Det store
    (N = Q·V rows, S = S_d), at the highest registered iteration."""
    import torch

    from repro_torch.core import dropping as dr
    from repro_torch.kernels import diff_lookup as K4

    det = eng.state.drop.det
    q, v, s = det.iters.shape
    i = int(eng.state.drop.max_iter)
    iters, vals = det.iters.view(q * v, s), det.vals.view(q * v, s)
    found, it = dr.latest_dropped_le(eng.state.drop, i, v)
    _, want_it, want_found = K4.diff_lookup_ref(iters, vals, i)
    if not (torch.equal(found.view(-1), want_found) and torch.equal(it.view(-1), want_it)):
        raise AssertionError("latest_dropped_le differs from the plain lookup on the Det store")
    del found, it, want_it, want_found
    out = lookup_real(iters, vals, i)
    out["via"] = "dropping.latest_dropped_le"
    return out


def vdc_leaves(state) -> dict:
    """Every tensor leaf of a VDC engine state (``state_leaves`` plus the J
    store and ``join_mat``)."""
    out = state_leaves(state)
    out.update({f"jstore/{k}": getattr(state.jstore, k) for k in ("iters", "vals", "count")})
    out["join_mat"] = state.join_mat
    return out


def main_vdc(graph0, sources, stream, jod_peak_nbytes: int, *, device, num_updates: int,
             chunk: int) -> tuple[dict, dict]:
    """VDC at full size: the ``main`` path's graph, sources and stream with
    ``mode="vdc"`` (S_J = 8), ``backend="coo"`` and ``"fused"``.  The two
    runs must end leaf-equal (D store, J store, ``cur``) with equal stats,
    launch ``diff_lookup`` twice per sweep iteration (and ``fused_sweep``
    once on ``fused``, ``ell_spmv`` never).  Prints one ``main_vdc`` line
    per run."""
    import torch

    from repro_torch.core import engine as E
    from repro_torch.kernels import bloom as K3
    from repro_torch.kernels import diff_lookup as K4
    from repro_torch.kernels import ell_spmv as K1
    from repro_torch.kernels import fused_sweep as K2

    runs, real, first = {}, {}, None
    for backend in ("coo", "fused"):
        graph = copy_graph(graph0)
        capture = Capture(E.fused_sweep) if backend == "fused" else None
        out, eng = run_stream(
            graph, sources, stream, device=device, backend=backend, mode="vdc",
            num_updates=num_updates, chunk=chunk, counters=(K1, K2, K3, K4), capture=capture,
            profile_path=OUT_DIR / f"chip_smoke_vdc_{backend}_chunk_trace.json",
        )
        iters_run = out["init_sweep_iters"] + sum(out["sweep_iters_per_chunk"])
        want = {"diff_lookup": 2 * iters_run, "fused_sweep": iters_run if backend == "fused" else 0,
                "ell_spmv": 0}
        for k, n in want.items():
            if out["launches"][k] != n:
                raise AssertionError(f"vdc/{backend}: {out['launches'][k]} {k} launches, want {n} "
                                     f"for {iters_run} sweep iterations")
        out["peak_nbytes_vs_jod"] = out["peak_nbytes"] / jod_peak_nbytes
        leaves = {k: x.cpu() for k, x in vdc_leaves(eng.state).items()}
        chunk_stats = out.pop("chunk_stats")
        if first is None:
            first = (leaves, chunk_stats)
            st = eng.state.jstore  # the store as the run leaves it: the next chunk's input
            q, e, sj = st.iters.shape
            real["diff_lookup"] = lookup_real(st.iters.view(q * e, sj), st.vals.view(q * e, sj), 2)
        else:
            same_leaves(leaves, first[0], "vdc fused vs coo")
            if chunk_stats != first[1]:
                raise AssertionError("vdc fused vs coo: MaintainStats differ")
            out["equals_coo_run"] = True
        del eng, leaves
        torch.cuda.empty_cache()
        if capture is not None:
            real["fused_sweep_new"] = fused_real(capture)
            del capture
            torch.cuda.empty_cache()
        runs[backend] = out
        emit("main_vdc", num_vertices=graph0.num_vertices, queries=len(sources), chunk=chunk, **out)
    return runs, real


def parity_vdc(device, num_vertices: int = 1 << 16) -> dict:
    """VDC ``coo`` against VDC ``fused`` (K2's new= variant) for the four
    semirings x three drop modes on a short batched stream: every state
    leaf (J store and ``join_mat`` included) and every ``MaintainStats``
    (``pr_sum`` too: the COO sum adds in one fixed order); then one run with
    mixed ``join_rows`` and a ``set_join_store`` flip and back."""
    from repro_torch.core import engine as E
    from repro_torch.core import queries as tq
    from repro_torch.core import plan as qplan
    from repro_torch.core.graph import DynamicGraph
    from repro_torch.core.session import engine_config_for

    rng = np.random.default_rng(SEED + 4)
    num_edges = round(num_vertices * PATENTS_E / PATENTS_V)
    initial, stream = split_and_stream(uniform_edges(num_vertices, num_edges, rng), 96, 0.2, rng)
    both = np.concatenate([initial, initial[:, [1, 0, 2]]])
    _, first = np.unique(both[:, 0] * num_vertices + both[:, 1], return_index=True)
    sym_initial = both[np.sort(first)]
    sym_stream = [x for (u, v, lbl, w, sg) in stream for x in ((u, v, lbl, w, sg), (v, u, lbl, w, sg))]
    sources = pick_sources(DynamicGraph(num_vertices, initial), 8, rng)
    kw = dict(batch_capacity=32, device=device, mode="vdc")
    cells = {
        "min_plus": (initial, stream, lambda g, be, dp: tq.sssp(g, sources, max_iters=48,
                                                                backend=be, drop=dp, **kw)),
        "min_hop": (initial, stream, lambda g, be, dp: tq.khop(g, sources, k=6, backend=be,
                                                               drop=dp, **kw)),
        "min_label": (sym_initial, sym_stream, lambda g, be, dp: tq.wcc(g, backend=be, drop=dp,
                                                                        **kw)),
        "pr_sum": (initial, stream, lambda g, be, dp: tq.pagerank(g, iters=10, backend=be,
                                                                  drop=dp, **kw)),
    }

    def run(engines, log):
        iters = [int(engines["fused"].last_stats.iters_run)]
        rows = {be: [stats_row(e.last_stats)] for be, e in engines.items()}
        for lo in range(0, len(log), 32):
            for be, e in engines.items():
                rows[be].append(stats_row(e.apply_updates_batched(log[lo : lo + 32])))
            iters.append(int(engines["fused"].last_stats.iters_run))
        return iters, rows

    out = {}
    for semiring, (edges, log, build) in cells.items():
        for mode in ("none", "det", "prob"):
            drop = drop_policy(mode, 1 << 20)
            engines = {be: build(DynamicGraph(num_vertices, edges), be, drop) for be in ("coo", "fused")}
            iters, rows = run(engines, log)
            got, want = (vdc_leaves(engines[be].state) for be in ("fused", "coo"))
            same_leaves(got, want, f"{semiring}/{mode}")
            if rows["fused"] != rows["coo"]:
                raise AssertionError(f"{semiring}/{mode}: MaintainStats differ")
            out[f"{semiring}/{mode}"] = {"leaf_equal": True, "sweep_iters": iters,
                                         "jwritten": int(engines["fused"].last_stats.jwritten)}

    # mixed join_rows (slots 1 and 4 recompute their messages on demand) and
    # a set_join_store flip of slot 0 and back, coo against fused
    join_rows = [q not in (1, 4) for q in range(len(sources))]
    plans = [qplan.sssp(s, max_iters=48) for s in sources]
    init = np.stack([p.build_init(num_vertices) for p in plans])
    engines = {}
    for be in ("coo", "fused"):
        cfg = engine_config_for(plans[0], num_queries=len(plans), num_vertices=num_vertices,
                                mode="vdc", backend=be)
        engines[be] = E.DiffIFE(cfg, DynamicGraph(num_vertices, initial), init, batch_capacity=32,
                                join_rows=join_rows, device=device)
    iters, rows = run(engines, stream[:64])
    freed = {be: e.set_join_store(0, False) for be, e in engines.items()}
    back = {be: e.set_join_store(0, True) for be, e in engines.items()}
    more_iters, more_rows = run(engines, stream[64:])
    if freed["coo"] != freed["fused"] or freed["coo"] <= 0 or set(back.values()) != {0}:
        raise AssertionError(f"set_join_store: freed {freed}, back {back}")
    same_leaves(vdc_leaves(engines["fused"].state), vdc_leaves(engines["coo"].state), "mixed join_rows")
    if rows["fused"] != rows["coo"] or more_rows["fused"] != more_rows["coo"]:
        raise AssertionError("mixed join_rows: MaintainStats differ")
    per_op = engines["fused"].nbytes_per_operator()
    if any(per_op[q]["join"] for q in (1, 4)):
        raise AssertionError("a slot without a materialized Join holds J bytes")
    out["mixed_join_rows"] = {"leaf_equal": True, "join_rows": join_rows, "freed_slot0": freed["coo"],
                              "sweep_iters": iters + more_iters[1:],
                              "join_nbytes": [per_op[q]["join"] for q in range(len(sources))]}
    return {"num_vertices": num_vertices, "num_edges_initial": int(initial.shape[0]), "cells": out}


def parity_fused(device, num_vertices: int = 1 << 16) -> dict:
    """``backend="ell"`` (K1 + the stitched PyTorch drop path) against
    ``backend="fused"`` (K2) for the four semirings x three drop modes on a
    short batched stream: every state leaf and every ``MaintainStats``."""
    from repro_torch.core import queries as tq
    from repro_torch.core.graph import DynamicGraph

    rng = np.random.default_rng(SEED + 3)
    num_edges = round(num_vertices * PATENTS_E / PATENTS_V)
    initial, stream = split_and_stream(uniform_edges(num_vertices, num_edges, rng), 96, 0.2, rng)
    both = np.concatenate([initial, initial[:, [1, 0, 2]]])
    _, first = np.unique(both[:, 0] * num_vertices + both[:, 1], return_index=True)
    sym_initial = both[np.sort(first)]
    sym_stream = [x for (u, v, lbl, w, sg) in stream for x in ((u, v, lbl, w, sg), (v, u, lbl, w, sg))]
    sources = pick_sources(DynamicGraph(num_vertices, initial), 8, rng)
    kw = dict(batch_capacity=32, device=device)
    cells = {  # semiring: (initial edges, stream, engine builder(graph, backend, drop))
        "min_plus": (initial, stream, lambda g, be, dp: tq.sssp(g, sources, max_iters=48,
                                                                backend=be, drop=dp, **kw)),
        "min_hop": (initial, stream, lambda g, be, dp: tq.khop(g, sources, k=6, backend=be,
                                                               drop=dp, **kw)),
        "min_label": (sym_initial, sym_stream, lambda g, be, dp: tq.wcc(g, backend=be, drop=dp,
                                                                        **kw)),
        "pr_sum": (initial, stream, lambda g, be, dp: tq.pagerank(g, iters=10, backend=be,
                                                                  drop=dp, **kw)),
    }
    out = {}
    for semiring, (edges, log, build) in cells.items():
        for mode in ("none", "det", "prob"):
            drop = drop_policy(mode, 1 << 20)
            engines = {be: build(DynamicGraph(num_vertices, edges), be, drop) for be in ("ell", "fused")}
            iters = [int(engines["fused"].last_stats.iters_run)]
            for lo in range(0, len(log), 32):
                stats = {be: e.apply_updates_batched(log[lo : lo + 32]) for be, e in engines.items()}
                for f in stats["ell"]._fields:
                    if not np.array_equal(getattr(stats["ell"], f), getattr(stats["fused"], f)):
                        raise AssertionError(f"{semiring}/{mode}: MaintainStats.{f} differs")
                iters.append(int(stats["fused"].iters_run))
            same_leaves(state_leaves(engines["fused"].state), state_leaves(engines["ell"].state),
                        f"{semiring}/{mode}")
            out[f"{semiring}/{mode}"] = {"leaf_equal": True, "sweep_iters": iters,
                                         "dropped": int(engines["fused"].last_stats.dropped)}
    return {"num_vertices": num_vertices, "num_edges_initial": int(initial.shape[0]), "cells": out}


def other_semirings(device, num_vertices: int = 1 << 16) -> dict:
    """K-hop and PageRank at a smaller graph with short batched streams."""
    from repro_torch.core import queries as tq
    from repro_torch.core.graph import DynamicGraph
    from repro_torch.core.scratch import scratch_like

    rng = np.random.default_rng(SEED + 1)
    num_edges = round(num_vertices * PATENTS_E / PATENTS_V)
    initial, stream = split_and_stream(uniform_edges(num_vertices, num_edges, rng), 96, 0.2, rng)
    out = {"num_vertices": num_vertices, "num_edges_initial": int(initial.shape[0])}

    graph = DynamicGraph(num_vertices, initial)
    kh = tq.khop(graph, pick_sources(graph, 8, rng), k=6, backend="ell", batch_capacity=32, device=device)
    st = kh.apply_updates_batched(stream, batch_size=32)
    sc = scratch_like(kh.cfg, kh.graph, kh.state.init, device=device)
    np.testing.assert_array_equal(kh.answers(), sc.answers())
    out["khop"] = {"equals_scratch": True, "sweep_iters": int(st.iters_run),
                   "reachable": int(np.isfinite(kh.answers()).sum())}

    pr = tq.pagerank(DynamicGraph(num_vertices, initial), iters=10, backend="ell",
                     batch_capacity=32, device=device)
    st = pr.apply_updates_batched(stream, batch_size=32)
    sc = scratch_like(pr.cfg, pr.graph, pr.state.init, device=device)
    np.testing.assert_allclose(pr.answers(), sc.answers(), rtol=1e-6, atol=0)
    rel = np.abs(pr.answers() - sc.answers()) / np.abs(sc.answers())
    out["pagerank"] = {"within_rtol_1e-6": True, "max_rel_err": float(rel.max()),
                       "sweep_iters": int(st.iters_run)}
    return out


# --------------------------------------------------------------------------- LM serving (K5)
BF16_OPS_PER_S = 989e12  # H100 SXM, dense bf16 tensor cores
# K5 against its plain version.  float32: the reference kernel test's 2e-5
# (the two sum in other orders).  bfloat16: each output row's largest error
# over that row's largest |value|, at most two bf16 steps (2^-6): both
# compute in float32 and round once to bfloat16, so they differ by about
# one step.  A fixed absolute limit would not follow the outputs, whose
# size falls as Sk^-1/2 (about 0.01 at 32k keys).
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2.0**-6}
# main_lm_f32: the kernel path's logits against the plain path's, relative
# to the largest |logit|: 16 layers of float32 attention summed in other
# orders (the CPU parity tests hold 2 layers at 1e-5)
F32_LOGIT_REL_TOL = 1e-4
# bf16 main_lm and main_lm_long: the plain path must pick the kernel path's
# token at least this often, teacher-forced (0.96-0.97 measured on the
# H100; bf16 logits of near-equal tokens may swap, a wrong kernel agrees
# about 1 / vocab)
BF16_TOP1_FLOOR = 0.9
# the LM phases' sizes (the cells' own and their cuts: PERF.md §4)
LM_MAIN = dict(batch=8, prompt=4096, steps=64)
LM_LONG = dict(seq=32768, batch=32, steps=16)
LM_F32 = dict(batch=2, prompt=1024, steps=8)


def dtype_name(dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def flash_err(got, want) -> dict:
    """K5's output against its plain version's: the largest absolute
    difference, and the largest over rows of a row's largest difference
    over its largest |plain value|."""
    diff = (got.float() - want.float()).abs()
    scale = want.float().abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    return {"max_abs_err": float(diff.max()), "max_row_rel_err": float((diff / scale).max())}


def flash_within(err: dict, dtype: str) -> bool:
    """float32 is held at an absolute, bfloat16 at a row-relative limit."""
    key = "max_row_rel_err" if dtype == "bfloat16" else "max_abs_err"
    return err[key] <= FLASH_TOL[dtype]


def flash_operands(gen, b, hq, hkv, sq, sk, d, dtype, device, *, strided: bool, cap: int | None = None):
    """Random q, k, v for K5 at head dim ``d`` from the CUDA generator
    ``gen``; ``strided`` takes k and v as the first ``sk`` positions of a
    cache of ``cap`` (default sk + 13), as the decode path does."""
    import torch

    cap = (cap or sk + 13) if strided else sk
    t = lambda shape: torch.randn(shape, generator=gen, device=device).to(dtype)  # noqa: E731
    return t((b, hq, sq, d)), t((b, hkv, cap, d))[:, :, :sk], t((b, hkv, cap, d))[:, :, :sk]


FLASH_DIMS = (16, 64, 128)  # the head dims K5 is built for


def kernel_small_flash(device) -> dict:
    """K5 against its plain version at each head dim it is built for:
    causal and not, GQA, MQA and one head a group, ragged Sq/Sk (Sk = 1,
    Sq > Sk, Sq = 1 decode rows, groups that fill a decode CTA partly or
    span two), bf16 and f32, contiguous and strided k/v."""
    import torch

    from repro_torch.kernels import flash_attn as K5

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    shapes = [(1, 2, 2, 128, 128), (2, 4, 2, 256, 256), (1, 8, 1, 128, 256), (1, 4, 2, 64, 128),
              (1, 4, 1, 96, 40), (2, 6, 3, 72, 200), (1, 32, 8, 1000, 1000), (2, 4, 2, 130, 1),
              (2, 32, 8, 1, 4161), (3, 8, 1, 1, 5), (1, 5, 5, 1, 40), (1, 12, 4, 1, 33)]
    err = {n: {"max_abs_err": 0.0, "max_row_rel_err": 0.0} for n in ("float32", "bfloat16")}
    by_dim = {d: 0.0 for d in FLASH_DIMS}
    strided_err, cases = 0.0, 0
    for d, (b, hq, hkv, sq, sk), causal, dtype, strided in itertools.product(
            FLASH_DIMS, shapes, (True, False), (torch.float32, torch.bfloat16), (False, True)):
        q, k, v = flash_operands(gen, b, hq, hkv, sq, sk, d, dtype, device, strided=strided)
        got = K5.flash_attention(q, k, v, causal=causal)
        e = flash_err(got, K5.flash_attention_plain(q, k, v, causal=causal))
        name = dtype_name(dtype)
        if not flash_within(e, name):
            raise AssertionError(f"flash_attention {(b, hq, hkv, sq, sk, d)} causal={causal} {name} "
                                 f"strided={strided}: {e} from its plain version")
        err[name] = {key: max(err[name][key], x) for key, x in e.items()}
        by_dim[d] = max(by_dim[d], e["max_abs_err"])
        if strided:
            strided_err = max(strided_err, e["max_abs_err"])
        cases += 1
    torch.cuda.synchronize()
    return {"cases": cases, "head_dims": list(FLASH_DIMS), "max_abs_err": max(x["max_abs_err"] for x in err.values()),
            "err_by_dtype": err, "max_abs_err_by_head_dim": by_dim, "strided_max_abs_err": strided_err,
            "tolerance": {"float32_abs": FLASH_TOL["float32"], "bfloat16_row_rel": FLASH_TOL["bfloat16"]}}


def sass_kernel_name(symbol: str) -> str:
    """``flash_attn_prefill_bf16<64>``, ``flash_attn_decode_partial<bf16,128>``
    ... for a mangled kernel symbol of ``flash_attn.cu`` (the symbol itself
    otherwise)."""
    import re

    m = re.search(r"\d+(flash_attn_\w+?)I(13__nv_bfloat16|f)?Li(\d+)E", symbol)
    if m is None:
        return symbol
    dtype = {"13__nv_bfloat16": "bf16,", "f": "f32,"}.get(m.group(2) or "", "")
    return f"{m.group(1)}<{dtype}{m.group(3)}>"


def flash_sass() -> dict:
    """Tensor-core instructions (``HMMA``, ``HGMMA``) per kernel of the built
    ``flash_attn`` library, read from ``cuobjdump -sass`` of the toolkit;
    the bf16 prefill kernels must have them."""
    import re

    from repro_torch.kernels import _build

    lib = _build.library_path("flash_attn.cu")
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    counts: dict[str, dict] = {}
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = sass_kernel_name(m.group(1))
            counts[fn] = {"HMMA": 0, "HGMMA": 0}
        elif fn is not None:
            op = re.search(r"\b(HGMMA|HMMA)\.", line)
            if op:
                counts[fn][op.group(1)] += 1
    prefill = {k: c for k, c in counts.items() if k.startswith("flash_attn_prefill_bf16")}
    if len(prefill) != len(FLASH_DIMS) or not all(c["HMMA"] + c["HGMMA"] > 0 for c in prefill.values()):
        raise AssertionError(f"the bf16 prefill kernels lack tensor-core instructions: {prefill}")
    return {"library": lib.name, "tensor_core_instructions": counts}


def flash_bound(b, hq, hkv, sq, sk, d, causal: bool, itemsize: int) -> dict:
    """Least time for one K5 call: 4·d operations per visible (row, key)
    pair (QK^T and PV; causal counts the pairs under the diagonal) at the
    rate of the inputs' type (bf16 tensor cores; float32 outside them, as
    TF32 would not hold the float32 check), against q, k, v read once and
    the output written once at 3.35 TB/s; the larger bounds it."""
    if causal:
        m = min(sq, sk)
        pairs = m * (m + 1) // 2 + max(0, sq - sk) * sk
    else:
        pairs = sq * sk
    flops = 4 * b * hq * pairs * d
    nbytes = itemsize * d * (2 * b * hq * sq + 2 * b * hkv * sk)
    t_ops = flops / (BF16_OPS_PER_S if itemsize == 2 else F32_OPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def strided_copy(x):
    """A copy of ``x`` with its strides (a cache prefix stays a view)."""
    import torch

    y = torch.empty_strided(tuple(x.shape), x.stride(), dtype=x.dtype, device=x.device)
    return y.copy_(x)


class FlashCapture:
    """Wraps ``flash_attention`` to keep a copy of the operands of the first
    call of each form (prefill: Sq > 1; decode: Sq = 1, k/v a cache view,
    strides kept) for timing the kernel at the LM path's shapes; it calls
    the kernel unchanged.  It is used only in :func:`capture_forms`, after
    the timed run."""

    def __init__(self, fn):
        self.fn, self.calls = fn, {}

    def __call__(self, q, k, v, *, causal=True):
        form = "decode" if q.shape[2] == 1 else "prefill"
        if form not in self.calls:
            self.calls[form] = (q.clone(), strided_copy(k), strided_copy(v), causal)
        return self.fn(q, k, v, causal=causal)


@contextlib.contextmanager
def patched_attention(fn):
    """Route the transformer's attention (``kernels.flash_attn.flash_attention``,
    the one name it calls on the card) to ``fn`` for the duration."""
    from repro_torch.kernels import flash_attn as K5

    kernel = K5.flash_attention
    K5.flash_attention = fn
    try:
        yield
    finally:
        K5.flash_attention = kernel


def capture_forms(cfg, params, tokens, cache, first, pos: int, capture: FlashCapture) -> None:
    """Run the path's first prefill (on ``tokens``) and first decode step
    (position ``pos``, fed ``first``) again under ``capture``, to keep the
    operands K5 got there.  It runs after the main path's launches, times
    and peak memory are read, so the copies are in none of them; the decode
    step rewrites cache position ``pos`` with the values it holds."""
    import torch

    from repro_torch.configs import lm_harness as H

    with patched_attention(capture):
        H.make_prefill(cfg)(params, tokens)
        H.make_decode(cfg)(params, cache, first, torch.full((first.shape[0],), pos, dtype=torch.long,
                                                             device=first.device))
    torch.cuda.synchronize()


def plain_attention(q, k, v, *, causal=True):
    """The port's plain path for one attention call of the transformer:
    ``chunked_attention`` (the reference's function, at its default blocks)
    on the same operands."""
    from repro_torch.models import common as cm

    return cm.chunked_attention(q, k, v, causal=causal)


def device_ms_per_call(fn, calls: int = 20) -> float:
    """Device time of one call of ``fn``: ``calls`` calls enqueued behind a
    device sleep (about 50 ms), so the card runs them back to back, timed
    with CUDA events, over ``calls``.  Unlike :func:`time_ms` it leaves out
    the host's time between launches, which a call of a few tens of
    microseconds can spend more of than the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # clock cycles; the host enqueues meanwhile
    e0.record()
    for _ in range(calls):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / calls


def flash_real(call) -> dict:
    """K5 on one captured call of the LM path against its plain version,
    timed, beside its bound and one ``scaled_dot_product_attention`` call
    (a yardstick only: the port never calls it)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn as K5

    q, k, v, causal = call
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    run = lambda: K5.flash_attention(q, k, v, causal=causal)  # noqa: E731
    plain = lambda: K5.flash_attention_plain(q, k, v, causal=causal)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)  # noqa: E731
    got = run()
    err = flash_err(got, plain())
    if not flash_within(err, dtype_name(q.dtype)):
        raise AssertionError(f"flash_attention {list(q.shape)} x {list(k.shape)}: {err} from its plain version")
    if not bool(torch.equal(run(), got)):  # no atomics: the split-K merge runs in one order
        raise AssertionError(f"flash_attention {list(q.shape)} x {list(k.shape)}: a second call differs")
    lib_err = max_abs_diff(lib().float(), got.float())
    del got
    slow = sq * sk > 1 << 26  # the plain version's direct softmax takes seconds there
    return {"q": list(q.shape), "k": list(k.shape), "k_strides": list(k.stride()), "causal": causal,
            "dtype": dtype_name(q.dtype), "head_dim": d, "repeat_bit_equal": True, **err,
            "ms": time_ms(run, reps=5 if slow else 25),
            "device_ms": device_ms_per_call(run),
            "plain_ms": time_ms(plain, reps=1 if slow else 3, warmup=1), **flash_bound(
                b, hq, hkv, sq, sk, d, causal, q.element_size()),
            "library_ms": time_ms(lib), "library_device_ms": device_ms_per_call(lib),
            "library": "torch.nn.functional.scaled_dot_product_attention", "library_max_abs_err": lib_err}


# K5 rows beyond the LM cells' own calls (llama3.2-1b's head dim of 64), on
# random operands from a seeded CUDA generator: (b, hq, hkv, sq, sk, d,
# causal, cache length, dtype)
FLASH_ROWS = {
    "prefill_d128": (8, 16, 16, 4096, 4096, 128, True, None, "bfloat16"),  # qwen2-moe-a2.7b's heads
    "decode_32k_d128": (32, 16, 16, 1, 32753, 128, False, 32768, "bfloat16"),  # a 32k cache's prefix
    "prefill_gqa_d128": (1, 64, 8, 4096, 4096, 128, True, None, "bfloat16"),  # qwen2-72b's heads
    "prefill_d16": (8, 4, 2, 4096, 4096, 16, True, None, "bfloat16"),  # the llama smoke config's heads
    "decode_d16": (8, 4, 2, 1, 4097, 16, False, 4160, "bfloat16"),
    # the float32 forms (main_lm_f32's own calls are D = 64)
    "prefill_f32_d128": (2, 16, 16, 1024, 1024, 128, True, None, "float32"),
    "decode_f32_d128": (8, 16, 16, 1, 4097, 128, False, 4160, "float32"),
    "prefill_f32_d16": (2, 4, 2, 1024, 1024, 16, True, None, "float32"),
    "decode_f32_d16": (8, 4, 2, 1, 4097, 16, False, 4160, "float32"),
}


def flash_rows(device) -> dict:
    """:func:`flash_real` on each of :data:`FLASH_ROWS`."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    out = {}
    for name, (b, hq, hkv, sq, sk, d, causal, cap, dtype) in FLASH_ROWS.items():
        q, k, v = flash_operands(gen, b, hq, hkv, sq, sk, d, getattr(torch, dtype), device,
                                 strided=cap is not None, cap=cap)
        out[name] = flash_real((q, k, v, causal))
        del q, k, v
        torch.cuda.empty_cache()
    return out


def lm_prefill(cfg, params, tokens):
    """``make_prefill`` on ``tokens``: (last-position logits, cache, seconds)."""
    import torch

    from repro_torch.configs import lm_harness as H

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, cache = H.make_prefill(cfg)(params, tokens)
    torch.cuda.synchronize()
    return last, cache, time.perf_counter() - t0


def lm_decode(cfg, params, cache, first, start: int, steps: int, feed=None):
    """``steps`` ``make_decode`` steps from position ``start``, the first
    fed ``first``, the rest their predecessor's greedy token, or ``feed[i]``
    (teacher forcing).  Returns (logits per step, step ms)."""
    import torch

    from repro_torch.configs import lm_harness as H

    step = H.make_decode(cfg)
    b = first.shape[0]
    tok, logits, ms = first, [], []
    for i in range(steps):
        if feed is not None:
            tok = feed[i]
        pos = torch.full((b,), start + i, dtype=torch.long, device=first.device)
        t0 = time.perf_counter()
        lg, cache = step(params, cache, tok, pos)
        tok = torch.argmax(lg, dim=-1)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(lg)
    return logits, ms


def lm_profile(cfg, params, tokens, cache, tok, pos: int, tag: str) -> dict:
    """One prefill and one decode step under ``torch.profiler``: device-busy
    time, idle share of the wall clock and the top device ops of each."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import lm_harness as H

    out = {}
    pos_t = torch.full((tok.shape[0],), pos, dtype=torch.long, device=tok.device)
    for name, fn in (("prefill", lambda: H.make_prefill(cfg)(params, tokens)),
                     ("decode_step", lambda: H.make_decode(cfg)(params, cache, tok, pos_t))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        del res
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        traced = device_busy(prof, OUT_DIR / f"chip_smoke_{tag}_{name}_trace.json", k5=True)
        traced["wall_ms"] = wall * 1e3
        traced["device_idle_share"] = 1.0 - traced["device_busy_ms"] / traced["wall_ms"]
        out[name] = traced
    return out


def lm_compare(cfg, params, tokens, cache, gen, logits_k, last_k, start: int) -> dict:
    """The kernel path's logits against the plain path's (attention through
    ``chunked_attention``) on the same inputs: the prefill's last logits,
    then the decode steps teacher-forced with the kernel run's tokens
    (``cache`` is reused: every position a plain step reads, the plain run
    has written).  K5 must launch no time."""
    import torch

    from repro_torch.kernels import flash_attn as K5

    n0 = K5.LAUNCHES
    with patched_attention(plain_attention):
        if tokens is not None:
            last_p, pcache, _ = lm_prefill(cfg, params, tokens)
            for c, p in zip(cache, pcache):
                c[:, :, :, : p.shape[3]] = p
            del pcache
        logits_p, _ = lm_decode(cfg, params, cache, gen[0], start, len(logits_k), feed=gen[:-1])
    if K5.LAUNCHES != n0:
        raise AssertionError("the plain path launched flash_attention")
    pairs = ([(last_k, last_p)] if tokens is not None else []) + list(zip(logits_k, logits_p))
    preds = ([(gen[0], last_p)] if tokens is not None else []) + list(zip(gen[1:], logits_p))
    scale = max(float(k.float().abs().max()) for k, _ in pairs)
    agree = [float((torch.argmax(p, dim=-1) == g).float().mean()) for g, p in preds]
    out = {"max_abs_logit": scale,
           "decode_logits_max_abs_diff": max(max_abs_diff(k.float(), p.float()) for k, p in zip(logits_k, logits_p)),
           "teacher_forced_top1_agreement": float(np.mean(agree)),
           "teacher_forced_predictions": int(sum(g.numel() for g, _ in preds))}
    if tokens is not None:
        out["prefill_last_logits_max_abs_diff"] = max_abs_diff(last_k.float(), last_p.float())
    out["logits_max_abs_diff"] = max(max_abs_diff(k.float(), p.float()) for k, p in pairs)
    out["logits_rel_diff"] = out["logits_max_abs_diff"] / scale
    return out


def lm_prefill_decode_phase(cfg, params, *, batch: int, prompt: int, steps: int, tag: str,
                            device, capture: FlashCapture | None = None) -> dict:
    """``make_prefill`` on batch × prompt random tokens, then ``steps``
    greedy ``make_decode`` steps against a cache of prompt + steps
    positions (the prefill's cache copied in); K5's count zeroed just before
    and read just after, and it must equal layers × calls.  Then, with
    ``capture``, K5's operands of the first prefill and decode step
    (:func:`capture_forms`), one profiled prefill and decode step, and the
    plain path on the same inputs."""
    import torch

    from repro_torch.kernels import flash_attn as K5
    from repro_torch.models import transformer as tf

    rng = np.random.default_rng(SEED + 6)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt))).to(device)
    torch.cuda.reset_peak_memory_stats()
    K5.reset_launches()  # ---- the main path starts here
    last, pcache, prefill_s = lm_prefill(cfg, params, tokens)
    cache = tf.init_cache(cfg, batch, prompt + steps, device=device)
    for c, p in zip(cache, pcache):
        c[:, :, :, :prompt] = p
    del pcache
    first = torch.argmax(last, dim=-1)
    logits, step_ms = lm_decode(cfg, params, cache, first, prompt, steps)
    launches = K5.LAUNCHES  # ---- and ends here
    peak = torch.cuda.max_memory_allocated()
    if launches != cfg.num_layers * (1 + steps):
        raise AssertionError(f"{tag}: {launches} flash_attention launches for {cfg.num_layers} layers x "
                             f"{1 + steps} calls")
    if capture is not None:
        capture_forms(cfg, params, tokens, cache, first, prompt, capture)
    gen = [first] + [torch.argmax(lg, dim=-1) for lg in logits]
    for lg in [last, *logits]:
        if tuple(lg.shape) != (batch, cfg.vocab_size) or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{tag}: logits of shape {tuple(lg.shape)} or not finite")
    traced = lm_profile(cfg, params, tokens, cache, gen[-2], prompt + steps - 1, tag)
    out = {"batch": batch, "prompt_len": prompt, "decode_steps": steps, "prefill_s": prefill_s,
           "prefill_tokens_per_s": batch * prompt / prefill_s,
           "decode_tokens_per_s": batch * steps / (sum(step_ms) / 1e3),
           "decode_step_ms_p50": float(np.percentile(step_ms, 50)),
           "decode_step_ms_p99": float(np.percentile(step_ms, 99)), "decode_step_ms": step_ms,
           "peak_device_memory": peak, "launches": launches,
           "launches_expected": f"{cfg.num_layers} layers x {1 + steps} calls",
           "traced": traced}
    out["vs_plain"] = lm_compare(cfg, params, tokens, cache, gen, logits, last, prompt)
    return out


def main_lm(device, capture: FlashCapture) -> tuple[dict, dict]:
    """llama3.2-1b at its published widths in bf16, weights from a seeded
    generator: ``make_prefill`` on 8 x 4096 tokens and 64 decode steps,
    then ``lm_serve`` at the CLI defaults (batch 4, prompt 16, gen 8) on
    ``arch.full()``.  Returns the phase line and the weights."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attn as K5
    from repro_torch.launch import model_serve as MS
    from repro_torch.models import transformer as tf

    arch = get_arch("llama3.2-1b")
    cfg = arch.full()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # warm-up (cuBLAS handles, the allocator): one short prefill and step
    warm = torch.zeros((1, 64), dtype=torch.long, device=device)
    lm_prefill(cfg, params, warm)
    out = {"arch": arch.name, "dtype": dtype_name(cfg.dtype), "num_params": cfg.num_params(),
           "init_s": init_s,
           "reduced": {"prefill_32k.global_batch": "32 -> 8", "prefill_32k.seq_len": "32768 -> 4096"}}
    out.update(lm_prefill_decode_phase(cfg, params, **LM_MAIN, tag="lm", device=device, capture=capture))
    agree = out["vs_plain"]["teacher_forced_top1_agreement"]
    if not agree >= BF16_TOP1_FLOOR:
        raise AssertionError(f"main_lm: the plain path agrees with the kernel path's tokens {agree} of the time")
    K5.reset_launches()  # ---- lm_serve's path starts here
    served = MS.lm_serve(arch, 4, 16, 8, cfg=cfg, device=device)
    launches = K5.LAUNCHES  # ---- and ends here
    if launches != cfg.num_layers * (16 + 8 - 1):
        raise AssertionError(f"lm_serve: {launches} flash_attention launches, want {cfg.num_layers} x 23")
    toks = served["tokens"]
    if tuple(toks.shape) != (4, 8) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"lm_serve returned tokens {toks}")
    out["lm_serve"] = {"batch": 4, "prompt_len": 16, "gen": 8, "seconds": served["seconds"],
                       "tokens_per_s": served["tokens_per_s"], "launches": launches,
                       "tokens_row0": toks[0].tolist()}
    return out, params


def main_lm_long(device, params, capture: FlashCapture) -> dict:
    """The cells' own sequence length: ``make_prefill`` on 1 x 32768 tokens,
    then 16 ``make_decode`` steps at batch 32 against a 32768-position cache
    filled from the generator (positions 32752..32767)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attn as K5
    from repro_torch.models import transformer as tf

    cfg = get_arch("llama3.2-1b").full()
    seq, batch, steps = LM_LONG["seq"], LM_LONG["batch"], LM_LONG["steps"]
    rng = np.random.default_rng(SEED + 7)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, seq))).to(device)
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch,))).to(device)
    torch.cuda.reset_peak_memory_stats()
    K5.reset_launches()  # ---- the main path starts here
    last, pcache, prefill_s = lm_prefill(cfg, params, tokens)
    del pcache
    cache = tf.init_cache(cfg, batch, seq, device=device)
    gen_t = torch.Generator(device=device).manual_seed(SEED + 7)
    for c in cache:
        c.normal_(generator=gen_t)
    logits, step_ms = lm_decode(cfg, params, cache, feed, seq - steps, steps)
    launches = K5.LAUNCHES  # ---- and ends here
    peak = torch.cuda.max_memory_allocated()
    if launches != cfg.num_layers * (1 + steps):
        raise AssertionError(f"main_lm_long: {launches} flash_attention launches for "
                             f"{cfg.num_layers} x {1 + steps} calls")
    capture_forms(cfg, params, tokens, cache, feed, seq - steps, capture)
    for lg in [last, *logits]:
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError("main_lm_long: logits not finite")
    gen = [feed] + [torch.argmax(lg, dim=-1) for lg in logits]
    traced = lm_profile(cfg, params, tokens, cache, gen[-2], seq - 1, "lm_long")
    # the plain path: the 32k prefill's last logits, then the decode steps
    # teacher-forced on the same cache
    n0 = K5.LAUNCHES
    with patched_attention(plain_attention):
        last_p, pcache, _ = lm_prefill(cfg, params, tokens)
        del pcache
    if K5.LAUNCHES != n0:
        raise AssertionError("the plain path launched flash_attention")
    vs_plain = lm_compare(cfg, params, None, cache, gen, logits, None, seq - steps)
    vs_plain["prefill_last_logits_max_abs_diff"] = max_abs_diff(last.float(), last_p.float())
    vs_plain["prefill_top1_agreement"] = float((torch.argmax(last_p, -1) == torch.argmax(last, -1)).float().mean())
    agree = vs_plain["teacher_forced_top1_agreement"]
    if not agree >= BF16_TOP1_FLOOR:
        raise AssertionError(f"main_lm_long: the plain path agrees with the kernel path's tokens {agree} of the time")
    del cache
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "dtype": dtype_name(cfg.dtype),
            "reduced": {"prefill_32k.global_batch": "32 -> 1", "decode_32k.global_batch": "128 -> 32"},
            "prefill_batch": 1, "seq_len": seq, "decode_batch": batch, "decode_steps": steps,
            "prefill_s": prefill_s, "prefill_tokens_per_s": seq / prefill_s,
            "decode_tokens_per_s": batch * steps / (sum(step_ms) / 1e3),
            "decode_step_ms_p50": float(np.percentile(step_ms, 50)),
            "decode_step_ms_p99": float(np.percentile(step_ms, 99)), "decode_step_ms": step_ms,
            "peak_device_memory": peak, "launches": launches,
            "launches_expected": f"{cfg.num_layers} layers x {1 + steps} calls",
            "traced": traced, "vs_plain": vs_plain}


def main_lm_f32(device, capture: FlashCapture) -> dict:
    """llama3.2-1b at full width in float32 with TF32 off: batch 2 x 1024
    and 8 decode steps, the kernel path's logits against the plain path's
    (``chunked_attention``) at :data:`F32_LOGIT_REL_TOL`; K5's first
    prefill and decode operands kept in ``capture``."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("llama3.2-1b").full(), dtype=torch.float32)
    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(SEED + 1), device=device)
    out = {"arch": cfg.name, "dtype": "float32", "allow_tf32": False, "rel_tolerance": F32_LOGIT_REL_TOL}
    out.update(lm_prefill_decode_phase(cfg, params, **LM_F32, tag="lm_f32", device=device, capture=capture))
    rel = out["vs_plain"]["logits_rel_diff"]
    if not rel <= F32_LOGIT_REL_TOL:
        raise AssertionError(f"main_lm_f32: logits differ from the plain path by {rel} of the largest")
    del params
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- main
def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; it has no CPU path")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import bloom as K3
    from repro_torch.kernels import diff_lookup as K4
    from repro_torch.kernels import ell_spmv as K1
    from repro_torch.kernels import flash_attn as K5
    from repro_torch.kernels import fused_sweep as K2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0), nvidia_smi=smi)

    t0 = time.perf_counter()
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(sources)) as ex:
        list(ex.map(_build.compile_source, sources))
    for K in (K1, K2, K3, K4, K5):
        K._lib()
    emit("build", seconds=time.perf_counter() - t0, sources=sources,
         build_s={s: _build.build_info[s]["seconds"] for s in sources},
         ptxas={s: [ln for ln in _build.build_info[s]["log"].splitlines()
                    if "registers" in ln or "spill" in ln] for s in sources})

    emit("flash_sass", **flash_sass())

    dev = "cuda"
    emit("kernel_small", **kernel_small(dev))
    emit("kernel_small_flash", **kernel_small_flash(dev))

    num_updates, chunk, num_queries = 256, 32, 8
    graph0, stream, qsources, host_setup_s = make_data(PATENTS_V, PATENTS_E, num_updates, chunk, num_queries)
    main_out, eng = run_stream(
        copy_graph(graph0), qsources, stream, device=dev, backend="ell", num_updates=num_updates,
        chunk=chunk, counters=(K1, K2, K3, K4), profile_path=OUT_DIR / "chip_smoke_main_chunk_trace.json",
    )
    del main_out["chunk_stats"]
    if main_out["launches"]["ell_spmv"] == 0:
        raise AssertionError("the main path launched no ell_spmv kernel")
    emit("main", num_vertices=PATENTS_V, num_edges_initial=int(graph0.num_edges), queries=num_queries,
         chunk=chunk, ell_width=eng.g.ell_width, host_setup_s=host_setup_s, **main_out)

    real1 = kernel_real(eng, np.random.default_rng(SEED + 2))
    q, v, d = eng.cfg.num_queries, eng.cfg.num_vertices, eng.g.ell_width
    ell_leaves = {k: x.cpu() for k, x in state_leaves(eng.state).items()}
    del eng
    torch.cuda.empty_cache()

    runs, real = main_fused(graph0, qsources, stream, ell_leaves, device=dev,
                            num_updates=num_updates, chunk=chunk)
    del ell_leaves
    vdc_runs, vdc_real = main_vdc(graph0, qsources, stream, main_out["peak_nbytes"], device=dev,
                                  num_updates=num_updates, chunk=chunk)
    del graph0

    emit("parity_fused", **parity_fused(dev))
    emit("parity_vdc", **parity_vdc(dev))

    lm_capture, long_capture = FlashCapture(K5.flash_attention), FlashCapture(K5.flash_attention)
    lm_out, params = main_lm(dev, lm_capture)
    emit("main_lm", **lm_out)
    long_out = main_lm_long(dev, params, long_capture)
    emit("main_lm_long", **long_out)
    del params
    torch.cuda.empty_cache()
    f32_capture = FlashCapture(K5.flash_attention)
    f32_out = main_lm_f32(dev, f32_capture)
    emit("main_lm_f32", **f32_out)
    flash = {"prefill": flash_real(lm_capture.calls["prefill"]),
             "decode": flash_real(lm_capture.calls["decode"]),
             "prefill_32k": flash_real(long_capture.calls["prefill"]),
             "decode_32k": flash_real(long_capture.calls["decode"]),
             "prefill_f32": flash_real(f32_capture.calls["prefill"]),
             "decode_f32": flash_real(f32_capture.calls["decode"])}
    del lm_capture, long_capture, f32_capture
    torch.cuda.empty_cache()
    flash.update(flash_rows(dev))

    emit("kernel_real", q=q, v=v, d=d, ell_spmv=real1,
         fused_sweep={**{m: real[m] for m in ("none", "det", "prob")},
                      "vdc_new": vdc_real["fused_sweep_new"]},
         bloom_query=real["bloom_query"],
         diff_lookup={"vdc_jstore": vdc_real["diff_lookup"], "det_store": real["diff_lookup_det"]},
         flash_attention=flash)
    emit("other_semirings", **other_semirings(dev))

    mp = real1["min_plus"]
    k2 = real["none"]
    k2n = vdc_real["fused_sweep_new"]
    k3 = real["bloom_query"]
    k4 = vdc_real["diff_lookup"]
    # launches over every main-path run: the ell engine, the three fused
    # ones and the two VDC ones
    all_runs = {"ell": main_out, **{f"fused_{m}": r for m, r in runs.items()},
                **{f"vdc_{b}": r for b, r in vdc_runs.items()}}
    launches = {k: sum(r["launches"][k] for r in all_runs.values())
                for k in ("ell_spmv", "fused_sweep", "bloom", "diff_lookup")}
    # K5 over the LM runs, each counted from 0: prefill + decode, lm_serve,
    # the 32k cell, float32
    lm_launches = {"lm_prefill_and_decode": lm_out["launches"], "lm_serve": lm_out["lm_serve"]["launches"],
                   "lm_long": long_out["launches"], "lm_f32": f32_out["launches"]}
    k5 = flash["prefill"]
    print(json.dumps({"kernels": [
        {
            "name": "ell_spmv",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ell_spmv.cu",
            "replaces": "src/repro/kernels/ell_spmv.py:96",
            "launches": launches["ell_spmv"],
            "launches_by_run": {k: r["launches"]["ell_spmv"] for k, r in all_runs.items()},
            "max_abs_err": max(r["max_abs_err"] for r in real1.values()),
            "ms": mp["ms"],
            "plain_ms": mp["plain_ms"],
            "bound_ms": mp["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "semiring": "min_plus",
            "by_semiring": real1,
        },
        {
            "name": "fused_sweep",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_sweep.cu",
            "replaces": "src/repro/kernels/fused_sweep.py:210",
            "launches": launches["fused_sweep"],
            "max_abs_err": max(real[m]["max_abs_err"] for m in ("none", "det", "prob")),
            "ms": k2["ms"],
            "plain_ms": k2["plain_ms"],
            "bound_ms": k2["bound_ms"],
            "bound_by": "bytes",
            "out_of_place_floor_ms": k2["out_of_place_floor_ms"],
            "library_ms": None,
            "drop_mode": "none",
            "launches_by_run": {k: r["launches"]["fused_sweep"] for k, r in all_runs.items()},
            "by_drop_mode": {m: real[m] for m in ("none", "det", "prob")},
            "new_variant": {k: k2n[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                                 "out_of_place_floor_ms", "library_ms")},
        },
        {
            "name": "bloom_query",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bloom.cu",
            "replaces": "src/repro/kernels/bloom.py:64",
            "launches": launches["bloom"],  # no engine path calls it, as in the reference
            "max_abs_err": k3["max_abs_err"],
            "ms": k3["ms"],
            "plain_ms": k3["plain_ms"],
            "bound_ms": k3["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        },
        {
            "name": "diff_lookup",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/diff_lookup.cu",
            "replaces": "src/repro/kernels/diff_lookup.py:41",
            "launches": launches["diff_lookup"],
            "launches_by_run": {k: r["launches"]["diff_lookup"] for k, r in all_runs.items()},
            "max_abs_err": max(k4["max_abs_err"], real["diff_lookup_det"]["max_abs_err"]),
            "ms": k4["ms"],
            "plain_ms": k4["plain_ms"],
            "bound_ms": k4["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,  # no single call computes it; searchsorted (index only) is a note
            "searchsorted_index_only_ms": k4["searchsorted_index_only_ms"],
            "det_store": real["diff_lookup_det"],
        },
        {
            "name": "flash_attention",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attn.cu",
            "replaces": "src/repro/kernels/flash_attn.py:68",
            "launches": sum(lm_launches.values()),
            "launches_by_run": lm_launches,
            "max_abs_err": max(f["max_abs_err"] for f in flash.values()),
            "ms": k5["ms"],
            "plain_ms": k5["plain_ms"],
            "bound_ms": k5["bound_ms"],
            "bound_by": k5["bound_by"],
            "device_ms": k5["device_ms"],  # calls queued back to back: no host time between them
            "library_ms": k5["library_ms"],  # scaled_dot_product_attention, a yardstick only
            "form": "prefill (8 x 4096, bf16, causal, D=64)",
            "head_dims": list(FLASH_DIMS),
            "by_form": flash,
        },
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
