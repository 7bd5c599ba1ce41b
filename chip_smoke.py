#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py        # from the repo root; needs one CUDA device and nvcc

Phases, each printing one JSON line (any failure raises and exits nonzero):

1. ``env``     torch/CUDA versions, the card, its power limit.
2. ``build``   every CUDA source under ``src/repro_torch/kernels/csrc/``
               compiled by ``nvcc`` (one process each, all started together).
3. ``kernel_small``  ``ell_spmv``'s CUDA kernel against its plain PyTorch
               version for the four semirings at ragged small shapes
               (min family bit-exact, ``pr_sum`` at rtol 1e-6).
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
5. ``kernel_real``  the kernel against its plain version at the main path's
               shapes (its own ELL arrays), timed with CUDA events, beside its
               bound and, for ``pr_sum``, one ``torch.sparse.mm`` over the
               same CSR.
6. ``other_semirings``  K-hop (k=6) and PageRank (10 rounds) at V = 2**16
               with short batched streams, against SCRATCH.

Then the ``kernels`` line, the card's ``nvidia-smi`` name and power limit,
and last ``{"ok": true, "device": {...}}``.  There is no CPU path.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "chip_smoke"  # the profiled chunk's Chrome trace

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


def device_busy(prof, path: Path) -> dict:
    """Device-busy time of a profiled window from its Chrome trace (kernels,
    copies and sets on the card), plus the top kernels by time."""
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
    return {"device_busy_ms": busy / 1e3, "top_device_ms": {k: v / 1e3 for k, v in top}}


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


def time_ms(fn, reps: int = 25) -> float:
    """Median of ``reps`` CUDA-event-timed calls, after warm-up."""
    import torch

    for _ in range(3):
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


def kernel_small(device) -> float:
    from repro_torch.kernels import ell_spmv as K

    rng = np.random.default_rng(SEED)
    err = 0.0
    for semiring in K.SEMIRINGS:
        cap = 4.0 if semiring == "min_hop" else float("inf")
        for q, v, d in [(1, 16, 4), (3, 100, 8), (2, 257, 16), (4, 128, 32)]:
            args = ell_inputs(rng, q, v, d, semiring, device)
            got = K.ell_spmv(*args, semiring=semiring, hop_cap=cap)
            err = max(err, compare(semiring, got, K.ell_spmv_ref(*args, semiring=semiring, hop_cap=cap)))
    return err


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
def main_path(device, num_vertices: int, num_edges: int, *, num_updates: int = 256,
              chunk: int = 32, num_queries: int = 8, profile_dir: Path | None = None) -> dict:
    """Build the graph and stream, drive ``queries.sssp`` through
    ``apply_updates_batched``, and hold the answers against SCRATCH."""
    import torch

    from repro_torch.core import queries as tq
    from repro_torch.core.graph import DynamicGraph
    from repro_torch.core.scratch import scratch_like
    from repro_torch.kernels import ell_spmv as K

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    edges = uniform_edges(num_vertices, num_edges, rng)
    initial, stream = split_and_stream(edges, num_updates + chunk, 0.2, rng)
    graph = DynamicGraph(num_vertices, initial)
    sources = pick_sources(graph, num_queries, rng)
    host_setup_s = time.perf_counter() - t0

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()  # ---- the main path starts here
    t0 = time.perf_counter()
    eng = tq.sssp(graph, sources, backend="ell", max_iters=48, batch_capacity=chunk,
                  store_capacity=16, device=device)
    init_s = time.perf_counter() - t0
    init_iters = int(eng.last_stats.iters_run)
    lat, iters, peak_nbytes = [], [], eng.nbytes()
    for lo in range(0, num_updates, chunk):
        t0 = time.perf_counter()
        st = eng.apply_updates_batched(stream[lo : lo + chunk])
        lat.append(time.perf_counter() - t0)
        iters.append(int(st.iters_run))
        peak_nbytes = max(peak_nbytes, eng.nbytes())
    launches = K.LAUNCHES  # ---- and ends here
    if cuda and launches == 0:
        raise AssertionError("the main path launched no ell_spmv kernel")

    traced = {}
    if profile_dir is not None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            st = eng.apply_updates_batched(stream[num_updates:])
            wall = time.perf_counter() - t0
        profile_dir.mkdir(parents=True, exist_ok=True)
        traced = device_busy(prof, profile_dir / "chip_smoke_main_chunk_trace.json")
        traced.update(chunk_wall_ms=wall * 1e3, sweep_iters=int(st.iters_run))
        traced["device_idle_share"] = 1.0 - traced["device_busy_ms"] / traced["chunk_wall_ms"]
    else:
        eng.apply_updates_batched(stream[num_updates:])
    peak_nbytes = max(peak_nbytes, eng.nbytes())

    ans = eng.answers()
    if ans.shape != (num_queries, num_vertices) or np.isnan(ans).any():
        raise AssertionError(f"bad answers: shape {ans.shape}")
    if not all(ans[q, s] == 0.0 for q, s in enumerate(sources)):
        raise AssertionError("a source is not at distance 0")
    sc = scratch_like(eng.cfg, eng.graph, eng.state.init, device=device)
    np.testing.assert_array_equal(ans, sc.answers())

    timed = lat[1:]  # chunk 0 is warm-up
    out = {
        "num_vertices": num_vertices,
        "num_edges_initial": int(initial.shape[0]),
        "queries": num_queries,
        "chunk": chunk,
        "ell_width": eng.g.ell_width,
        "host_setup_s": host_setup_s,
        "engine_init_s": init_s,
        "init_sweep_iters": init_iters,
        "updates_per_s": chunk * len(timed) / sum(timed),
        "chunk_latency_ms": [x * 1e3 for x in lat],
        "p50_chunk_ms": float(np.percentile(timed, 50)) * 1e3,
        "p99_chunk_ms": float(np.percentile(timed, 99)) * 1e3,
        "sweep_iters_per_chunk": iters,
        "peak_nbytes": peak_nbytes,
        "ell_launches": launches,
        "ell_launches_per_sweep_iter": launches / (init_iters + sum(iters)),
        "equals_scratch": True,
        "traced_chunk": traced,
    }
    if cuda:
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return out, eng


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


# --------------------------------------------------------------------------- main
def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; it has no CPU path")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import ell_spmv as K

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
    K._lib()
    emit("build", seconds=time.perf_counter() - t0, sources=sources,
         ptxas={s: _build.build_info[s]["log"].splitlines()[-2:] for s in sources})

    dev = "cuda"
    emit("kernel_small", max_abs_err=kernel_small(dev), semirings=list(K.SEMIRINGS))

    main_out, eng = main_path(dev, PATENTS_V, PATENTS_E, profile_dir=OUT_DIR)
    emit("main", **main_out)

    real = kernel_real(eng, np.random.default_rng(SEED + 2))
    emit("kernel_real", q=eng.cfg.num_queries, v=eng.cfg.num_vertices, d=eng.g.ell_width, **real)
    del eng
    torch.cuda.empty_cache()

    emit("other_semirings", **other_semirings(dev))

    mp = real["min_plus"]
    print(json.dumps({"kernels": [{
        "name": "ell_spmv",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ell_spmv.cu",
        "replaces": "src/repro/kernels/ell_spmv.py:96",
        "launches": main_out["ell_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in real.values()),
        "ms": mp["ms"],
        "plain_ms": mp["plain_ms"],
        "bound_ms": mp["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "semiring": "min_plus",
        "by_semiring": real,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
