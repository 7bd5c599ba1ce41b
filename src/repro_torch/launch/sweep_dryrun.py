"""Maintenance-sweep dry-run: count (and on the card, time) one initial sweep
of the stitched and the fused backend.

The port of ``repro/launch/sweep_dryrun.py``, with its command line,
defaults and record schema (``launch/dryrun.py``'s).  The reference lowers
and compiles the sweep; the port runs one initial sweep (every vertex
dirty, an empty store) for real on ``--device``, under
``launch/hlo_analysis.Counter``, with ``shards=8`` emulated on that one
device (``make_data_mesh(8, emulate=True)``).  Its record carries the
roofline terms of the whole sweep per shard, the sweep's iterations, the
hand-written kernels' taps and, on the card, their launches and the sweep's
time by CUDA events (``sweep_ms``, a second, uncounted run) beside each
term's share of it (``measured_share``).  On the CPU the kernels' plain
versions run and count as the kernels.

Cells: ``backend ∈ {ell, fused} × shards ∈ {1, 8}`` over a synthetic
uniform graph.  The model-FLOP baseline is the sweep's algorithmic work,
``2·E·Q`` per iteration (one multiply-add per edge message per query),
times the iterations run.  Records go to ``reports/dryrun_torch/``.

    PYTHONPATH=src python -m repro_torch.launch.sweep_dryrun --v 512 --e 2048 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.sweep_dryrun   # on the card
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import numpy as np
import torch

from repro_torch.launch import hlo_analysis

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "reports", "dryrun_torch")


def _graph(v: int, e: int, seed: int = 0):
    from repro_torch.core.graph import DynamicGraph

    rng = np.random.default_rng(seed)
    seen = {}
    while len(seen) < e:
        u, w = int(rng.integers(0, v)), int(rng.integers(0, v))
        if u != w:
            seen[(u, w)] = (u, w, 0, float(rng.integers(1, 10)), +1)
    return DynamicGraph(v, list(seen.values()), capacity=2 * e)


def _tree_bytes(tree) -> int:
    from repro_torch.configs.common import map_tensors

    seen: dict = {}
    map_tensors(lambda t: seen.setdefault(id(t), t.numel() * t.element_size()), tree)
    return sum(seen.values())


def _launches() -> dict:
    from repro_torch.kernels import ell_spmv, fused_sweep

    return {"ell_spmv": ell_spmv.LAUNCHES, "fused_sweep": fused_sweep.LAUNCHES}


def run_cell(backend: str, shards: int, *, v: int, e: int, num_queries: int, max_iters: int,
             device=None, verbose: bool = True) -> dict:
    import repro_torch.core.queries as q
    from repro_torch.core import engine as E
    from repro_torch.launch.mesh import make_data_mesh

    dev = E.resolve_device(device)
    mesh = make_data_mesh(shards, device=dev, emulate=True) if shards > 1 else None
    sources = [int(s) for s in np.linspace(0, v - 1, num_queries)]
    t0 = time.time()
    eng = q.sssp(_graph(v, e), sources, max_iters=max_iters, backend=backend, mesh=mesh, device=dev)
    cfg = eng.cfg

    def fresh():
        st = E.make_state(cfg, eng.state.init.clone(), 0)
        return E.reshard(st, eng.mesh) if eng.sharded else [st]

    dirty = torch.ones((v,), dtype=torch.bool, device=dev)
    states = fresh()
    t_build = time.time() - t0
    before = _launches()
    with hlo_analysis.Counter() as counter:
        new_states, stats = E.maintain_sharded(cfg, eng.devices, states, eng.gs, dirty)
    t_count = time.time() - t0 - t_build
    launches = {k: n - before[k] for k, n in _launches().items()}
    got = E.gather_state(new_states, eng.mesh, dev).cur if eng.sharded else new_states[0].cur
    if not torch.equal(got.cpu(), torch.from_numpy(eng.answers())):
        raise AssertionError(f"sweep-{backend} x{shards}: the counted sweep's answers differ from the engine's")
    iters = int(stats.iters_run)
    per_device = max(_tree_bytes(st) + _tree_bytes(g) for st, g in zip(new_states, eng.gs))
    del new_states, states
    # algorithmic work: one op per edge message per query, every iteration
    model_flops = 2.0 * e * num_queries * iters
    roof = hlo_analysis.analyse(f"sweep-{backend}", counter, shards, model_flops,
                                per_device_hbm_bytes=float(per_device), split=shards)
    rec = {
        "arch": f"sweep-{backend}",
        "shape": f"v{v}-e{e}-q{num_queries}",
        "mesh": f"1x{shards}" if shards > 1 else "single",
        "num_devices": shards,
        "lower_s": round(t_build, 1),
        "compile_s": round(t_count, 1),
        "memory_analysis": f"state + graph {per_device} B on the fullest shard",
        "per_device_bytes": per_device,
        "roofline": roof.to_dict(),
        "iters_run": iters,
        "kernels": counter.kernels,
        "launches": launches,
        "device": str(dev),
        "status": "ok",
    }
    if dev.type == "cuda":
        states = fresh()
        torch.cuda.synchronize(dev)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        E.maintain_sharded(cfg, eng.devices, states, eng.gs, dirty)
        e1.record()
        e1.synchronize()
        ms = e0.elapsed_time(e1)
        # the terms are per shard; emulated shards run one after another
        rec["sweep_ms"] = ms
        rec["measured_share"] = {k: roof.to_dict()[f"t_{k}_s"] * shards * 1e3 / ms
                                 for k in ("compute", "memory", "collective")}
    if verbose:
        print(f"[sweep-dryrun] {rec['arch']} {rec['shape']} mesh={rec['mesh']} OK "
              f"(build {t_build:.1f}s count {t_count:.1f}s bottleneck={roof.bottleneck})")
    return rec


def save(rec: dict) -> None:
    os.makedirs(REPORT_DIR, exist_ok=True)
    key = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}".replace("/", "_")
    with open(os.path.join(REPORT_DIR, key + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--v", type=int, default=512)
    ap.add_argument("--e", type=int, default=2048)
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--max-iters", type=int, default=32)
    ap.add_argument("--backend", default="both", choices=["ell", "fused", "both"],
                    help="stitched (ell), fused megakernel, or both")
    ap.add_argument("--shards", default="1,8")
    ap.add_argument("--continue-on-error", action="store_true")
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    args = ap.parse_args(argv)

    backends = ["ell", "fused"] if args.backend == "both" else [args.backend]
    recs = []
    for backend in backends:
        for shards in (int(s) for s in args.shards.split(",")):
            try:
                rec = run_cell(backend, shards, v=args.v, e=args.e, num_queries=args.queries,
                               max_iters=args.max_iters, device=args.device)
            except Exception as exc:  # noqa: BLE001 — recorded per cell
                if not args.continue_on_error:
                    raise
                traceback.print_exc()
                rec = {
                    "arch": f"sweep-{backend}",
                    "shape": f"v{args.v}-e{args.e}-q{args.queries}",
                    "mesh": f"1x{shards}" if shards > 1 else "single",
                    "num_devices": shards,
                    "status": f"error: {exc}",
                }
            save(rec)
            recs.append(rec)
    return recs


if __name__ == "__main__":
    main()
