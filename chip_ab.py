"""Same-card A/B of the unsharded main-path cells of ``chip_smoke.py``
between source trees.

    python3 chip_ab.py TREE [TREE ...]

Each TREE is a checkout of this repository (``.`` for this one).  The trees
run one after another, each in a fresh process on the one card, with their
own ``chip_smoke.py`` and ``src/`` (kernels built under the tree), and each
prints one JSON line: the cit-Patents-sized cells ``fused`` none / det /
prob (``run_stream``, no profiled chunk), ``main_session``, and the serving
tier's run without checkpoints (``serve_run(ckpt_dir=None)``), each with
the Python collector's seconds and collections inside it.  Give the trees
as parent, change, change, parent, so the card's drift shows beside the
change.  The lines also go to ``build/chip_ab.jsonl``.  Needs CUDA.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

OUT = Path(__file__).resolve().parent / "build" / "chip_ab.jsonl"


class GcClock:
    """Seconds and collections of Python's collector, per generation."""

    def __init__(self):
        self.s, self.counts, self._t0 = 0.0, [0, 0, 0], 0.0
        gc.callbacks.append(self)

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.s += time.perf_counter() - self._t0
            self.counts[info["generation"]] += 1

    def mark(self) -> tuple:
        return self.s, list(self.counts)

    def since(self, mark: tuple) -> dict:
        return {"gc_s": self.s - mark[0], "gc_collections": [a - b for a, b in zip(self.counts, mark[1])]}


def child(tree: Path) -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_ab.py needs a CUDA device")
    sys.path.insert(0, str(tree / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke", tree / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    from repro_torch.kernels import _build
    from repro_torch.kernels import bloom as K3
    from repro_torch.kernels import diff_lookup as K4
    from repro_torch.kernels import ell_spmv as K1
    from repro_torch.kernels import fused_sweep as K2

    clock = GcClock()
    t0 = time.perf_counter()
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu") if p.name != "flash_attn.cu")
    with ThreadPoolExecutor(max_workers=len(sources)) as ex:
        list(ex.map(_build.compile_source, sources))
    num_updates, chunk = 256, 32
    graph0, stream, qsources, _ = cs.make_data(cs.PATENTS_V, cs.PATENTS_E, num_updates, chunk, 8)
    out: dict = {"tree": str(tree), "setup_s": time.perf_counter() - t0}
    keep = ("updates_per_s", "p50_chunk_ms", "p99_chunk_ms", "chunk_latency_ms", "sweep_iters_per_chunk",
            "max_memory_allocated_sweeps")
    runs = {}
    for mode in ("none", "det", "prob"):
        mark = clock.mark()
        runs[mode], eng = cs.run_stream(
            cs.copy_graph(graph0), qsources, stream, device="cuda", backend="fused",
            drop=cs.drop_policy(mode, 1 << 26), num_updates=num_updates, chunk=chunk,
            counters=(K1, K2, K3, K4),
        )
        del eng
        torch.cuda.empty_cache()
        out[f"fused_{mode}"] = {**{k: runs[mode][k] for k in keep}, **clock.since(mark)}
    mark = clock.mark()
    sess = cs.main_session(graph0, stream, qsources, runs["none"], runs["det"], device="cuda", chunk=chunk)
    out["session"] = {**{k: sess[k] for k in ("updates_per_s", "p50_chunk_ms", "p99_chunk_ms",
                                              "chunk_latency_ms", "sheds", "shed_ms_max")},
                      **clock.since(mark)}
    gc.collect()
    torch.cuda.empty_cache()
    mark = clock.mark()
    clean = cs.serve_run(graph0, stream, qsources, device="cuda", chunk=chunk, num_updates=num_updates,
                         ckpt_dir=None)["out"]
    out["serve_clean"] = {**{k: clean[k] for k in ("updates_per_s", "round_s", "phases")}, **clock.since(mark)}
    return out


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        print(json.dumps(child(Path(sys.argv[2]).resolve())), flush=True)
        return
    trees = sys.argv[1:]
    if not trees:
        raise SystemExit(__doc__)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with OUT.open("w") as f:
        f.write(json.dumps({"nvidia_smi": smi, "trees": trees}) + "\n")
        for tree in trees:
            run = subprocess.run([sys.executable, __file__, "--child", tree], capture_output=True, text=True)
            if run.returncode:
                sys.stderr.write(run.stderr[-4000:])
                raise SystemExit(f"{tree}: exit {run.returncode}")
            line = run.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            f.write(line + "\n")
            f.flush()


if __name__ == "__main__":
    main()
