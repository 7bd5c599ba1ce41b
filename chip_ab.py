"""Same-card A/B of the unsharded main-path cells of ``chip_smoke.py``
between source trees.

    python3 chip_ab.py TREE [TREE ...]
    python3 chip_ab.py --graph TREE [TREE ...]
    python3 chip_ab.py --wrappers TREE [TREE ...]

Each TREE is a checkout of this repository (``.`` for this one).  The trees
run one after another, each in a fresh process on the one card, with their
own ``chip_smoke.py`` and ``src/`` (kernels built under the tree), and each
prints one JSON line: the cit-Patents-sized cells ``fused`` none / det /
prob (``run_stream``, no profiled chunk), ``main_session``, and the serving
tier's run without checkpoints (``serve_run(ckpt_dir=None)``), each with
the Python collector's seconds and collections inside it.  Give the trees
as parent, change, change, parent, so the card's drift shows beside the
change.  The lines also go to ``build/chip_ab.jsonl``.  Needs CUDA.

``--graph`` times the host graph layer alone (no card, no kernels) at the
same cit-Patents size, on a stream of 2**20 updates: the graph's build, the
first 32-update chunk, 32 more such chunks, one batch of 2**16 updates and
one of the remaining 2**20 - 2**16 - 33 * 32 (``apply_batch_resolved``), a
full collection, ``copy_graph``, ``transpose_graph`` and a ``state_dict``
/ ``from_state`` round trip, each in seconds; its lines go to
``build/chip_ab_graph.jsonl``.

``--wrappers`` times kernel wrappers' calls, host work included: K5 at
arctic-480b's decode (4 x 56 query heads over 8 kv heads, 4,097 keys, D 128,
bf16) and a small K3 call (8 rows of 2,048 bits, 1,024 keys each), 1,000
back-to-back calls a repetition and 5 repetitions, synced at each end; its
lines go to ``build/chip_ab_wrappers.jsonl``.
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


GRAPH_UPDATES, GRAPH_CHUNK, GRAPH_BATCH = 1 << 20, 32, 1 << 16


def graph_child(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke", tree / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    from repro_torch.core.graph import DynamicGraph
    from repro_torch.core.landmark import transpose_graph

    clock = GcClock()
    out: dict = {"tree": str(tree)}

    def timed(name, fn):
        mark, t0 = clock.mark(), time.perf_counter()
        r = fn()
        out[name] = {"s": time.perf_counter() - t0, **clock.since(mark)}
        return r

    graph, stream, _, build_s = cs.make_data(cs.PATENTS_V, cs.PATENTS_E, GRAPH_UPDATES - GRAPH_CHUNK, GRAPH_CHUNK, 8)
    out["make_data_s"] = build_s
    out["edges"] = int(graph.num_edges)
    c = GRAPH_CHUNK
    timed("first_chunk", lambda: graph.apply_batch_resolved(stream[:c]))
    timed("chunks_32x32", lambda: [graph.apply_batch_resolved(stream[c * (k + 1): c * (k + 2)]) for k in range(32)])
    at = 33 * c
    timed("batch_65536", lambda: graph.apply_batch_resolved(stream[at: at + GRAPH_BATCH]))
    rest = stream[at + GRAPH_BATCH:]
    out["batch_rest_updates"] = len(rest)
    timed("batch_rest", lambda: graph.apply_batch_resolved(rest))
    for name in ("first_chunk", "chunks_32x32", "batch_65536", "batch_rest"):
        n = {"first_chunk": c, "chunks_32x32": 32 * c, "batch_65536": GRAPH_BATCH}.get(name, len(rest))
        out[name]["updates_per_s"] = n / out[name]["s"]
    edits = getattr(graph._slot, "_edits", None)
    out["edits_after"] = None if edits is None else len(edits)
    timed("gc_collect", gc.collect)
    timed("copy_graph", lambda: cs.copy_graph(graph))
    timed("transpose_graph", lambda: transpose_graph(graph))
    arrays, meta = graph.state_dict()
    timed("from_state", lambda: DynamicGraph.from_state(meta, arrays))
    return out


def wrappers_child(tree: Path) -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_ab.py needs a CUDA device")
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import bloom as K3
    from repro_torch.kernels import flash_attn as K5

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((4, 56, 1, 128), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((4, 8, 4097, 128), generator=g, device=dev).bfloat16() for _ in range(2))
    words = torch.randint(0, 2**31, (8, 64), generator=g, device=dev, dtype=torch.int32)
    kv = torch.randint(0, 1 << 20, (8, 1024), generator=g, device=dev, dtype=torch.int32)
    ki = torch.randint(0, 16, (8, 1024), generator=g, device=dev, dtype=torch.int32)
    salt = torch.arange(8, dtype=torch.int32, device=dev)
    calls = {"k5_arctic_decode": lambda: K5.flash_attention(q, k, v, causal=False),
             "k3_small": lambda: K3.bloom_query(words, kv, ki, salt, num_hashes=4)}
    out: dict = {"tree": str(tree)}
    for name, call in calls.items():
        for _ in range(50):
            call()
        torch.cuda.synchronize()
        reps = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(1000):
                call()
            torch.cuda.synchronize()
            reps.append(time.perf_counter() - t0)  # seconds for 1,000 calls: ms a call
        out[name] = {"ms_a_call": reps}
    return out


CHILDREN = {"--child": child, "--graph-child": graph_child, "--wrappers-child": wrappers_child}
MODES = {"--graph": ("--graph-child", "chip_ab_graph.jsonl"), "--wrappers": ("--wrappers-child", "chip_ab_wrappers.jsonl")}


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] in CHILDREN:
        print(json.dumps(CHILDREN[sys.argv[1]](Path(sys.argv[2]).resolve())), flush=True)
        return
    mode = MODES.get(sys.argv[1]) if len(sys.argv) > 1 else None
    trees = sys.argv[2:] if mode else sys.argv[1:]
    if not trees:
        raise SystemExit(__doc__)
    child_flag, out_path = ("--child", OUT) if mode is None else (mode[0], OUT.with_name(mode[1]))
    OUT.parent.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with out_path.open("w") as f:
        f.write(json.dumps({"nvidia_smi": smi, "trees": trees}) + "\n")
        for tree in trees:
            run = subprocess.run([sys.executable, __file__, child_flag, tree],
                                 capture_output=True, text=True)
            if run.returncode:
                sys.stderr.write(run.stderr[-4000:])
                raise SystemExit(f"{tree}: exit {run.returncode}")
            line = run.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            f.write(line + "\n")
            f.flush()


if __name__ == "__main__":
    main()
