"""Continuous-query serving CLI: stream an update log through a session.

The port of ``repro/launch/cqp_serve.py``, on the CUDA device unless
``--device cpu`` asks for the plain PyTorch versions.  The serving shape of
the paper's CQP, engine-agnostic via
:class:`repro_torch.core.session.CQPSession`: Q registered queries, one δE log
streamed in fixed-shape chunks of B updates, and a *query-churn* scenario —
``--register-at K`` registers a fresh query before chunk K (its trace is
initialized in-engine), ``--deregister-at K`` retires the oldest live query
and reclaims its difference bytes.  Reports updates/sec, p50/p99 per-chunk
maintenance latency, peak diff-store bytes, and churn-event latencies; the
JSON line adds one SHA-256 digest of each query's final answers, so two runs
(a fault drill and the uninterrupted run) compare bit for bit, each query's
Aggregate (an SPSP plan's target distance), and the process's launches of
each CUDA kernel.

``--engine`` selects the executor behind the same session API:

    dense    the GPU engine (batched chunks; --backend ell launches the ELL
             SpMV kernel, fused the maintenance kernel)
    host     the paper's pointer machine (work ∝ affected set, on the host)
    scratch  from-scratch re-execution baseline

``--optimize auto|always`` runs the plan optimizer (`repro_torch.planner`):
``--query spsp`` plans then share one landmark index and answer through
pruned-scratch subqueries; the JSON report carries the planner's block.
``--mesh data --shards N`` runs the vertex-sharded sweep over N cards
(``--mesh smoke``: one shard); ``--emulate-devices N`` places the N shards
on the one ``--device`` instead — the counterpart of the reference's
host-device flag, never chosen without it.  ``--mesh production`` is the
reference's 16 x 16 ``("data", "model")`` mesh over 256 cards: the graph's
vertices split 16 ways over ``data`` and are replicated over ``model``.
The JSON line then carries the per-device accounted bytes (their peak and
the final split).

``--budget-bytes`` puts the stream under the memory governor (DESIGN.md
§10): a global accounted-byte budget enforced online by escalating each
query along the drop-policy ladder; ``--governor det|prob`` picks the
provisioned DroppedVT representation.  The JSON report then carries the
per-query byte breakdown, the governor's action log, and its headroom.

``--plan-file plans.json`` registers operator-graph plans loaded from JSON
(the ``QueryPlan.to_json`` schema — DESIGN.md §11) instead of the synthetic
``--query`` batch; the JSON report carries ``nbytes_per_operator``, the
per-(query, operator) byte breakdown, either way.

Examples::

    PYTHONPATH=src python -m repro_torch.launch.cqp_serve --smoke
    PYTHONPATH=src python -m repro_torch.launch.cqp_serve \
        --v 512 --e 2048 --queries 16 --updates 256 --batch 32 --backend ell
    # the plain PyTorch versions on the CPU
    PYTHONPATH=src python -m repro_torch.launch.cqp_serve --smoke --device cpu
    # SPSP through the landmark hub-cut (one shared index, pruned scratch)
    PYTHONPATH=src python -m repro_torch.launch.cqp_serve --smoke --json \
        --query spsp --optimize always --backend fused
    # operator-graph plans from JSON (e.g. an RPQ with a materialized join)
    PYTHONPATH=src python -m repro_torch.launch.cqp_serve --smoke --json \
        --plan-file plans.json --backend coo
    # churn: register before chunk 2, deregister before chunk 4, on all engines
    for eng in dense host scratch; do
      PYTHONPATH=src python -m repro_torch.launch.cqp_serve --smoke --json \
          --engine $eng --register-at 2 --deregister-at 4
    done
    # closed-loop memory budget (Bloom DroppedVT, 4 KiB global)
    PYTHONPATH=src python -m repro_torch.launch.cqp_serve --smoke --json \
        --budget-bytes 4096 --governor prob
    # durability drill: checkpoint every 2 chunks, inject a fault before
    # chunk 3, restore + replay — answers match the uninterrupted run; then
    # resume a fresh process from the same directory
    PYTHONPATH=src python -m repro_torch.launch.cqp_serve --smoke --json \
        --checkpoint-dir ckpt --checkpoint-every 2 --inject-fault-at 3
    PYTHONPATH=src python -m repro_torch.launch.cqp_serve --smoke --json \
        --checkpoint-dir ckpt --restore
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time
from collections import Counter

import numpy as np

from repro_torch.kernels import bloom, diff_lookup, ell_spmv, fused_sweep
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.metrics import PhaseRecorder, summarize_latency_s

def make_mesh(kind: str, shards: int | None, *, emulate: int = 0, device=None):
    """Resolve --mesh: ``none`` (unsharded), ``smoke`` (one shard),
    ``data`` (``shards`` shards; default: every visible card, or every
    emulated device) or ``production``.  ``emulate`` N > 0 emulates N
    devices on ``device``: the ``data`` mesh's shards then share it."""
    from repro_torch.launch import mesh as mesh_lib

    if emulate and kind != "data":
        raise SystemExit(f"--emulate-devices needs --mesh data, not --mesh {kind}")
    try:
        if kind == "none":
            return None
        if kind == "smoke":
            return mesh_lib.make_smoke_mesh(device)
        if kind == "production":
            return mesh_lib.make_production_mesh()
        if emulate:
            n = emulate if shards is None else int(shards)
            if n > emulate:
                raise ValueError(f"asked for {n} shards but only {emulate} devices are emulated")
            return mesh_lib.make_data_mesh(n, device=device, emulate=True)
        return mesh_lib.make_data_mesh(shards, device=device)
    except ValueError as e:
        raise SystemExit(f"--mesh {kind}: {e}") from None


def mesh_of(args):
    """The mesh the CLI's arguments ask for."""
    return make_mesh(args.mesh, args.shards, emulate=getattr(args, "emulate_devices", 0),
                     device=args.device)


def load_plan_file(path: str):
    """Operator-graph plans from JSON: a list of plan objects (or
    ``{"plans": [...]}``), each ``{"kind": ..., "nodes": [...]}`` in the
    :meth:`repro_torch.core.plan.QueryPlan.to_json` schema.  All plans must share
    one family (one session compiles one sweep shape)."""
    from repro_torch.core.plan import QueryPlan

    with open(path) as fh:
        payload = json.load(fh)
    if isinstance(payload, dict):
        payload = payload.get("plans", [payload])
    if not payload:
        raise SystemExit(f"plan file {path!r} holds no plans")
    try:
        plans = [QueryPlan.from_json(obj) for obj in payload]
    except (KeyError, ValueError) as exc:
        raise SystemExit(f"plan file {path!r}: {exc}") from exc
    return plans


def initial_plans(args):
    """The query batch registered before the stream starts."""
    from repro_torch.core import plan

    if args.plan_file is not None:
        plans = load_plan_file(args.plan_file)
        args.queries = len(plans)
        return plans
    if args.query == "sssp":
        return [
            plan.sssp(s, max_iters=args.max_iters) for s in range(args.queries)
        ]
    if args.query == "spsp":
        # source/target pairs half the vertex space apart
        return [
            plan.spsp(s, (s + args.v // 2) % args.v, max_iters=args.max_iters)
            for s in range(args.queries)
        ]
    if args.query == "khop":
        return [
            plan.khop(s, k=min(6, args.max_iters)) for s in range(args.queries)
        ]
    if args.query == "pagerank":
        args.queries = 1  # PageRank is a single batch computation (§6.1.2)
        return [plan.pagerank(iters=min(10, args.max_iters))]
    raise SystemExit(f"unknown query {args.query!r}")


def churn_plan(args, seq: int):
    """The query a --register-at event brings in (same family, new source)."""
    from repro_torch.core import plan

    source = (args.queries + seq) % args.v
    if args.query == "sssp":
        return plan.sssp(source, max_iters=args.max_iters)
    if args.query == "spsp":
        return plan.spsp(
            source, (source + args.v // 2) % args.v, max_iters=args.max_iters
        )
    if args.query == "khop":
        return plan.khop(source, k=min(6, args.max_iters))
    return plan.pagerank(iters=min(10, args.max_iters))


def build_log(args):
    """The run's deterministic workload, fully derived from the args/seed —
    a restore rebuilds the identical log and replays its suffix."""
    from repro_torch.data.graphgen import powerlaw_graph, split_90_10, update_stream

    edges = powerlaw_graph(args.v, args.e, seed=args.seed)
    initial, pool = split_90_10(edges, seed=args.seed)
    stream = update_stream(
        initial,
        args.v,
        num_batches=max(1, args.updates // max(args.batch, 1)),
        batch_size=args.batch,
        insert_pool=pool,
        delete_fraction=args.delete_fraction,
        seed=args.seed + 1,
    )
    log = [u for batch in stream for u in batch]
    return edges, initial, log


def build_session(args):
    from repro_torch.core.graph import DynamicGraph
    from repro_torch.core.session import CQPSession

    edges, initial, log = build_log(args)
    graph = DynamicGraph(args.v, initial, capacity=len(edges) * 4 + 64)
    mesh = mesh_of(args)
    plans = initial_plans(args)
    gov_kw = {}
    if args.budget_bytes is not None:
        from repro_torch.core.governor import GovernorConfig

        gov_kw = dict(
            budget_bytes=args.budget_bytes,
            governor=GovernorConfig(
                representation=args.governor, bloom_bits=args.governor_bloom_bits
            ),
        )
    session = CQPSession(
        graph,
        engine=args.engine,
        mesh=mesh,
        backend=args.backend,
        batch_capacity=args.batch,
        min_slots=len(plans),
        optimize=args.optimize,
        device=args.device,
        **gov_kw,
    )
    handles = session.register_many(plans)
    return session, handles, log


def serve(args) -> dict:
    if getattr(args, "trace_out", None):
        # install a live tracer before any engine work so session/engine/
        # governor/recovery spans land in the exported Chrome trace
        obs_trace.set_tracer(obs_trace.Tracer())
    t0 = time.perf_counter()
    restore_latency = None
    start_chunk = 0
    if args.restore:
        from repro_torch.core.session import CQPSession

        session = CQPSession.restore(args.checkpoint_dir, mesh=mesh_of(args), device=args.device)
        initial_plans(args)  # normalize args.queries (plan files / pagerank)
        handles = session.handles()
        extra = (session.restore_info or {}).get("extra") or {}
        start_chunk = int(extra.get("next_chunk", 0))
        _, _, log = build_log(args)
        restore_latency = time.perf_counter() - t0
    else:
        session, handles, log = build_session(args)
    t_init = time.perf_counter() - t0

    b = args.batch
    chunks = [log[i : i + b] for i in range(0, len(log), b)]
    if not chunks:
        raise SystemExit("empty update log — raise --updates")
    if start_chunk > len(chunks):
        raise SystemExit(
            f"checkpoint cursor {start_chunk} past the {len(chunks)}-chunk "
            "log — restore with the args the checkpointed run used"
        )
    # repeated flags at the same chunk index fire that many events
    register_at = Counter(args.register_at or [])
    deregister_at = Counter(args.deregister_at or [])
    for k in list(register_at) + list(deregister_at):
        if not (0 < k < len(chunks)):
            raise SystemExit(
                f"churn index {k} outside the mid-stream range "
                f"1..{len(chunks) - 1} ({len(chunks)} chunks)"
            )

    def dev_peak(s):
        # unsharded, per-device == total: don't pay a second per-chunk fetch
        return max(s.nbytes_per_device()) if s.num_shards > 1 else s.nbytes()

    # governor settling window: the first SETTLE post-warmup chunks may run
    # over budget while policies escalate; the peak after it must respect it
    settle = 2
    # mutable run metrics, shared with the per-chunk closure: a fault
    # restart swaps the session object, so nothing below closes over it
    M = {
        "handles": handles,
        "lat": [],
        "reg_ms": [],
        "dereg_ms": [],
        "bytes_freed": 0,
        "served": 0,
        "warmup_served": 0,
        "peak": session.nbytes(),
        "peak_dev": dev_peak(session),
        "t_compile": 0.0,
        "t_serve": 0.0,
        # replay determinism: a restored session derives the next churn
        # source from how many churn registers already happened
        "churn_seq": max(session.registered_total - args.queries, 0),
        "settled_peak": 0,
        "settled_samples": 0,
    }

    def run_chunk(s, k, chunk):
        if k == 0 and M["t_compile"] == 0.0:
            # warmup chunk: traces + compiles the batched step (reported
            # separately; churn indices are validated mid-stream only)
            t0 = time.perf_counter()
            s.apply_updates_batched(chunk, batch_size=b)
            M["t_compile"] = time.perf_counter() - t0
            M["served"] += len(chunk)
            M["warmup_served"] = len(chunk)
        else:
            for _ in range(register_at.get(k, 0)):
                t0 = time.perf_counter()
                M["handles"].append(s.register(churn_plan(args, M["churn_seq"])))
                M["reg_ms"].append((time.perf_counter() - t0) * 1e3)
                M["churn_seq"] += 1
            for _ in range(deregister_at.get(k, 0)):
                if not M["handles"]:
                    break
                t0 = time.perf_counter()
                M["bytes_freed"] += s.deregister(M["handles"].pop(0))
                M["dereg_ms"].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            s.apply_updates_batched(chunk, batch_size=b)
            dt = time.perf_counter() - t0
            M["lat"].append(dt)
            M["t_serve"] += dt
            M["served"] += len(chunk)
        M["peak"] = max(M["peak"], s.nbytes())
        M["peak_dev"] = max(M["peak_dev"], dev_peak(s))
        if k > settle:
            M["settled_peak"] = max(M["settled_peak"], s.nbytes())
            M["settled_samples"] += 1

    sup = det = None
    if args.checkpoint_dir is not None:
        from repro_torch.core.session import CQPSession
        from repro_torch.runtime.fault import FaultPolicy, InjectedFault
        from repro_torch.runtime.recovery import RecoverySupervisor
        from repro_torch.runtime.straggler import StragglerDetector

        det = StragglerDetector()
        fired: set[int] = set()
        inject_at = set(args.inject_fault_at or [])

        def injector(k: int) -> None:
            if k in inject_at and k not in fired:
                fired.add(k)  # one-shot: the drill must recover, not loop
                raise InjectedFault(f"injected fault before chunk {k}")

        def restore_fn(directory):
            if directory is None:
                # no checkpoint landed before the fault: genesis replay
                s, M["handles"], _ = build_session(args)
                start = 0
            else:
                s = CQPSession.restore(directory, mesh=mesh_of(args), device=args.device)
                M["handles"] = s.handles()
                extra = (s.restore_info or {}).get("extra") or {}
                start = int(extra.get("next_chunk", 0))
            M["churn_seq"] = max(s.registered_total - args.queries, 0)
            s.attach_runtime(straggler=det, supervisor=sup)
            return s, start

        sup = RecoverySupervisor(
            args.checkpoint_dir,
            FaultPolicy(
                max_restarts=args.max_restarts,
                checkpoint_every=args.checkpoint_every,
                backoff_s=args.backoff_s,
            ),
            keep=args.checkpoint_keep,
            restore_fn=restore_fn,
            fault_injector=injector,
            straggler=det,
        )
        session.attach_runtime(straggler=det, supervisor=sup)
        session = sup.run(session, chunks, run_chunk, start_chunk=start_chunk)
    else:
        for k in range(start_chunk, len(chunks)):
            run_chunk(session, k, chunks[k])

    if M["settled_samples"] == 0:
        # stream shorter than the settling window: judge the final state
        # rather than vacuously reporting a respected budget
        M["settled_peak"] = session.nbytes()

    steady = bool(M["lat"])
    if not steady:
        # single-chunk log: the only measurement includes trace+compile
        print(
            "warning: update log fits one chunk — latencies include compile; "
            "raise --updates past --batch for steady-state numbers"
        )
    lat_s = M["lat"] if steady else [M["t_compile"]]
    latency = summarize_latency_s(lat_s)
    served = M["served"]
    reg_ms, dereg_ms = M["reg_ms"], M["dereg_ms"]
    bytes_freed = M["bytes_freed"]
    t_compile = M["t_compile"]
    phases = PhaseRecorder()
    phases.extend("maintain", lat_s)
    phases.extend("register", [x / 1e3 for x in reg_ms])
    phases.extend("deregister", [x / 1e3 for x in dereg_ms])
    if sup is not None:
        phases.extend("checkpoint", sup.checkpoint_s)
    out = {
        "engine": args.engine,
        "queries": args.queries,
        "final_queries": session.num_queries,
        "batch": b,
        "backend": args.backend,
        "updates_served": served,
        "updates_per_sec": (
            (served - M["warmup_served"]) / max(M["t_serve"], 1e-9)
            if steady
            else served / max(t_compile, 1e-9)
        ),
        # flat p50/p99 keys kept for existing consumers; the full
        # percentile set (incl. p999) is the shared `latency` block
        "p50_ms": latency["p50_ms"],
        "p99_ms": latency["p99_ms"],
        "latency": latency,
        "phases": phases.summary(),
        "steady_state": steady,
        "peak_diff_bytes": int(M["peak"]),
        "shards": session.num_shards,
        "peak_diff_bytes_per_device": int(M["peak_dev"]),
        "nbytes_per_device": [int(x) for x in session.nbytes_per_device()],
        "registers": len(reg_ms),
        "deregisters": len(dereg_ms),
        "register_ms": [float(x) for x in reg_ms],
        "deregister_ms": [float(x) for x in dereg_ms],
        "bytes_freed": int(bytes_freed),
        "nbytes_per_query": [int(x) for x in session.nbytes_per_query()],
        "nbytes_per_operator": [
            {op: int(b) for op, b in ops.items()}
            for ops in session.nbytes_per_operator()
        ],
        "init_s": t_init,
        "compile_s": t_compile,
        # the final answers, one digest per live query (ascending qid): two
        # runs agree bit for bit exactly when these do
        "answers_sha256": [
            hashlib.sha256(np.ascontiguousarray(session.answers(h), np.float32).tobytes()).hexdigest()
            for h in session.handles()
        ],
        # each query's Aggregate (null for a plan without one): an SPSP
        # plan's target distance, exact under the landmark rewrite too
        "aggregates": [session.aggregate(h) if h.plan.aggregate is not None else None
                       for h in session.handles()],
        # kernel launches of this process (a restore's replay included)
        "kernel_launches": {K.__name__.rsplit(".", 1)[-1]: K.LAUNCHES
                            for K in (ell_spmv, fused_sweep, bloom, diff_lookup)},
    }
    if sup is not None:
        rec = sup.metrics()
        rec["checkpoint_dir"] = args.checkpoint_dir
        rec["checkpoint_every"] = args.checkpoint_every
        rec["live_nbytes"] = int(session.nbytes())
        rec["restore_latency_s"] = restore_latency
        rec["straggler_events"] = len(det.events)
        out["recovery"] = rec
        runtime = session.stats().get("runtime")
        if runtime is not None:
            out["runtime"] = runtime
    if session.governor is not None:
        gov = session.governor
        out["governor"] = {
            **gov.snapshot(session),
            "representation": gov.cfg.representation,
            "settled_peak_bytes": int(M["settled_peak"]),
            "budget_respected": bool(M["settled_peak"] <= gov.budget_bytes),
        }
    planner_stats = session.stats().get("planner")
    if planner_stats is not None:
        out["planner"] = planner_stats
    print(
        f"cqp_serve[{args.query}/{args.engine}/{args.backend}] "
        f"Q={args.queries}→{out['final_queries']} B={b}: "
        f"{out['updates_per_sec']:.1f} updates/sec over {served} updates"
    )
    print(
        f"  maintenance latency p50={out['p50_ms']:.2f} ms "
        f"p99={out['p99_ms']:.2f} ms per {b}-update chunk"
        + ("" if steady else " (includes compile)")
    )
    if reg_ms or dereg_ms:
        print(
            f"  churn: {len(reg_ms)} register(s) "
            f"({sum(reg_ms):.1f} ms total, in-engine re-trace), "
            f"{len(dereg_ms)} deregister(s) freeing {bytes_freed} diff bytes"
        )
    print(
        f"  peak diff-store bytes={out['peak_diff_bytes']} "
        f"per-device={out['peak_diff_bytes_per_device']} "
        f"over {out['shards']} shard(s) "
        f"(init {t_init:.2f}s, first-chunk compile {t_compile:.2f}s)"
    )
    if "governor" in out:
        g = out["governor"]
        print(
            f"  governor[{g['representation']}]: budget={g['budget_bytes']} "
            f"settled-peak={g['settled_peak_bytes']} "
            f"headroom={g['headroom_bytes']} "
            f"({'respected' if g['budget_respected'] else 'VIOLATED'}; "
            f"{g['escalations']} escalation(s), "
            f"{g['deescalations']} de-escalation(s))"
        )
    if "planner" in out:
        p = out["planner"]
        lmk = p.get("landmark", {})
        print(
            f"  planner[{p['mode']}]: {p['rewrites_total']} rewrite(s), "
            f"landmark index live={lmk.get('live')} "
            f"bytes={lmk.get('index_nbytes', 0)} "
            f"(sheds={lmk.get('sheds_total', 0)}, "
            f"remats={lmk.get('remats_total', 0)})"
        )
    if "recovery" in out:
        r = out["recovery"]
        ckpt_s = sum(r["checkpoint_s"])
        print(
            f"  recovery: {r['checkpoints']} checkpoint(s) "
            f"({ckpt_s * 1e3:.1f} ms total, {r['checkpoint_bytes']} bytes "
            f"vs {r['live_nbytes']} live), {r['restarts']} restart(s), "
            f"{r['replayed_chunks']} chunk(s) replayed, "
            f"{r['straggler_events']} straggler event(s)"
        )
    if getattr(args, "metrics_out", None) or getattr(args, "trace_out", None):
        session.publish_metrics()  # final scrape of the DC probes
    if getattr(args, "metrics_out", None):
        with open(args.metrics_out, "w") as fh:
            json.dump(obs_metrics.get_registry().snapshot(), fh, indent=1)
        print(f"  metrics snapshot -> {args.metrics_out}")
    if getattr(args, "trace_out", None):
        n = obs_trace.get_tracer().export(args.trace_out)
        out["trace_events"] = n
        print(f"  trace: {n} event(s) -> {args.trace_out} "
              "(load in ui.perfetto.dev)")
    if args.json:
        print(json.dumps(out))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--v", type=int, default=512)
    ap.add_argument("--e", type=int, default=2048)
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--updates", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--max-iters", type=int, default=48)
    ap.add_argument("--delete-fraction", type=float, default=0.2)
    ap.add_argument(
        "--query",
        choices=("sssp", "spsp", "khop", "pagerank"),
        default="sssp",
    )
    ap.add_argument(
        "--optimize",
        choices=("none", "auto", "always"),
        default="none",
        help="plan optimizer mode (repro_torch.planner): auto rewrites matching "
        "plans when the cost model says the rewrite pays (e.g. --query spsp "
        "onto the shared landmark index, DESIGN.md §16); always bypasses "
        "the cost gate",
    )
    ap.add_argument(
        "--plan-file",
        default=None,
        metavar="PLANS_JSON",
        help="register operator-graph plans loaded from a JSON file "
        "(QueryPlan.to_json schema) instead of the --query/--queries batch; "
        "the synthetic stream carries edge label 0, so RPQ plans should "
        "match label 0",
    )
    ap.add_argument(
        "--engine",
        choices=("dense", "host", "scratch"),
        default="dense",
        help="executor behind the session API (CQPSession)",
    )
    ap.add_argument(
        "--backend",
        choices=("coo", "ell", "fused"),
        default="ell",
        help="sweep aggregator: coo=scatter-reduce, ell=the CUDA ELL SpMV "
        "kernel, fused=the CUDA maintenance kernel (one launch per iteration)",
    )
    ap.add_argument(
        "--device",
        default=None,
        help="torch device (default: the CUDA device; 'cpu' runs the plain "
        "PyTorch versions)",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--register-at",
        type=int,
        action="append",
        default=None,
        metavar="CHUNK",
        help="register one extra query before streaming chunk CHUNK "
        "(repeatable; 1-based mid-stream index)",
    )
    ap.add_argument(
        "--deregister-at",
        type=int,
        action="append",
        default=None,
        metavar="CHUNK",
        help="deregister the oldest live query before chunk CHUNK (repeatable)",
    )
    ap.add_argument(
        "--budget-bytes",
        type=int,
        default=None,
        help="global accounted-byte budget enforced by the memory governor "
        "(escalates per-query drop policies online; DESIGN.md §10)",
    )
    ap.add_argument(
        "--governor",
        choices=("det", "prob"),
        default="prob",
        help="DroppedVT representation the governor provisions "
        "(det: ≤4 B/record floor ~ half the static bytes; prob: fixed "
        "Bloom rows, deepest reclamation)",
    )
    ap.add_argument(
        "--governor-bloom-bits",
        type=int,
        default=1 << 9,
        help="per-query Bloom bits for --governor prob (64 B packed default)",
    )
    ap.add_argument(
        "--smoke", action="store_true", help="tiny CPU-friendly end-to-end run"
    )
    ap.add_argument(
        "--mesh",
        choices=("none", "smoke", "data", "production"),
        default="none",
        help="mesh to serve on: none (unsharded), smoke (one shard), data "
        "(the vertex-sharded sweep over --shards cards) or production (16 x 16 "
        "(data, model) cards: vertices over the 16 of data)",
    )
    ap.add_argument(
        "--shards", type=int, default=None,
        help="data-axis size for --mesh data (default: all local devices)",
    )
    ap.add_argument(
        "--emulate-devices", type=int, default=0,
        help="emulate N devices on --device for --mesh data: the shards "
        "share the one device (how one card or the CPU runs shards)",
    )
    ap.add_argument(
        "--checkpoint-dir",
        default=None,
        metavar="DIR",
        help="enable durability: periodic session checkpoints into DIR via "
        "the async keep-N CheckpointManager (DESIGN.md §12), in the "
        "reference's format",
    )
    ap.add_argument(
        "--checkpoint-every",
        type=int,
        default=4,
        metavar="CHUNKS",
        help="checkpoint every K streamed chunks (0 disables the periodic "
        "snapshots while keeping the recovery supervisor active)",
    )
    ap.add_argument(
        "--checkpoint-keep", type=int, default=3,
        help="checkpoints retained on disk (older ones are GCed)",
    )
    ap.add_argument(
        "--restore",
        action="store_true",
        help="restore the latest checkpoint from --checkpoint-dir and "
        "resume at its saved log cursor (the CLI args must match the "
        "checkpointed run so the rebuilt log is identical)",
    )
    ap.add_argument(
        "--inject-fault-at",
        type=int,
        action="append",
        default=None,
        metavar="CHUNK",
        help="recovery drill: raise InjectedFault before chunk CHUNK "
        "(one-shot, repeatable); the supervisor restores the latest "
        "checkpoint and replays the log suffix",
    )
    ap.add_argument(
        "--max-restarts", type=int, default=5,
        help="restarts tolerated before the fault is re-raised",
    )
    ap.add_argument(
        "--backoff-s", type=float, default=0.0,
        help="delay before each restart",
    )
    ap.add_argument(
        "--trace-out",
        default=None,
        metavar="TRACE_JSON",
        help="enable the structured tracer and export a Chrome-trace JSON "
        "(loadable in ui.perfetto.dev / chrome://tracing) with spans for "
        "update batches, sweep iterations, kernel dispatches, repairs, "
        "governor actions, and checkpoints (DESIGN.md §15)",
    )
    ap.add_argument(
        "--metrics-out",
        default=None,
        metavar="METRICS_JSON",
        help="write a JSON snapshot of the obs metrics registry (counters / "
        "gauges / histograms incl. the DC probes) at end of run",
    )
    ap.add_argument("--json", action="store_true", help="emit a JSON result line")
    args = ap.parse_args(argv)
    if args.batch < 1:
        ap.error("--batch must be >= 1")
    if args.restore and args.checkpoint_dir is None:
        ap.error("--restore needs --checkpoint-dir")
    if args.inject_fault_at and args.checkpoint_dir is None:
        ap.error("--inject-fault-at needs --checkpoint-dir (the drill "
                 "restores from it)")
    if args.plan_file is not None and args.register_at:
        ap.error(
            "--register-at derives churn plans from --query and cannot "
            "be combined with --plan-file (one session, one family)"
        )
    if args.emulate_devices and args.mesh != "data":
        ap.error("--emulate-devices needs --mesh data")
    if args.smoke:
        args.v, args.e = min(args.v, 64), min(args.e, 256)
        args.queries = min(args.queries, 4)
        args.updates, args.batch = min(args.updates, 32), min(args.batch, 8)
        args.max_iters = min(args.max_iters, 24)
    serve(args)


if __name__ == "__main__":
    main()
