#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py        # from the repo root; needs one CUDA device and nvcc

Phases, each printing one JSON line (any failure raises and exits nonzero):

1. ``env``     torch/CUDA versions, the card, its power limit.
2. ``build``   every CUDA source under ``src/repro_torch/kernels/csrc/``
               compiled by ``nvcc`` (one process each, all started together).
               While the others compile, once K5's is built,
               ``lm_train_card_vs_cpu`` (its line prints first): the three
               LM configs at full widths cut to 2 layers, float32, TF32
               off, 2 x 128 tokens: loss (1e-6) and gradient leaves
               (1e-4), card against CPU, and one AdamW step on the CPU's
               gradients (1e-6; qwen2-moe's expert stacks cut to their
               first 8 of 64 experts) (the CPU half on all cores but one,
               which nvcc keeps).  ``build``'s seconds run from the first
               nvcc's start to the last one's end; the check has its own.
               ``flash_sass``: tensor-core instructions (HMMA / HGMMA) per
               kernel of the built ``flash_attn`` library (``cuobjdump
               -sass``); the bf16 prefill kernels must have them.
3. ``kernel_small``  each kernel against its plain PyTorch version at ragged
               small shapes: ``ell_spmv`` for the four semirings (min family
               bit-exact, ``pr_sum`` at rtol 1e-6), also on the engine's
               transposed path at the ragged shapes ``RAGGED`` (a padding
               cell first, a row of padding only, views off 16-byte
               alignment); ``fused_sweep`` for four semirings x three drop
               modes on random stores with full rows, padding and repeated
               iterations (every output bit-equal; ``pr_sum``'s plain
               version takes the ELL kernel's expand, which is the same
               device code), and at ``RAGGED`` in place and out of place,
               on aligned copies and on misaligned views; ``bloom_query``
               bit-equal at N tails (0, 1, 3, 5, 4097), M a power of two
               or not, k from 1 to 8 and Q = 9, on aligned copies and on
               misaligned views; on a shard's rows (the vertex-sharded
               sweep) ``ell_spmv`` with states wider than its rows and
               ``fused_sweep`` at a global offset ``off`` != 0, in and out of
               place and in the ``new=`` form, every drop mode (the offset
               must move some drop or repair);
               ``diff_lookup`` bit-equal.  ``kernel_small_flash``: K5
               (``flash_attention``) against its plain version at head
               dims 16, 64 and 128 over causal and not, GQA/MQA, ragged
               Sq/Sk, decode rows, bf16 and f32, contiguous and strided k/v
               (288 cases; float32: 2e-5 absolute; bfloat16: 2^-6 of each
               output row's largest value), and 8 cases of the
               transformer's form at D = 128 in bf16 (q scaled by D**-0.5
               in bf16 first, ``scale=1.0``; prefill and decode).
4. ``main``    the slice at real size: 8 SSSP queries
               (``repro_torch.core.queries.sssp``, ``backend="ell"``,
               ``max_iters=48``, ``batch_capacity=32``, S=16) on a uniform
               directed graph at the size of SNAP cit-Patents (3,774,768
               vertices, 16,518,948 edges, weights 1..10, split 90/10), fed
               64 updates (``MAIN_UPDATES``) of a stream with 20% deletes
               in chunks of 32 through
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
   ``main_sharded``  cell patents-uniform-fused-prob-shard4: the Prob-Drop
               run again on a 4-shard mesh emulated on the one card
               (``make_data_mesh(4, emulate=True)``): every chunk's
               ``MaintainStats``, the answers and the Bloom bits equal the
               unsharded run's, K2 launches 4 × the sweep iterations; the
               accounted bytes per shard each chunk, the ``ShardIndex``
               build time, device memory.  Its throughput is the cost of
               emulating four shards on one card, not a speed of sharding.
   ``main_session``  the session layer at the same size:
               ``CQPSession(engine="dense", backend="fused",
               batch_capacity=32, budget_bytes=B)`` with B 60% of the
               ``main_fused`` none run's peak accounted bytes (the governor
               provisions Det-Drop at p = 0); 4 SSSP queries registered in
               one batch, 128 updates, 4 more (the pool grows 4 → 8), 128
               more, 2 deregistered, one profiled chunk.  Every live query
               equals SCRATCH, the late ones a ``DiffIFE`` run that had
               them from the start, each deregistration frees the slot's
               ``slot_nbytes``, K2 launches once per sweep iteration;
               throughput, registration walls, the governor's actions, peak
               accounted bytes against B and the ungoverned run, each
               ``shed_slot``'s time and device memory.
   ``main_vdc``  (one line per run) the same graph, sources and stream with
               ``mode="vdc"`` (S_J = 8) on ``coo`` and ``fused``: answers
               equal SCRATCH (``scratch_mismatches`` 0), the two runs
               leaf-equal, ``diff_lookup`` twice per sweep iteration.
   ``main_landmark``  the plan optimizer at the same size: a copy of the
               graph under ``CQPSession(engine="dense", backend="fused",
               optimize="always")`` with the ``LandmarkRule`` default L = 4;
               8 SPSP plans from the main path's sources to ``(s + V // 2)
               % V`` (``cqp_serve --query spsp``), ``max_iters=48``; the
               stream's first 64 updates in 2 chunks of 32, every target
               read after every chunk.  Every target equals SCRATCH (8
               un-rewritten SSSP runs) bit for bit.  Reports the index
               build (``transpose_graph``, the twin over Gᵀ, the
               registration sweeps), per chunk the wall, the host engine's
               and the twin's maintenance and the refresh (triangle bounds
               and pruned Bellman-Ford), pruned iterations and the work cut
               ``1 − work / (iters × Q × V)``, the index's bytes, peak
               device memory and K2's launches (the forward index rows).
   ``main_serve``  the serving tier at the same size:
               ``build_serving_session(engine="dense", backend="fused",
               batch_capacity=32)`` with Prob-Drop provisioned at p = 0 and
               ``main_fused`` prob's 2**26 Bloom bits a query (the
               reference scenario's 2**10 saturates at 3.77 M vertices)
               under a ``CQPServer`` with the reference scenario's
               ``ServerConfig`` (admission on, chunks of 32, a checkpoint
               every 2 chunks, 3 restarts) but ``checkpoint_keep=2`` (about
               5 GB a snapshot; the free disk is checked for 3 before the
               first write, the directory under ``build/chip_smoke/``
               removed after).  3 tenants register 8 SSSP queries (3/3/2);
               the stream goes in round-robin in 6 rounds of 32 updates,
               every ticket reads after every round; one query is
               deregistered after round 4 (past ckpt@4, so the control-log
               replay carries it) and an ``InjectedFault`` fires before
               chunk 5 (restore ckpt@4, replay chunk 4).  The last reads
               (covering the whole stream) must be fresh and equal SCRATCH
               on the final graph bit for bit, and equal a second server
               run of the same traffic with no fault and no checkpoint
               directory, with the same per-query accounted bytes; the
               history must hold exactly the one injected fault; K2 must
               launch once per sweep iteration (registrations and the
               replay included; ``engine.maintain`` wrapped to count them).
               Reports updates/s with and without checkpointing, maintain
               and read latency, each checkpoint's wall split (``state_dict``,
               the wait on the previous write, the write) and host bytes,
               the restore split (load, graph, engine build, import) and the
               replay, device memory over the phase and across the restore,
               the epoch-view refresh and the executor hop.
6. ``parity_fused``  ``ell`` against ``fused`` at V = 2**16 for the four
               semirings x three drop modes: every state leaf and stat.
               ``parity_sharded``: 2 and 4 shards emulated on the card
               against the unsharded engine at V = 2**16, {coo, ell, fused}
               x JOD {none, det, prob} and VDC on coo and fused, after every
               chunk (VDC's ``jwritten`` aside: a reinserted edge's J rows
               follow its cell), PageRank at rtol 1e-6, and a stream that
               overflows the fullest shard's cells and the ELL width.
               ``parity_session``: sessions at V = 2**16 whose pools grow
               1 → 8 by single registrations, with a shed, a join flip and
               a deregistration between chunks, on coo/ell/fused (JOD),
               ell/fused (det, prob) and coo/fused (VDC): leaf-equal within
               a drop mode, JOD equal to SCRATCH; the fused det session's
               ``export_state`` imports into a CPU engine that ends
               leaf-equal after one more chunk on both.
               ``cqp_serve_drill``: ``python -m
               repro_torch.launch.cqp_serve --json`` at its defaults (V 512,
               E 2048, 8 queries, 256 updates, chunks of 32) as
               subprocesses, on ``fused`` and on ``ell`` side by side: a
               plain run, a drill (a checkpoint every 2 chunks, a fault
               before chunk 3) and a ``--restore``; per-query bytes and
               answer digests equal across the three, and the backend's
               kernel launched; beside them ``--query spsp --optimize
               always`` on each backend, plain and drill, whose target
               answers equal a ``--engine scratch`` run's; on ``fused``
               ``--mesh data --shards 4 --emulate-devices 4`` plain and
               drilled, and its checkpoint restored at ``--mesh none``, with
               the unsharded plain run's digests (five chains side by side,
               started with ``train_drill``'s processes before
               ``parity_fused`` and collected after ``parity_planner``: the
               parity phases time nothing; both lines print after
               ``parity_planner``).
               ``parity_planner``: ``CQPSession(optimize="always")`` at V =
               2**16 on ``fused``, the card against the port's CPU run on
               the same inputs (pruned fields, ``iters``, ``work`` and the
               planner's snapshot equal); one governed leg at a starved
               budget (the index sheds, answers stay exact, the budget is
               raised, the index re-materialises); one checkpoint →
               restore → replay with the index live.
7. ``main_lm``  llama3.2-1b serving at its published widths in bf16
               (weights from a seeded generator): ``make_prefill`` on 8 x
               4096 tokens, 32 greedy ``make_decode`` steps, then
               ``lm_serve`` at the CLI defaults on ``arch.full()``; K5's
               launches must equal layers x calls; prefill tokens/s, decode
               step p50/p99, peak memory, one profiled prefill and decode
               step, and the plain path (attention through
               ``chunked_attention``) teacher-forced on the same tokens,
               picking the kernel path's token at least 0.9 of the time.
               ``main_lm_long``: prefill 1 x 32768, then 8 decode steps at
               batch 32 against a 32768-position cache from the generator,
               held to the same floor.
               ``main_lm_f32``: full width in float32, TF32 off, 2 x 1024
               and 8 steps; logits within 1e-4 of the plain path's.
               ``main_moe``: qwen2-moe-a2.7b at its published widths in
               bf16 (the init's peak memory at most one float32 slice above
               the weights): prefill 8 x 4096 and 16 decode steps (K5 one
               launch a layer a call), the dropped share of the routed
               choices at prefill and decode, layer 0's router logits routed
               on the card and on the host (top-k, slots and per-expert
               counts equal), the plain path teacher-forced (top-1 >= 0.9),
               the logits of the kernel path's q scaling (q * D**-0.5 in
               bf16, then ``scale=1.0``, as the reference rounds it) against
               the plain path's at D = 128, one profiled prefill and decode
               step split by profiler
               range (attention, dispatch, expert products, combine), then
               ``lm_serve`` at the CLI defaults.  ``main_moe_long``: 24
               decode steps at batch 4 against a 32768-position cache from
               the generator, held to the same floor.  ``main_mla``:
               minicpm3-4b likewise (MLA: ``chunked_attention``, no K5):
               prefill 4 x 4096 and 8 steps, its decode logits against one
               forward over the same tokens (within 5e-2 of the largest
               |logit|), a batch-4 32k decode, ``lm_serve``, and 2 layers at
               full width in float32 on the card against the CPU (1e-4).
               ``main_qwen72b``: qwen2-72b at its published widths cut to 8
               layers, bf16: prefill 4 x 4096 through K5 (64/8 heads, D =
               128) and 8 decode steps (K5 one launch a layer a call), one
               profiled prefill and decode step; the same 8 steps
               teacher-forced under an emulated (1, 4) ``("data",
               "model")`` mesh, where every decode attention is
               ``dlse_decode_attention`` over the cache split along its
               sequence (K5 launches none; the blocks are views of the
               cache), and on the plain path, each picking the kernel
               path's token at least 0.9 of the time; a ``decode_32k``
               run at batch 16 (17.2 GB of cache from the generator) on K5
               and on the dlse path; and 2 layers in float32, TF32 off,
               where the K5 path's and the dlse path's logits are each
               within 1e-4 of the plain path's largest |logit|.  The dlse
               step times are the cost of emulating the mesh on one card.
               ``main_arctic``: arctic-480b at its published widths cut to
               2 layers (55.4 GB of bf16 weights): prefill 4 x 4096 through
               K5 (56/8 heads; expert capacity 320) and 8 decode steps, the
               dropped shares, layer 0's routing on the card against the
               CPU, the plain path and the dlse path with the routes
               forced (top-1 >= 0.9), then 8 decode steps at batch 8 (the
               capacity floor: one slot an expert) and their dropped share.
               ``mla_dlse``: minicpm3-4b at full widths, 2 layers, float32,
               the decode under the (1, 4) mesh
               (``dlse_mla_decode_attention``) against the port's own MLA
               decode within 1e-4 of the largest |logit| (a check only).
               ``main_mind``: MIND's ``serve_p99`` on the card against the
               CPU (rtol 1e-5), then ``serve_p99``, ``serve_bulk`` and
               ``retrieval_cand`` timed, and ``mind_serve``.
               ``main_lm_train`` (after ``main_lm_long``, on its weights):
               llama3.2-1b's ``train_4k`` at full width in bf16 with remat,
               cut to 16 x 4096 a step in 8 microbatches of 2, through
               ``launch/train.lm_setup`` (``make_train_step``, AdamW at lr
               3e-4): one warm-up and 4 timed steps, K5's launches exactly
               16 layers x 8 microbatches x 2 (the forward and the remat
               recompute, through ``FlashAttention``) a step; step
               p50/p99, tokens/s, the bf16 peak share of 6 x params x
               tokens, peak memory, one profiled step split by range (K5's
               forward, its plain backward, MLP, loss, AdamW); every loss
               finite and, over 3 steps on one fixed 2 x 4096 batch, the
               lowest later loss below the first.  ``main_mind_train``:
               MIND's ``train_batch`` uncut (B = 65,536) through
               ``launch/train.mind_setup`` under deterministic algorithms,
               one warm-up and 4 timed steps (step ms, users/s, peak
               memory), then the card against the CPU at B = 1,024 (loss
               1e-6, leaves 1e-5).  ``k5_grad``: ``FlashAttention``'s dq,
               dk, dv on the card against autograd through
               ``flash_attention_plain`` at llama's heads (2 x 32/8 x 4096,
               D 64) and qwen2-moe's (16/16, D 128), float32 (1e-4 of each
               gradient's largest value) and bf16 (2^-6); the plain
               backward timed beside SDPA's backward (a yardstick only).
8. ``kernel_real``  each kernel against its plain version at the main
               path's shapes, timed with CUDA events, beside its bound:
               ``ell_spmv`` on the ``main`` engine's ELL arrays (for
               ``pr_sum`` also one ``torch.sparse.mm`` over the same CSR);
               ``fused_sweep`` on one captured call of each ``main_fused``
               run (its working stores cloned when kept), in place (the
               main path's form; the stores restored before each call,
               outside the timed window) and out of place, each bit-equal to
               the plain version (the function's bound, counted on that
               call's data, and beside it the floor of the earlier
               out-of-place design);
               ``bloom_query`` on the prob run's filter, packed, also
               held against ``core.bloom.query`` for every (v, i) probe of
               one query, then timed on two key sets (every vertex at
               i = 2; seeded random (v, i <= max_iter)), each bit-equal to
               the plain version and ``core.bloom.query``, beside the
               index-only yardstick (``torch.take`` of the words its early
               exit reaches) and its time on an L1-sized filter row;
               ``diff_lookup`` on the J and Det stores;
               ``flash_attention`` on the first prefill and decode call of
               ``main_lm``, ``main_lm_long``, ``main_moe``,
               ``main_moe_long``, ``main_qwen72b`` (4 x 64/8 x 4096, D =
               128) and ``main_arctic`` (4 x 56/8 x 4096), whose operands
               are kept by running those calls again after the timed run, and on
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
10. ``main_gnn``  (one line per cell) GNN training at ``full()`` widths,
               float32, TF32 off: PNA, GatedGCN and DimeNet on
               ``minibatch_lg`` (a seeded uniform base graph at Reddit's
               size, 232,965 vertices and 114,615,892 edges, 602 features
               and 47 labels a vertex; PNA and GatedGCN a fresh
               ``sample_subgraph`` a step, 1,024 seeds, fanout 15-10;
               DimeNet one sample and its triplets), all four on
               ``full_graph_sm`` (Cora's sizes, seeded) and DimeNet and
               EquiformerV2 on ``molecule`` (128 graphs of 30 nodes and 64
               edges): one warm-up and 8 timed steps through
               ``launch/train.gnn_setup`` (forward, backward, AdamW at lr
               1e-3), step p50/p99, nodes/s or graphs/s, the float32 rate
               share of ``model_flops_estimate``, host sampling and
               triplet ms, every loss, peak memory, one profiled step (top
               kernels).  Every loss and gradient norm
               finite; on a fixed batch the last loss below the first; the
               five kernels launched no time (the GNN path reaches none, as
               in the reference).  ``gnn_card_vs_cpu``: each arch at full
               widths on a small seeded batch, the card's loss (rtol 1e-5)
               and gradient leaves (1e-4 of each leaf's largest value)
               against the port's CPU run on the same parameters, and one
               AdamW step on the CPU's gradients on both.  ``train_drill``
               (run beside the parity phases, above):
               ``python -m repro_torch.launch.train`` subprocesses on the
               card, GatedGCN, llama3.2-1b and MIND each 20 steps with a
               fault before step 15 and without (deterministic algorithms):
               one restart, the injected fault alone, losses and final
               parameters bit-equal; and EquiformerV2 for 5 steps.


Every phase line carries ``phase_s``, the wall seconds since the line
before it, so the lines split the run's wall: the real-size kernel timings
of ``kernel_real`` fall in the line of the run whose state they use (K3's,
on a host copy of the prob run's filter, in ``kernel_real``); and
``gc_s`` / ``gc_full``, the part of it in Python's collector.  Then
the ``kernels`` line, the card's ``nvidia-smi`` name and power limit, and
last ``{"ok": true, "device": {...}}``.  There is no CPU path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
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
# updates a run takes from the stream (chunks of 32, the first a warm-up):
# main, main_fused and main_sharded 64 (256 until the GNN phase took the
# time, 128 until the training phases did), main_vdc 64 (256, then 96),
# main_serve 192 (256: 6 rounds, the fault still before chunk 5); the
# stream holds 256 + one chunk (main_session's two legs of 128)
STREAM_UPDATES = 256
MAIN_UPDATES = 64
VDC_UPDATES = 64
SERVE_UPDATES = 192
# the V = 2**16 streams of parity_fused, parity_sharded and parity_vdc: one
# chunk of 32 (96 until the training phases took the time; parity_vdc's
# join-flip run splits it in two; parity_session and parity_planner keep
# their three chunks)
PARITY_UPDATES = 32
LANDMARK_UPDATES = 64  # main_landmark: two chunks (128 until the training phases)
# the CLI drills' subprocesses (small graphs, smoke configs) run beside the
# parity phases: one CPU thread each, or a dozen of them at the card's eight
# host cores' worth of threads apiece oversubscribe the host
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


_last_line = time.perf_counter()  # when the previous phase line was printed
# Python's collector since the previous line: seconds, and full (generation
# 2) collections, which walk every tracked object (the host graphs hold
# tens of millions)
_gc = {"s": 0.0, "full": 0, "t0": 0.0}


def _time_gc(step: str, info: dict) -> None:
    if step == "start":
        _gc["t0"] = time.perf_counter()
    else:
        _gc["s"] += time.perf_counter() - _gc["t0"]
        _gc["full"] += info["generation"] == 2


def emit(phase: str, **fields) -> None:
    """Print one phase's JSON line, with ``phase_s``: the wall seconds since
    the previous line (the first: since the script started), so the lines
    split the run's wall between them; ``gc_s`` and ``gc_full`` of it went
    to Python's collector."""
    global _last_line
    now = time.perf_counter()
    print(json.dumps({"phase": phase, **fields, "phase_s": now - _last_line, "gc_s": _gc["s"],
                      "gc_full": _gc["full"]}), flush=True)
    _last_line = now
    _gc.update(s=0.0, full=0)


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


def device_ms_by_range(events, names) -> dict:
    """Device time (kernels, copies, sets) launched inside each profiler
    range (``record_function``, ``repro_torch.models.common.profile_range``)
    named in ``names``, each launch charged to the innermost such range
    around its CUDA runtime call; ``unattributed`` holds the rest."""
    import bisect

    ranges = sorted((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]), ev["name"]) for ev in events
                    if ev.get("ph") == "X" and ev.get("cat") == "user_annotation" and ev.get("name") in names)
    starts = [r[0] for r in ranges]
    launched = {ev["args"]["correlation"]: float(ev["ts"]) for ev in events
                if ev.get("ph") == "X" and ev.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in ev.get("args", {})}
    out = {n: 0.0 for n in (*names, "unattributed")}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        ts = launched.get(ev.get("args", {}).get("correlation"))
        name = "unattributed"
        if ts is not None:
            i = bisect.bisect_right(starts, ts) - 1
            while i >= 0 and ranges[i][1] < ts:  # siblings that ended before the launch
                i -= 1
            if i >= 0:
                name = ranges[i][2]
        out[name] += float(ev["dur"]) / 1e3
    return out


def device_busy(prof, path: Path, k5: bool = False, ranges=()) -> dict:
    """Device-busy time of a profiled window from its Chrome trace (kernels,
    copies and sets on the card), plus the top kernels by time, with ``k5``
    the time of K5's kernels, and with ``ranges`` the device time under each
    named profiler range (:func:`device_ms_by_range`)."""
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
    if ranges:
        out["device_ms_by_range"] = device_ms_by_range(events, ranges)
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


def time_ms(fn, reps: int = 25, warmup: int = 3, setup=None) -> float:
    """Median of ``reps`` CUDA-event-timed calls, after ``warmup`` calls;
    ``setup`` (restoring what a call writes in place) runs before each call,
    outside the timed window."""
    import torch

    for _ in range(warmup):
        if setup is not None:
            setup()
        fn()
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
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


def misaligned(t):
    """A contiguous copy of ``t`` whose data does not start on 16 bytes (the
    kernels' word paths)."""
    import torch

    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    off = (4 - (buf.data_ptr() // t.element_size()) % 4) % 4 + 1
    out = buf[off : off + t.numel()].view(t.shape)
    out.copy_(t)
    return out


# ragged shapes of the GPU tests: Q in {1, 3, 8, 9}, V no multiple of a row
# tile, odd D, D = 101 too wide for K1's shared-memory tiles, S in {4, 6,
# 16, 32} (Q, V, D, S)
RAGGED = [(1, 65, 24, 4), (3, 130, 7, 6), (8, 1000, 24, 16), (9, 333, 6, 32), (8, 300, 101, 16)]


def kernel_small(device) -> dict:
    """Every kernel against its plain version at ragged small shapes."""
    import torch

    from repro_torch.core import diffstore as ds

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
        # the engine's transposed path: a padding cell first, a row of
        # padding only, and views off 16-byte alignment
        for q, v, d, _ in RAGGED:
            for form in ("aligned", "states", "adjacency"):
                states, nbr, w, carry = ell_inputs(rng, q, v, d, semiring, device)
                nbr[0, 0] = v
                nbr[1, :] = v
                w[0, 0] = w[1, :] = 0.0
                states_t = states.t().contiguous()
                if form == "states":
                    states_t = misaligned(states_t)
                if form == "adjacency":
                    nbr, w = misaligned(nbr), misaligned(w)
                got = K1.ell_spmv(states_t, nbr, w, carry, semiring=semiring, hop_cap=cap, transposed=True)
                err1 = max(err1, compare(semiring, got, K1.ell_spmv_ref(states, nbr, w, carry, semiring=semiring,
                                                                         hop_cap=cap)))
                if not torch.equal(got[:, 1], carry[:, 1]):
                    raise AssertionError(f"{semiring}: a row of padding only moved off its carry")

    # K1 on a shard's rows (the vertex-sharded sweep): states over every
    # vertex, wider than the rows, neighbour ids up to the full extent
    cases1w = 0
    for semiring in K1.SEMIRINGS:
        cap = 4.0 if semiring == "min_hop" else float("inf")
        for q, v, d, n_sh in [(3, 100, 8, 4), (8, 333, 24, 2), (8, 300, 101, 4)]:
            states, nbr, w, carry = ell_inputs(rng, q, v * n_sh, d, semiring, device)
            nbr, w, carry = nbr[:v].contiguous(), w[:v].contiguous(), carry[:, :v].contiguous()
            want = K1.ell_spmv_ref(states, nbr, w, carry, semiring=semiring, hop_cap=cap)
            err1 = max(err1, compare(semiring, K1.ell_spmv(states, nbr, w, carry, semiring=semiring,
                                                           hop_cap=cap), want))
            err1 = max(err1, compare(semiring, K1.ell_spmv(states.t().contiguous(), nbr, w, carry,
                                                           semiring=semiring, hop_cap=cap, transposed=True),
                                     want))
            cases1w += 2

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

    # K2 in place and out of place at the ragged shapes, with every store,
    # the states and the adjacency as aligned copies or as views off 16-byte
    # alignment; in place the outputs must be the stores passed in, and the
    # old store never changes
    clone = lambda st, f: ds.DiffStore(*map(f, st))  # noqa: E731
    cases2i = 0
    for q, v, d, s in RAGGED:
        for semiring in K1.SEMIRINGS:
            for mode in K2.DROP_MODES:
                args, kw = fused_inputs(rng, q, v, d, s, semiring, mode, device)
                expand = K1.ell_spmv if semiring == "pr_sum" else K1.ell_spmv_ref
                want = K2.fused_sweep_ref(*args, **kw, expand=expand)
                for inplace in (False, True):
                    for move in (torch.clone, misaligned):
                        work, old = clone(args[6], move), clone(args[7], move)
                        old_before = clone(old, torch.clone)
                        kw2 = {**kw, "states": move(kw["states"].t().contiguous()), "transposed": True,
                               "nbr": move(kw["nbr"]), "w": move(kw["w"])}
                        if mode == "det":
                            kw2["det"] = clone(kw["det"], move)
                        got = K2.fused_sweep(*args[:6], work, old, **kw2, inplace=inplace)
                        err2 = max(err2, same_fused(got, want))
                        if not all(torch.equal(a, b) for a, b in zip(old, old_before)):
                            raise AssertionError("fused_sweep wrote into the old store")
                        if inplace and (got.d_iters is not work.iters
                                        or (mode == "det" and got.det_iters is not kw2["det"].iters)):
                            raise AssertionError("fused_sweep(inplace=True) returned other stores")
                        cases2i += 1

    # K2 on a shard's rows: the block's global offset `off` reaches the coin
    # and the Bloom key, the expand gathers from states over every vertex;
    # out of place and in place, expand and new= forms, each drop mode
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    cases2o, moved = 0, 0
    for q, v, d, s, n_sh in [(3, 100, 8, 16, 4), (2, 257, 16, 16, 2), (8, 300, 24, 16, 4)]:
        full = v * n_sh
        for off in (v, (n_sh - 1) * v):
            for semiring in ("min_plus", "pr_sum"):
                for mode in K2.DROP_MODES:
                    args, kw = fused_inputs(rng, q, v, d, s, semiring, mode, device)
                    wide, _, _, _ = ell_inputs(rng, q, full, d, semiring, device)
                    kw.update(states=wide, nbr=t(rng.integers(0, full + 1, size=(v, d)).astype(np.int32)))
                    expand = K1.ell_spmv if semiring == "pr_sum" else K1.ell_spmv_ref
                    want = K2.fused_sweep_ref(*args, **kw, off=off, expand=expand)
                    err2 = max(err2, same_fused(K2.fused_sweep(*args, **kw, off=off), want))
                    work = clone(args[6], torch.clone)
                    det = {"det": clone(kw["det"], torch.clone)} if mode == "det" else {}
                    err2 = max(err2, same_fused(K2.fused_sweep(*args[:6], work, args[7], **{**kw, **det},
                                                               off=off, inplace=True), want))
                    if semiring == "min_plus":
                        new = {k: x for k, x in kw.items() if k not in ("states", "nbr", "w", "kcarry")}
                        new["new"] = want.cur.clone()
                        err2 = max(err2, same_fused(K2.fused_sweep(*args, **new, off=off),
                                                    K2.fused_sweep_ref(*args, **new, off=off)))
                        cases2o += 1
                    if mode != "none":
                        at0 = K2.fused_sweep_ref(*args, **kw, expand=expand)
                        moved += not (torch.equal(at0.to_drop, want.to_drop) and torch.equal(at0.repair, want.repair))
                    cases2o += 2
    if not moved:
        raise AssertionError("fused_sweep: the offset never moved a drop or a repair")

    # K2's new= variant (VDC): the candidate comes in, nothing depends on
    # the semiring, so one case per drop mode and shape
    cases2n, err2n = 0, 0.0
    for q, v, d, s in [(1, 16, 4, 4), (3, 100, 8, 16), (2, 257, 16, 16), (3, 131, 8, 32)]:
        for mode in K2.DROP_MODES:
            args, kw = fused_inputs(rng, q, v, d, s, "min_plus", mode, device)
            for k in ("states", "nbr", "w", "kcarry"):
                del kw[k]
            kw["new"] = torch.from_numpy(rng.integers(0, 7, size=(q, v)).astype(np.float32)).to(device)
            want = K2.fused_sweep_ref(*args, **kw)
            err2n = max(err2n, same_fused(K2.fused_sweep(*args, **kw), want))
            work = clone(args[6], misaligned)
            det = {"det": clone(kw["det"], misaligned)} if mode == "det" else {}
            err2n = max(err2n, same_fused(K2.fused_sweep(*args[:6], work, args[7], **{**kw, **det},
                                                         inplace=True), want))
            cases2n += 2

    # K4: ragged N (no multiple of the 256-thread block), S from 1 to 32
    # (6 takes the scalar loads), per-row and scalar query iterations
    cases4, err4 = 0, 0.0
    for n, s in [(1, 1), (1000, 1), (777, 6), (4097, 8), (300, 32)]:
        iters, vals, qi = lookup_inputs(rng, n, s, device)
        for q_arg in (qi, 7, int(iters[0, 0]) if n else 0, -1, 2**31 - 1):
            err4 = max(err4, same_lookup(K4.diff_lookup(iters, vals, q_arg), K4.diff_lookup_ref(iters, vals, q_arg)))
            cases4 += 1

    # K3: N tails (0, 1, 3, 5, 4097 keys: rows that start on every offset
    # mod 4), M a power of two or not (1184 = 32 x 37; 32 x 37 x 101), k from
    # 1 to 8, Q = 9, fuller rows for deeper probes; each case on aligned
    # copies and with every operand off 16 bytes (the kernel's scalar path)
    cases3, err3 = 0, 0.0
    for q, n, mbits, k in [(1, 64, 1 << 10, 2), (3, 500, 1 << 12, 4), (2, 1024, 1 << 14, 6), (3, 0, 1 << 10, 4),
                           (3, 1, 1 << 10, 1), (3, 3, 1184, 8), (9, 5, 1 << 10, 8), (9, 4097, 1184, 4),
                           (9, 4097, 32 * 37 * 101, 1), (8, 4097, 1 << 12, 8)]:
        t = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
        words = K3.pack_bits(t(rng.random((q, mbits)) < np.linspace(0.3, 0.9, q)[:, None]))
        v = t(rng.integers(0, 2**31 - 1, size=(q, n)).astype(np.int32))
        it = t(rng.integers(0, 64, size=(q, n)).astype(np.int32))
        salt = torch.arange(q, dtype=torch.int32, device=device)
        want = K3.bloom_query_ref(words, v, it, salt, num_hashes=k)
        for move in (torch.clone, misaligned):
            got = K3.bloom_query(*map(move, (words, v, it, salt)), num_hashes=k)
            err3 = max(err3, max_abs_diff(got, want))
            if not torch.equal(got, want):
                raise AssertionError(f"bloom_query differs from its plain version at Q, N, M, k = "
                                     f"{(q, n, mbits, k)} ({move.__name__})")
            cases3 += 1
    torch.cuda.synchronize()
    return {
        "ell_spmv": {"max_abs_err": err1, "semirings": list(K1.SEMIRINGS), "wide_states_cases": cases1w},
        "fused_sweep": {"cases": cases2, "in_place_and_view_cases": cases2i, "offset_cases": cases2o,
                        "offset_moved_drops": moved, "bit_equal": True,
                        "max_abs_err": err2, "pr_sum_expand_max_abs_err": expand_err},
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
        states_t = states.t().contiguous()  # as the engine hands them (transpose_states)
        call = lambda: K.ell_spmv(states_t, g.nbr, w, carry, semiring=semiring, hop_cap=cap,  # noqa: E731
                                  transposed=True)
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
        del got, states_t
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
    slot index's built arrays shared: they are never written), far cheaper
    than rebuilding one at cit-Patents size."""
    import copy

    out = copy.copy(graph)
    for name in ("src", "dst", "weight", "label", "valid", "out_degree", "in_degree"):
        setattr(out, name, getattr(graph, name).copy())
    out._slot = graph._slot.copy()
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
    bytes, total], summed over the shards of a sharded engine."""
    diff = sum(int(st.dstore.count.sum()) for st in eng.states) * 8
    join = sum(0 if st.jstore is None else int(st.jstore.count.sum()) for st in eng.states) * 8
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
    shapes; it calls the kernel unchanged.  From iteration 2 on the sweep
    writes its D and Det stores in place, so an in-place call's working
    stores are cloned before the call (later iterations overwrite the
    originals); an out-of-place call's are the frozen input state's."""

    def __init__(self, fn):
        self.fn, self.call = fn, None

    def __call__(self, i, *args, **kw):
        if self.call is None or (i == 2 and self.call[0][0] != 2):
            from repro_torch.core import diffstore as ds

            self.call = None  # one kept call's stores on the card at a time
            kept, kept_kw = args, dict(kw)
            if kw.get("inplace"):
                kept = (*args[:5], ds.DiffStore(*(t.clone() for t in args[5])), *args[6:])
                det = kw.get("det")
                if det is not None:  # the kernel never writes a Det row's values
                    kept_kw["det"] = ds.DiffStore(det.iters.clone(), det.vals, det.count.clone())
            self.call = ((i, *kept), kept_kw)
        return self.fn(i, *args, **kw)


def engine_init(eng):
    """The engine's D_0 rows over every vertex (a sharded engine's blocks
    concatenated, without assembling its whole state)."""
    import torch

    return torch.cat([st.init for st in eng.states], dim=1)


def run_stream(graph, sources, stream, *, device, backend: str, num_updates: int, chunk: int,
               counters, drop=None, mode: str = "jod", profile_path: Path | None = None,
               capture: Capture | None = None, mesh=None):
    """Drive ``queries.sssp`` on ``graph`` (mutated) through
    ``apply_updates_batched`` and hold the answers against SCRATCH: equal
    bit for bit, JOD and VDC alike (VDC's answers that differ are counted
    before the check fails).

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
        at_start = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        eng = tq.sssp(graph, sources, backend=backend, drop=drop, mode=mode, max_iters=48,
                      batch_capacity=chunk, store_capacity=16, mesh=mesh,
                      device=None if mesh is not None else device)
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()  # the chunks' own peak from here
        out = drive_chunks(eng, stream, num_updates=num_updates, chunk=chunk, counters=counters,
                           profile_path=profile_path, capture=capture)
    finally:
        ds.upsert_rows_ = tap.fn
    out.update(backend=backend, engine_mode=mode, drop=None if drop is None else dataclass_dict(drop),
               engine_init_s=init_s, memory_allocated_at_start=at_start,
               max_memory_allocated_init=init_peak,
               max_memory_allocated_chunks=out["max_memory_allocated"],
               max_memory_allocated=max(init_peak, out["max_memory_allocated"]))
    if mode == "vdc":
        out["jstore_evictions"] = 0 if tap.total is None else int(tap.total)
        out["jstore_rows_full"] = sum(int((st.jstore.count >= eng.cfg.jstore_capacity).sum()) for st in eng.states)
        out["jstore_capacity"] = eng.cfg.jstore_capacity
        out["jstore_rows"] = sum(int(st.jstore.count.numel()) for st in eng.states)

    ans = eng.answers()
    if ans.shape != (len(sources), graph.num_vertices) or np.isnan(ans).any():
        raise AssertionError(f"bad answers: shape {ans.shape}")
    if not all(ans[q, s] == 0.0 for q, s in enumerate(sources)):
        raise AssertionError("a source is not at distance 0")
    want = scratch_like(eng.cfg, eng.graph, engine_init(eng), device=device).answers()
    bad = np.argwhere(ans != want)
    if mode == "vdc":
        out["scratch_mismatches"] = int(bad.shape[0])
    if bad.shape[0]:
        first = [{"q": int(q), "v": int(v), "engine": float(ans[q, v]), "scratch": float(want[q, v])}
                 for q, v in bad[:5]]
        raise AssertionError(f"{mode}/{backend}: {bad.shape[0]} answers differ from SCRATCH, first {first}")
    out["equals_scratch"] = True
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
    per_device = [eng.nbytes_per_device()] if eng.num_shards > 1 else None
    n_chunks = num_updates // chunk
    sweeps_peak = 0
    for c, lo in enumerate(range(0, num_updates, chunk)):
        if c == n_chunks - 1:
            # the engine's own peak over the chunks so far: no kept call, no profiler
            sweeps_peak = torch.cuda.max_memory_allocated()
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
        if per_device is not None:
            per_device.append(eng.nbytes_per_device())
    launches = {K.__name__.rsplit(".", 1)[-1]: K.LAUNCHES for K in counters}  # ---- and ends here

    traced = {}
    if profile_path is not None:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            st = eng.apply_updates_batched(stream[num_updates : num_updates + chunk])
            wall = time.perf_counter() - t0
        profile_path.parent.mkdir(parents=True, exist_ok=True)
        traced = device_busy(prof, profile_path)
        traced.update(chunk_wall_ms=wall * 1e3, sweep_iters=int(st.iters_run))
        traced["device_idle_share"] = 1.0 - traced["device_busy_ms"] / traced["chunk_wall_ms"]
    else:
        st = eng.apply_updates_batched(stream[num_updates : num_updates + chunk])
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
        "max_memory_allocated_sweeps": sweeps_peak,
        "traced_chunk": traced,
        "chunk_stats": chunk_stats,
        **({} if per_device is None else {"nbytes_per_device_per_chunk": per_device}),
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


def fused_bounds_ms(args, kw, out) -> tuple[float, float]:
    """Least time for one ``fused_sweep`` call at 3.35 TB/s, counted two
    ways; the few integer and float operations per byte never bind.

    The function's bound reads each input once and writes each output once
    as this call's data (and ``out``, its plain version's result) needs
    them: the [Q, V] inputs; the candidate only for the (q, v) that are
    scheduled or repair, so the expand's adjacency rows of those vertices
    and the states of their neighbours, once (the ``new=`` form: those
    cells of ``new``); the iterations of every store row (the probes at
    ``i``), a value only where its column matches ``i``, and the values and
    count of the rows whose content changes (a point stored or removed),
    which alone need writing back (Det rows likewise: the rows a point is
    registered in, evicted from or unregistered from; of the Bloom rows one
    byte per probe).  The out-of-place floor is the earlier design's: every
    store row read and written each call, the whole adjacency and every
    state read.  Returns (function bound, out-of-place
    floor) in ms.
    """
    import torch

    from repro_torch.core import diffstore as ds

    i, sched, active, cur, cur_old, stale_old, dstore, old = args
    q, v = sched.shape
    qv, s, so = q * v, dstore.capacity, old.capacity
    mode = kw["drop_mode"]
    need = sched | out.repair
    n_need = int(need.sum())
    has_cur = ds.has_at(dstore, i)
    n_chg = int((out.to_store | out.vanish | (out.to_drop & has_cur)).sum())
    n_cur = int(has_cur.sum())
    n_old = int(ds.has_at(old, i).sum())
    # active, cur + cur_old, sched + stale_old
    base = q + qv * 4 * 2 + qv * 2
    if kw.get("new") is not None:
        rd = base + n_need * 4  # the candidate where it is read
        oop_rd = base + qv * 4
    else:
        d = kw["nbr"].shape[1]
        uses_w = kw["semiring"] in ("min_plus", "pr_sum")
        states = kw["states"] if kw.get("transposed") else kw["states"].t()  # [Vp, Q]
        rows = need.any(dim=0)
        nb = kw["nbr"][rows]
        live = torch.unique(nb[nb != states.shape[0] - 1]).numel() + 1  # and the sentinel
        own_carry = kw["kcarry"].data_ptr() != cur.data_ptr()
        rd = base + live * q * 4 + int(rows.sum()) * d * 4 * (2 if uses_w else 1)
        rd += n_need * 4 if own_carry else 0
        oop_rd = base + states.numel() * 4 + v * d * 4 * (2 if uses_w else 1)
        oop_rd += qv * 4 if own_carry else 0
    wr = qv * (4 + 4 + 4 + 7)  # cur, old, evicted_iter, seven masks
    if mode != "none":
        rd += v * 4 + q * 17  # degree, params
        oop_rd += v * 4 + q * 17
    if mode == "prob":
        probes = min(q * kw["bloom_bits"].shape[1], qv * kw["bloom_hashes"])
        rd += probes
        oop_rd += probes
    fn_rd = rd + qv * s * 4 + n_cur * 4 + n_chg * (s * 4 + 4) + qv * so * 4 + n_old * 4
    fn_wr = wr + n_chg * (s * 8 + 4)
    oop_rd += qv * (s * 8 + 4) + qv * (so * 4 + 4)
    oop_wr = wr + qv * (s * 8 + 4)
    if mode == "det":
        sd = kw["det"].capacity
        n_touch = int((out.to_drop | out.evicted | out.to_store | out.vanish).sum())
        fn_rd += qv * sd * 4 + n_touch * 4
        fn_wr += n_touch * (sd + 1) * 4 + q * 8
        oop_rd += qv * (sd + 1) * 4
        oop_wr += qv * (sd + 1) * 4 + q * 8
    return (fn_rd + fn_wr) / HBM_BYTES_PER_S * 1e3, (oop_rd + oop_wr) / HBM_BYTES_PER_S * 1e3


def fused_real(capture: Capture) -> dict:
    """K2 at the main path's shapes: the operands of one captured call (its
    working stores cloned when it was kept), timed in its in-place form (the
    working stores restored from that copy before each call, outside the
    timed window) and out of place; each held against the plain version bit
    for bit, on a fresh copy of the stores."""
    import torch

    from repro_torch.core import diffstore as ds
    from repro_torch.kernels import fused_sweep as K2

    args, kw = capture.call
    kw = {k: x for k, x in kw.items() if k != "inplace"}
    det = kw.get("det")
    stores = [*args[6]] + ([det.iters, det.count] if det is not None else [])

    def fresh():
        work = ds.DiffStore(*(t.clone() for t in args[6]))
        wdet = None if det is None else ds.DiffStore(det.iters.clone(), det.vals, det.count.clone())
        return work, wdet

    def in_place(work, wdet):
        extra = {} if wdet is None else {"det": wdet}
        return K2.fused_sweep(*args[:6], work, args[7], **{**kw, **extra}, inplace=True)

    out_of_place = lambda: K2.fused_sweep(*args, **kw)  # noqa: E731
    plain = lambda: K2.fused_sweep_ref(*args, **kw)  # noqa: E731
    host = lambda o: K2.FusedOut(*(None if x is None else x.cpu() for x in o))  # noqa: E731
    # the kernel's outputs wait on the host while the plain version, whose
    # temporaries take tens of GB at this size, runs
    got_oop = host(out_of_place())
    work, wdet = fresh()
    res = in_place(work, wdet)
    if res.d_iters is not work.iters or (wdet is not None and res.det_iters is not wdet.iters):
        raise AssertionError("fused_sweep(inplace=True) did not return the stores it was given")
    got_ip = host(res)
    del res
    torch.cuda.empty_cache()
    want = plain()
    err = 0.0
    for got in (got_oop, got_ip):
        err = max(err, same_fused(K2.FusedOut(*(None if x is None else x.to(w.device)
                                                for x, w in zip(got, want))), want))
    bound, floor = fused_bounds_ms(args, kw, want)
    del got_oop, got_ip, want
    torch.cuda.empty_cache()
    targets = [*work] + ([wdet.iters, wdet.count] if wdet is not None else [])

    def restore():
        for t, src in zip(targets, stores):
            t.copy_(src)

    ip_ms = time_ms(lambda: in_place(work, wdet), setup=restore)
    out = {
        "form": "new=" if kw.get("new") is not None else "expand",
        "i": args[0],
        "scheduled": int(args[1].sum()),
        "max_abs_err": err,
        "ms": ip_ms,  # the main path's form at this iteration: in place
        "in_place_ms": ip_ms,
        "out_of_place_ms": time_ms(out_of_place),
        "plain_ms": time_ms(plain, reps=3),
        "bound_ms": bound,
        "bound_by": "bytes",
        "out_of_place_floor_ms": floor,
        "library_ms": None,
    }
    del work, wdet
    torch.cuda.empty_cache()
    return out


L1_ROW_BITS = 1 << 20  # a 128 KB filter row: the SM's L1 holds it


def reached_words(words, v, i, salt, num_hashes: int):
    """Flat indices into ``words`` [Q, W] of every probe that K3's early exit
    reaches (a key's probes up to its first clear bit), key by key."""
    import torch

    from repro_torch.core.bloom import M32, hash_key

    q, w = words.shape
    h1, h2 = hash_key(v, i, salt[:, None])
    j = torch.arange(num_hashes, dtype=torch.int64, device=words.device)
    probes = ((h1[..., None] + ((j * h2[..., None]) & M32)) & M32) % (w * 32)
    flat = (probes >> 5) + torch.arange(q, device=words.device)[:, None, None] * w
    bit = (torch.take(words, flat).to(torch.int64) >> (probes & 31)) & 1
    reach = torch.cat([torch.ones_like(bit[..., :1]), bit[..., :-1].cumprod(-1)], -1).bool()
    return flat[reach]


def bloom_real(bits, num_hashes: int, max_iter: int, num_vertices: int, device) -> dict:
    """K3 on the prob run's filter (``bits`` kept on the host, so that its
    timing runs after the main-path phases and leaves their device memory
    as it was), packed: every (v, i <= max_iter) probe of query 0 against
    ``core.bloom.query``; then, over all queries, two
    timed key sets, each bit-equal to the plain version and to
    ``core.bloom.query``: every vertex at i = 2 (the set of earlier runs)
    and seeded random (v, i <= max_iter) keys.  Beside each set's time: the
    index-only yardstick, ``torch.take`` of the filter words at exactly the
    probe addresses the early exit reaches (computed outside the timed
    window), and K3 on the same keys against a random filter of
    ``L1_ROW_BITS`` a row at the run's fill, whose probes L1 serves; each
    also as ``device_ms`` (calls queued back to back, no host time)."""
    import torch

    from repro_torch.core import bloom as bloom_lib
    from repro_torch.kernels import bloom as K3

    t0 = time.perf_counter()
    flt = bloom_lib.BloomFilter(bits.to(device), num_hashes)
    q, m = flt.bits.shape
    v = num_vertices
    k = num_hashes
    words = K3.pack_bits(flt.bits)
    dev = flt.bits.device
    v_ids = torch.arange(v, dtype=torch.int32, device=dev)[None, :]
    row0 = bloom_lib.BloomFilter(flt.bits[:1], k)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    hits, lib_err = 0, 0.0
    for i in range(max_iter + 1):
        got = K3.bloom_query(words[:1], v_ids, torch.full_like(v_ids, i), zero, num_hashes=k)
        want = bloom_lib.query(row0, v_ids, i, salt=0)
        lib_err = max(lib_err, max_abs_diff(got, want))
        if not torch.equal(got, want):
            raise AssertionError(f"bloom_query differs from core.bloom.query at i={i}")
        hits += int(got.sum())
    fill = [float(x) for x in bloom_lib.fill_fraction(flt)]
    salt = torch.arange(q, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    l1_words = K3.pack_bits(torch.rand((q, L1_ROW_BITS), generator=gen, device=dev) < statistics.mean(fill))
    key_sets = {
        "i2": (v_ids.expand(q, v).contiguous(), torch.full((q, v), 2, dtype=torch.int32, device=dev)),
        "random": (torch.randint(0, v, (q, v), generator=gen, device=dev, dtype=torch.int32),
                   torch.randint(0, max_iter + 1, (q, v), generator=gen, device=dev, dtype=torch.int32)),
    }
    sets = {}
    for name, (kv, ki) in key_sets.items():
        call = lambda: K3.bloom_query(words, kv, ki, salt, num_hashes=k)  # noqa: E731
        plain = lambda: K3.bloom_query_ref(words, kv, ki, salt, num_hashes=k)  # noqa: E731
        got, want = call(), plain()
        err = max_abs_diff(got, want)
        if not torch.equal(got, want):
            raise AssertionError(f"bloom_query differs from its plain version at the real size ({name} keys)")
        want = bloom_lib.query(flt, kv, ki, salt[:, None])
        core_err = max_abs_diff(got, want)
        if not torch.equal(got, want):
            raise AssertionError(f"bloom_query differs from core.bloom.query at the real size ({name} keys)")
        positives = int(got.sum())
        del got, want
        idx = reached_words(words, kv, ki, salt, k)
        probes = idx.numel()
        take = lambda: torch.take(words, idx)  # noqa: E731
        l1_call = lambda: K3.bloom_query(l1_words, kv, ki, salt, num_hashes=k)  # noqa: E731
        # each key's v and i read and its answer written once; the filter
        # words at most once, and no more of them than the probes reach
        nbytes = q * v * 9 + q * 4 + min(q * m // 8, probes * 4)
        sets[name] = {
            "max_abs_err": err,
            "core_query_max_abs_err": core_err,
            "positives": positives,
            "probes_reached": probes,
            "probes_per_key": probes / (q * v),
            "ms": time_ms(call),
            "device_ms": device_ms_per_call(call),
            "plain_ms": time_ms(plain, reps=5),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "index_only_take_ms": time_ms(take),
            "index_only_take_device_ms": device_ms_per_call(take),
            # the yardstick's own bytes: an int64 index in, an int32 word out a probe
            "index_only_take_bound_ms": (probes * 12 + min(q * m // 8, probes * 4)) / HBM_BYTES_PER_S * 1e3,
            "l1_row_ms": time_ms(l1_call),
            "l1_row_device_ms": device_ms_per_call(l1_call),
        }
        del idx
    i2 = sets["i2"]
    return {
        "num_bits": m,
        "num_hashes": k,
        "fill_fraction": fill,
        "checked_probes_query0": (max_iter + 1) * v,
        "positives_query0": hits,
        "core_query_max_abs_err": max(lib_err, *(r["core_query_max_abs_err"] for r in sets.values())),
        "max_abs_err": max(r["max_abs_err"] for r in sets.values()),
        **{x: i2[x] for x in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "index_only_take_ms")},
        "library_ms": None,
        "key_sets": sets,
        "l1_row_bits": L1_ROW_BITS,
        "seconds": time.perf_counter() - t0,
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
        chunk_stats = out.pop("chunk_stats")
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
            del got  # else the next run starts with this state on the card
        if mode == "prob":
            flt = eng.state.drop.flt  # K3 is timed on it after the LM phases
            bits = flt.bits.cpu()
            real["bloom_filter"] = (bits, flt.num_hashes, int(eng.state.drop.max_iter), eng.cfg.num_vertices)
            out["bloom_fill_fraction"] = [float(x) for x in bits.sum(dim=-1) / bits.shape[-1]]
            # what main_sharded must reproduce bit for bit
            real["prob_run"] = {"answers": eng.answers(), "bits": bits, "chunk_stats": chunk_stats,
                                "policy": drop_policy(mode, 1 << 26)}
            del flt, bits
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


MAIN_SHARDS = 4  # main_sharded's mesh: shards emulated on the one card


def first_stats_difference(got: list, want: list) -> str | None:
    """Where two runs' per-chunk ``MaintainStats`` rows first part."""
    from repro_torch.core.engine import MaintainStats

    if len(got) != len(want):
        return f"{len(got)} chunks against {len(want)}"
    for c, (g, w) in enumerate(zip(got, want)):
        for f, a, b in zip(MaintainStats._fields, g, w):
            if a != b:
                return f"chunk {c}: {f} {a} against {b}"
    return None


def main_sharded(graph0, sources, stream, prob_run: dict, *, device, num_updates: int, chunk: int) -> dict:
    """Cell patents-uniform-fused-prob-shard4: ``main_fused`` prob's graph,
    sources, stream and policy on a 4-shard mesh emulated on the one card
    (``make_data_mesh(4, emulate=True)``).  Every chunk's ``MaintainStats``,
    the final answers and the Bloom bits must equal the unsharded run's bit
    for bit (and the answers SCRATCH's, as ``run_stream`` checks); K2
    launches once a shard an iteration.  Its updates/s and chunk latencies
    are the cost of emulation — four shards' work and the collectives on
    one card — not a speed of sharding."""
    import torch

    from repro_torch.core import engine as E
    from repro_torch.kernels import bloom as K3
    from repro_torch.kernels import diff_lookup as K4
    from repro_torch.kernels import ell_spmv as K1
    from repro_torch.kernels import fused_sweep as K2
    from repro_torch.launch.mesh import make_data_mesh

    mesh = make_data_mesh(MAIN_SHARDS, device=device, emulate=True)
    index_cls, built = E.ShardIndex, []

    def timed_index(*args, **kw):  # the engine's ShardIndex builds, timed
        t0 = time.perf_counter()
        index = index_cls(*args, **kw)
        built.append(time.perf_counter() - t0)
        return index

    E.ShardIndex = timed_index
    try:
        out, eng = run_stream(
            copy_graph(graph0), sources, stream, device=device, backend="fused", drop=prob_run["policy"],
            num_updates=num_updates, chunk=chunk, counters=(K1, K2, K3, K4), mesh=mesh,
            profile_path=OUT_DIR / "chip_smoke_sharded_prob_chunk_trace.json",
        )
    finally:
        E.ShardIndex = index_cls
    chunk_stats = out.pop("chunk_stats")
    part = first_stats_difference(chunk_stats, prob_run["chunk_stats"])
    if part is not None:
        raise AssertionError(f"main_sharded: MaintainStats part from main_fused prob's at {part}")
    if not np.array_equal(eng.answers(), prob_run["answers"]):
        raise AssertionError("main_sharded: answers differ from main_fused prob's")
    bits = [st.drop.flt.bits for st in eng.states]
    if not all(torch.equal(b.cpu(), prob_run["bits"]) for b in {id(b): b for b in bits}.values()):
        raise AssertionError("main_sharded: Bloom bits differ from main_fused prob's")
    iters_run = out["init_sweep_iters"] + sum(out["sweep_iters_per_chunk"])
    if out["launches"]["fused_sweep"] != MAIN_SHARDS * iters_run:
        raise AssertionError(f"main_sharded: {out['launches']['fused_sweep']} fused_sweep launches for "
                             f"{iters_run} sweep iterations on {MAIN_SHARDS} shards")
    per_device = out["nbytes_per_device_per_chunk"]
    final = eng.nbytes_per_device()
    if sum(final) != eng.nbytes() or len(final) != MAIN_SHARDS:
        raise AssertionError(f"main_sharded: per-shard bytes {final} do not sum to {eng.nbytes()}")
    out.update(
        shards=MAIN_SHARDS, emulated=True, equals_main_fused_prob=True,
        shard_index_build_s=built, shard_capacity=eng._shard_index.shard_capacity,
        nbytes_per_device_final=final,
        shard_share_of_bytes=[[b / max(sum(row), 1) for b in row] for row in per_device],
        note="updates/s and chunk latency are the cost of emulating 4 shards on one card",
    )
    del eng
    torch.cuda.empty_cache()
    return out


def parity_sharded(device, num_vertices: int = 1 << 16) -> dict:
    """The vertex-sharded sweep at V = 2**16 on 2 and 4 shards emulated on
    the card, against the unsharded engine on the card: {coo, ell, fused}
    x JOD {none, det, prob}, and VDC on coo and fused, through a batched
    stream.  After every chunk every ``MaintainStats`` field equals (VDC:
    all but ``jwritten``, the J writes counted against rows a reinserted
    edge inherits from its cell, which the shard layout's free lists pick
    apart from the graph's), and at the end the answers, the global D
    store, the Det rows, the Bloom bits and the selection rows; the
    per-shard bytes sum to ``nbytes()``.  Then one PageRank case at rtol
    1e-6, and a stream that overflows the fullest shard's cells (the layout
    regrows, VDC's J rows follow their edges) and the ELL width."""
    import torch

    from repro_torch.core import queries as tq
    from repro_torch.core.graph import DynamicGraph, ShardIndex
    from repro_torch.kernels import bloom as K3
    from repro_torch.kernels import diff_lookup as K4
    from repro_torch.kernels import ell_spmv as K1
    from repro_torch.kernels import fused_sweep as K2
    from repro_torch.launch.mesh import make_data_mesh

    for K in (K1, K2, K3, K4):
        K.reset_launches()
    rng = np.random.default_rng(SEED + 7)
    num_edges = round(num_vertices * PATENTS_E / PATENTS_V)
    initial, stream = split_and_stream(uniform_edges(num_vertices, num_edges, rng), PARITY_UPDATES, 0.2, rng)
    sources = pick_sources(DynamicGraph(num_vertices, initial), 8, rng)
    meshes = {n: make_data_mesh(n, device=device, emulate=True) for n in (2, 4)}

    def build(n, graph, query="sssp", **kw):
        mesh = meshes.get(n)
        dev = None if mesh is not None else device
        if query == "pagerank":
            return tq.pagerank(graph, iters=10, batch_capacity=32, mesh=mesh, device=dev, **kw)
        return tq.sssp(graph, sources, max_iters=48, batch_capacity=32, mesh=mesh, device=dev, **kw)

    def leaves(eng, mode):
        got = (vdc_leaves if mode == "vdc" else state_leaves)(eng.state)
        return {k: x for k, x in got.items() if not k.startswith("jstore/")}

    def check(engines, log, what, mode, chunk=32):
        for lo in range(0, len(log), chunk):
            stats = {n: e.apply_updates_batched(log[lo : lo + chunk]) for n, e in engines.items()}
            for n in (2, 4):
                for f in stats[1]._fields:
                    if f == "jwritten" and mode == "vdc":
                        continue
                    if not np.array_equal(getattr(stats[n], f), getattr(stats[1], f)):
                        raise AssertionError(f"{what} at {n} shards: MaintainStats.{f} differs")
        want = leaves(engines[1], mode)
        for n in (2, 4):
            same_leaves(leaves(engines[n], mode), want, f"{what} at {n} shards")
            if not np.array_equal(engines[n].answers(), engines[1].answers()):
                raise AssertionError(f"{what} at {n} shards: answers differ")
            per = engines[n].nbytes_per_device()
            if len(per) != n or sum(per) != engines[n].nbytes():
                raise AssertionError(f"{what} at {n} shards: per-shard bytes {per} != {engines[n].nbytes()}")
            if mode == "jod" and engines[n].nbytes() != engines[1].nbytes():
                raise AssertionError(f"{what} at {n} shards: accounted bytes differ")

    cells = {}
    matrix = [(b, "jod", d) for b in ("coo", "ell", "fused") for d in ("none", "det", "prob")]
    matrix += [("coo", "vdc", "none"), ("fused", "vdc", "none")]
    for backend, mode, dmode in matrix:
        engines = {n: build(n, DynamicGraph(num_vertices, initial), backend=backend, mode=mode,
                            drop=drop_policy(dmode, 1 << 20)) for n in (1, 2, 4)}
        what = f"{backend}/{mode}/{dmode}"
        check(engines, stream, what, mode)
        cells[what] = {"equal": True, "nbytes": engines[1].nbytes(),
                       "nbytes_per_device": {n: engines[n].nbytes_per_device() for n in (2, 4)}}
        del engines

    pr = {n: build(n, DynamicGraph(num_vertices, initial), query="pagerank", backend="fused") for n in (1, 2, 4)}
    for lo in range(0, len(stream), 32):
        for e in pr.values():
            e.apply_updates_batched(stream[lo : lo + 32])
    pr_err = 0.0
    for n in (2, 4):
        a, b = pr[n].answers(), pr[1].answers()
        if not np.allclose(a, b, rtol=1e-6, atol=0.0):
            raise AssertionError(f"pagerank at {n} shards: answers differ beyond rtol 1e-6")
        pr_err = max(pr_err, float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))))
    cells["pagerank/fused"] = {"rtol_1e-6": True, "max_rel_err": pr_err}
    del pr

    # overflow: the graph's capacity tight, the hub into the fullest shard
    # of 4 with more edges than its spare cells and than the ELL width
    cap = len(initial) + 1024
    tight = DynamicGraph(num_vertices, initial, capacity=cap)
    index = ShardIndex(tight.snapshot(), 4)
    fullest = int(np.argmax(index.fill))
    spare = index.shard_capacity - int(index.fill[fullest])
    hub = fullest * (num_vertices // 4) + 1
    srcs = [u for u in rng.permutation(num_vertices).tolist() if u != hub][: spare + 40]
    hub_log = [(u, hub, 0, 1.0, +1) for u in srcs] + list(stream[:64])
    grow = {}
    for backend, mode, dmode in (("fused", "jod", "det"), ("ell", "jod", "none"), ("coo", "vdc", "none")):
        engines = {n: build(n, DynamicGraph(num_vertices, initial, capacity=cap), backend=backend, mode=mode,
                            drop=drop_policy(dmode, 1 << 20)) for n in (1, 2, 4)}
        before = {n: (engines[n]._shard_index.shard_capacity, engines[n]._ell_width) for n in (2, 4)}
        what = f"overflow {backend}/{mode}/{dmode}"
        check(engines, hub_log, what, mode)
        after = {n: (engines[n]._shard_index.shard_capacity, engines[n]._ell_width) for n in (2, 4)}
        if after[4][0] <= before[4][0] or (backend != "coo" and after[4][1] <= before[4][1]):
            raise AssertionError(f"{what}: no regrow ({before[4]} -> {after[4]})")
        grow[what] = {"shard_capacity": [before[4][0], after[4][0]], "ell_width": [before[4][1], after[4][1]],
                      "equal": True}
        del engines
    torch.cuda.synchronize()
    return {"num_vertices": num_vertices, "num_edges_initial": int(initial.shape[0]), "shards": [2, 4],
            "cells": cells, "overflow": grow, "hub_inserts": len(srcs),
            "launches": {K.__name__.rsplit(".", 1)[-1]: K.LAUNCHES for K in (K1, K2, K3, K4)}}


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
            del st  # else the next run starts with this J store on the card
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


class PeakTimer:
    """Wraps a function of the session path (``engine.shed_slot``, the
    governor's reclamation primitive; ``DiffIFE._grow_queries``, the pool's
    regrow) to time each call with a device sync on both sides and read the
    card's peak memory during it; it calls the function unchanged.  ``peak``
    keeps the run's peak across the resets this needs."""

    def __init__(self, fn):
        import torch

        self.fn, self.calls, self.peak = fn, [], torch.cuda.max_memory_allocated()

    def __call__(self, *args):
        import torch

        torch.cuda.synchronize()
        self.peak = max(self.peak, torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = self.fn(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        self.peak = max(self.peak, peak)
        self.calls.append({"ms": ms, "max_memory_allocated": peak, "memory_at_start": base,
                           "memory_above_start": peak - base,
                           "memory_after": torch.cuda.memory_allocated()})
        return out


def main_session(graph0, stream, sources, none_run: dict, det_run: dict, *, device,
                 chunk: int) -> dict:
    """The session layer at full size: ``CQPSession(engine="dense",
    backend="fused", batch_capacity=32, budget_bytes=B)`` on the main
    path's graph and stream, ``drop=None`` (the governor provisions Det-Drop
    at p = 0).  ``B`` is 60% of the ungoverned ``main_fused`` none run's
    peak accounted bytes in this run.  Registers 4 SSSP sources in one
    batch (one sweep), streams 128 updates, registers the other 4 (the pool
    grows from 4 to 8 slots), streams 128 more, deregisters 2, then runs one
    more chunk under the profiler.  Launch counts are zeroed before the
    session is built and read after the deregistrations; K2 must launch
    once per sweep iteration.  Every live query must equal SCRATCH, the 4
    late ones a ``DiffIFE`` run that had them from the start, and each
    deregistration must free the ``slot_nbytes`` read before it."""
    import torch

    from repro_torch.core import engine as E
    from repro_torch.core import plan as qplan
    from repro_torch.core import queries as tq
    from repro_torch.core.scratch import scratch_like
    from repro_torch.core.session import CQPSession
    from repro_torch.kernels import bloom as K3
    from repro_torch.kernels import diff_lookup as K4
    from repro_torch.kernels import ell_spmv as K1
    from repro_torch.kernels import fused_sweep as K2

    counters = (K1, K2, K3, K4)
    budget = int(0.6 * none_run["peak_nbytes"])
    first, late = sources[:4], sources[4:]
    graph = copy_graph(graph0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    shed = PeakTimer(E.shed_slot)
    grow = PeakTimer(E.DiffIFE._grow_queries)
    E.shed_slot = shed
    E.DiffIFE._grow_queries = lambda self: grow(self)
    lat, chunk_nbytes, chunk_actions, iters = [], [], [], []
    try:
        for K in counters:
            K.reset_launches()  # ---- the main path starts here
        at_start = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        sess = CQPSession(graph, engine="dense", backend="fused", batch_capacity=chunk,
                          budget_bytes=budget, device=device)
        handles = sess.register_many([qplan.sssp(s, max_iters=48) for s in first])
        torch.cuda.synchronize()
        register_first_s = time.perf_counter() - t0
        eng = sess._impl.impl
        iters.append(int(eng.last_stats.iters_run))
        peak_nbytes = sess.nbytes()
        after_register = {"nbytes": peak_nbytes, "slot_capacity": eng.slot_capacity,
                          "actions": len(sess.governor.actions)}

        def run_chunks(lo: int, hi: int) -> int:
            peak = 0
            for c in range(lo, hi, chunk):
                t1 = time.perf_counter()
                st = sess.apply_updates_batched(stream[c : c + chunk])
                lat.append(time.perf_counter() - t1)  # the governor's pass included
                iters.append(int(st.iters_run))
                chunk_nbytes.append(sess.nbytes())
                chunk_actions.append(len(sess.governor.actions))
                peak = max(peak, chunk_nbytes[-1])
            return peak

        peak_nbytes = max(peak_nbytes, run_chunks(0, 128))
        t0 = time.perf_counter()
        handles += sess.register_many([qplan.sssp(s, max_iters=48) for s in late])
        torch.cuda.synchronize()
        register_late_s = time.perf_counter() - t0
        eng = sess._impl.impl
        iters.append(int(eng.last_stats.iters_run))
        slot_capacity = eng.slot_capacity
        if slot_capacity != 8:
            raise AssertionError(f"the pool holds {slot_capacity} slots after 8 registrations")
        after_late = {"nbytes": sess.nbytes(), "actions": len(sess.governor.actions)}
        peak_nbytes = max(peak_nbytes, after_late["nbytes"], run_chunks(128, 256))
        freed = []
        for h in (handles[1], handles[5]):
            want = eng.slot_nbytes(sess._handles[h.qid])
            got = sess.deregister(h)
            if got != want:
                raise AssertionError(f"deregister freed {got} bytes, slot_nbytes read {want}")
            freed.append(got)
        launches = {K.__name__.rsplit(".", 1)[-1]: K.LAUNCHES for K in counters}  # ---- and ends here
    finally:
        E.shed_slot = shed.fn
        E.DiffIFE._grow_queries = grow.fn
    if launches["fused_sweep"] != sum(iters) or launches["ell_spmv"] != 0:
        raise AssertionError(f"launches {launches} for {sum(iters)} sweep iterations")
    del handles[5], handles[1]
    max_memory = max(shed.peak, grow.peak, torch.cuda.max_memory_allocated())

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = sess.apply_updates_batched(stream[256 : 256 + chunk])
        wall = time.perf_counter() - t0
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    traced = device_busy(prof, OUT_DIR / "chip_smoke_session_chunk_trace.json")
    traced.update(chunk_wall_ms=wall * 1e3, sweep_iters=int(st.iters_run))
    traced["device_idle_share"] = 1.0 - traced["device_busy_ms"] / traced["chunk_wall_ms"]
    peak_nbytes = max(peak_nbytes, sess.nbytes())

    # exactness: every live query against SCRATCH on the final graph
    slots = [sess._handles[h.qid] for h in handles]
    got = np.stack([sess.answers(h) for h in handles])
    if got.shape != (6, graph.num_vertices) or np.isnan(got).any():
        raise AssertionError(f"bad answers: shape {got.shape}")
    want = scratch_like(eng.cfg, eng.graph, eng.state.init[slots], device=device).answers()
    np.testing.assert_array_equal(got, want)
    gov = sess.stats()["governor"]
    late_got = got[3:]  # the late sources 0, 2, 3 (1 was deregistered)
    del want, sess, eng
    torch.cuda.empty_cache()

    # the late queries against a DiffIFE run that had them from the start
    ref_eng = tq.sssp(copy_graph(graph0), late, backend="fused", max_iters=48, batch_capacity=chunk,
                      store_capacity=16, device=device)
    ref_eng.apply_updates_batched(stream[: 256 + chunk])
    np.testing.assert_array_equal(late_got, ref_eng.answers()[[0, 2, 3]])
    del ref_eng, got, late_got
    torch.cuda.empty_cache()

    timed = lat[1:]  # the first chunk after the registration sweep is warm-up
    escalations = [a for a in gov["actions"] if a["kind"] == "escalate"]
    return {
        "num_vertices": graph0.num_vertices,
        "queries_registered": len(sources),
        "queries_live": len(slots),
        "chunk": chunk,
        "budget_bytes": budget,
        "budget_rule": "0.6 x main_fused none's peak_nbytes in this run",
        "ungoverned_peak_nbytes": none_run["peak_nbytes"],
        "det_p06_peak_nbytes": det_run["peak_nbytes"],
        "peak_nbytes": peak_nbytes,
        "peak_nbytes_vs_budget": peak_nbytes / budget,
        "peak_nbytes_vs_ungoverned": peak_nbytes / none_run["peak_nbytes"],
        "final_nbytes": chunk_nbytes[-1],
        "nbytes_per_chunk": chunk_nbytes,
        "actions_per_chunk": chunk_actions,
        "after_first_register": after_register,
        "after_late_register": after_late,
        "updates_per_s": chunk * len(timed) / sum(timed),
        "chunk_latency_ms": [x * 1e3 for x in lat],
        "p50_chunk_ms": float(np.percentile(timed, 50)) * 1e3,
        "p99_chunk_ms": float(np.percentile(timed, 99)) * 1e3,
        "fused_det_updates_per_s": det_run["updates_per_s"],
        "fused_det_p50_p99_ms": [det_run["p50_chunk_ms"], det_run["p99_chunk_ms"]],
        "register_first_4_s": register_first_s,  # the engine's build included
        "fused_none_engine_init_s": none_run["engine_init_s"],  # build + initial sweep, 8 queries
        "register_late_4_s": register_late_s,  # the 4 → 8 regrow included
        "regrow": grow.calls,
        "slot_capacity": slot_capacity,
        "sweep_iters": iters,
        "freed_by_deregister": freed,
        "governor": {k: gov[k] for k in ("passes", "escalations", "deescalations", "levels",
                                         "overflow_blocked", "det_overflow_shed", "headroom_bytes")},
        "actions": gov["actions"],
        "escalation_bytes_freed": sum(a["bytes_freed"] for a in escalations),
        "top_rung_reached": sorted(int(q) for q, lvl in gov["levels"].items() if lvl >= 4),
        "sheds": len(shed.calls),
        "shed_ms": [c["ms"] for c in shed.calls],
        "shed_ms_max": max((c["ms"] for c in shed.calls), default=None),
        "shed_max_memory_allocated": max((c["max_memory_allocated"] for c in shed.calls), default=None),
        "shed_memory_above_start_max": max((c["memory_above_start"] for c in shed.calls), default=None),
        "memory_allocated_at_start": at_start,
        "max_memory_allocated": max_memory,
        "launches": launches,
        "traced_chunk": traced,
        "equals_scratch": True,
        "late_equal_from_start": True,
    }


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a tree of named tuples (an engine state)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, tuple):
        return sum(tensor_bytes(x) for x in tree)
    return 0


SERVE_FAULT_AT = 5  # the injected fault fires before chunk 5 (ckpt@4 restores, chunk 4 replays)
SERVE_DEREGISTER_AFTER = 4  # after round 4: past ckpt@4, so the control-log replay carries it


def serve_run(graph0, stream, sources, *, device, chunk: int, num_updates: int, ckpt_dir: Path | None,
              keep: int = 2) -> dict:
    """One ``CQPServer`` run of the ``main_serve`` traffic; with ``ckpt_dir``
    it checkpoints every 2 chunks and takes one ``InjectedFault`` before
    chunk ``SERVE_FAULT_AT``.  Launch counts are zeroed just before the
    serving session is built and read after the server stops; every sweep's
    iterations are summed (``engine._sweep``, the loop every sweep runs,
    wrapped), registrations and replays included.  Returns the measurements, the last reads and the
    final session."""
    import asyncio
    import shutil

    import torch

    from repro_torch.core import engine as E
    from repro_torch.core import plan as qplan
    from repro_torch.core.governor import GovernorConfig
    from repro_torch.kernels import bloom as K3
    from repro_torch.kernels import diff_lookup as K4
    from repro_torch.kernels import ell_spmv as K1
    from repro_torch.kernels import fused_sweep as K2
    from repro_torch.runtime.fault import InjectedFault
    from repro_torch.serving.admission import SLOConfig
    from repro_torch.serving.metrics import summarize_latency_s
    from repro_torch.serving.server import CQPServer, ServerConfig, build_serving_session
    from repro_torch.serving.tenants import TenantSpec

    counters = (K1, K2, K3, K4)
    # main_fused prob's filter width: the scenario's default 2**10 bits a
    # query saturates at 3.77 M vertices
    ladder = GovernorConfig(representation="prob", bloom_bits=1 << 26)

    def factory():
        return build_serving_session(copy_graph(graph0), ladder=ladder, engine="dense", backend="fused",
                                     batch_capacity=chunk, store_capacity=16, min_slots=len(sources),
                                     device=device)

    # the reference scenario's ServerConfig (server.py:889-897), keep 2 not 3
    cfg = ServerConfig(chunk_updates=chunk, admission=True,
                       slo=SLOConfig(backlog_high_updates=max(8 * chunk, 256)), drop_ladder=ladder,
                       checkpoint_every=2, checkpoint_keep=keep, max_restarts=3)
    fired = []

    def injector(k: int) -> None:
        if ckpt_dir is not None and k == SERVE_FAULT_AT and not fired:
            fired.append(k)
            raise InjectedFault(f"main_serve drill before chunk {k}")

    iters: list[int] = []
    real_sweep = E._sweep

    def counted_sweep(*args):
        states, stats = real_sweep(*args)
        iters.append(int(stats.iters_run))
        return states, stats

    tenants = {"tenant0": sources[0:3], "tenant1": sources[3:6], "tenant2": sources[6:8]}
    rounds = num_updates // chunk
    out: dict = {"rounds": rounds, "chunk": chunk, "queries": len(sources),
                 "tenants": {t: len(s) for t, s in tenants.items()}}
    mem: dict = {}
    inner_s: list[float] = []
    refresh_s: list[float] = []

    async def traffic():
        server = CQPServer(factory(), config=cfg, session_factory=factory,
                           checkpoint_dir=None if ckpt_dir is None else str(ckpt_dir),
                           fault_injector=injector)
        apply_sync, refresh, recover, adopt = (server._apply_sync, server._refresh_view,
                                               server._recover, server._adopt_session)

        def timed_apply(chunk_upd, k):
            t0 = time.perf_counter()
            apply_sync(chunk_upd, k)
            inner_s.append(time.perf_counter() - t0)

        def timed_refresh():
            t0 = time.perf_counter()
            refresh()
            refresh_s.append(time.perf_counter() - t0)

        async def timed_recover(exc, k):
            torch.cuda.synchronize()
            mem["peak_before_fault"] = torch.cuda.max_memory_allocated()
            mem["allocated_at_fault"] = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            await recover(exc, k)
            torch.cuda.synchronize()
            mem["recover_wall_s"] = time.perf_counter() - t0
            mem["peak_across_restore"] = torch.cuda.max_memory_allocated()

        def timed_adopt(session, cursor):
            t0 = time.perf_counter()
            adopt(session, cursor)
            torch.cuda.synchronize()
            mem["adopt_replay_s"] = time.perf_counter() - t0
            mem["restore_timings"] = session.restore_info["timings"] if session.restore_info else None

        server._apply_sync, server._refresh_view = timed_apply, timed_refresh
        server._recover, server._adopt_session = timed_recover, timed_adopt
        async with server:
            t0 = time.perf_counter()
            tickets = []
            for i, (tid, srcs) in enumerate(tenants.items()):
                server.add_tenant(TenantSpec(tenant_id=tid, priority=i + 1))
                for s in srcs:
                    tickets.append((tid, await server.register_query(tid, qplan.sssp(s, max_iters=48))))
            torch.cuda.synchronize()
            out["register_8_s"] = time.perf_counter() - t0  # the engine's build included
            out["register_ms"] = [x * 1e3 for x in server.metrics.samples("register")]
            if ckpt_dir is not None:
                eng = server.session._impl.impl
                est = tensor_bytes(eng.state) + sum(a.nbytes for a in server.session.graph.state_dict()[0].values())
                free = shutil.disk_usage(ckpt_dir).free
                out["snapshot_bytes_estimate"], out["disk_free_bytes"] = est, free
                if free < (keep + 1) * est:
                    raise AssertionError(
                        f"main_serve needs room for {keep + 1} snapshots of ~{est / 1e9:.2f} GB under "
                        f"{ckpt_dir}; the disk has {free / 1e9:.2f} GB free"
                    )
            round_s = []
            for r in range(rounds):
                if r == SERVE_DEREGISTER_AFTER + 1:
                    tid, ticket = tickets.pop(5)  # tenant1's last query
                    out["deregistered"] = {"tenant": tid, "ticket": ticket.ticket_id,
                                           "freed": await server.deregister_query(ticket)}
                t0 = time.perf_counter()
                tid = list(tenants)[r % len(tenants)]
                if not server.submit(tid, stream[r * chunk : (r + 1) * chunk]).admitted:
                    raise AssertionError(f"round {r}: the submission was not admitted")
                for tid, ticket in tickets:
                    await server.read(ticket, timeout_s=1800.0)
                round_s.append(time.perf_counter() - t0)
            await server.drain()
            # the last reads cover the whole stream (each tenant's own reads
            # wait only for its own writes)
            reads = {t.ticket_id: await server.read(t, timeout_s=1800.0, require=rounds * chunk)
                     for _, t in tickets}
            stats = server.stats()
        out["round_s"] = round_s
        return server, stats, tickets, reads

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    if ckpt_dir is not None:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        ckpt_dir.mkdir(parents=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["memory_allocated_at_start"] = torch.cuda.memory_allocated()
    E._sweep = counted_sweep
    try:
        for K in counters:
            K.reset_launches()  # ---- the main path starts here
        t0 = time.perf_counter()
        server, stats, tickets, reads = asyncio.run(traffic())
        out["wall_s"] = time.perf_counter() - t0
        launches = {K.__name__.rsplit(".", 1)[-1]: K.LAUNCHES for K in counters}  # ---- and ends here
    finally:
        E._sweep = real_sweep
        if ckpt_dir is not None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.synchronize()
    peak_after = torch.cuda.max_memory_allocated()
    out["max_memory_allocated"] = max(mem.get("peak_before_fault", 0), peak_after)
    if launches["fused_sweep"] != sum(iters) or launches["ell_spmv"] != 0:
        raise AssertionError(f"launches {launches} for {sum(iters)} sweep iterations")
    fresh = [r.fresh for r in reads.values()]
    if not all(fresh):
        raise AssertionError(f"stale final reads: {fresh}")
    timed = [s for r, s in enumerate(out["round_s"]) if r >= 1 and (ckpt_dir is None or r != SERVE_FAULT_AT)]
    maintain = server.metrics.samples("maintain")
    hop = [m - i for m, i in zip(maintain, inner_s[-len(maintain):])]
    out.update(
        launches=launches,
        sweep_iters=iters,
        faults=stats["faults"],
        updates_per_s=chunk * len(timed) / sum(timed),
        timed_rounds=[r for r in range(rounds) if r >= 1 and (ckpt_dir is None or r != SERVE_FAULT_AT)],
        maintain=summarize_latency_s(maintain),
        read_latency={t: v["read_latency"] for t, v in stats["tenants"].items()},
        stale_reads=sum(v["stale_reads"] for v in stats["tenants"].values()),
        epoch_view_refresh=summarize_latency_s(refresh_s),
        executor_hop=summarize_latency_s(hop),
        actions=stats["actions"],
        admission={k: stats["admission"][k] for k in ("epochs", "shedding", "rejected_updates",
                                                      "rejected_registers", "straggler_sheds")},
        straggler_events=stats["straggler_events"],
        phases={k: {"count": v["count"], "p50_ms": v["p50_ms"], "p99_ms": v["p99_ms"], "total_s": v["total_s"]}
                for k, v in stats["phases"].items()},
        nbytes_per_query=stats["session"]["nbytes_per_query"],
        query_qids=stats["session"]["query_qids"],
    )
    if ckpt_dir is not None:
        rec = stats["recovery"]
        out["recovery"] = {
            "history": rec["history"],
            "checkpoints": rec["checkpoints"],
            "checkpoint_host_bytes": rec["checkpoint_bytes"],
            "checkpoint_s": rec["checkpoint_s"],
            "checkpoint_state_dict_s": rec["checkpoint_state_s"],
            "checkpoint_wait_on_previous_write_s": rec["checkpoint_wait_s"],
            "checkpoint_write_s": rec["checkpoint_write_s"],
            "restores": rec["restores"],
            "replayed_chunks": rec["replayed_chunks"],
        }
        out["restore"] = {k: mem.get(k) for k in ("restore_timings", "adopt_replay_s", "recover_wall_s")}
        out["memory_across_restore"] = {k: mem.get(k) for k in ("allocated_at_fault", "peak_across_restore")}
    return {"out": out, "server": server, "tickets": tickets, "reads": reads}


def main_serve(graph0, stream, sources, *, device, chunk: int, num_updates: int = 256) -> dict:
    """The serving tier at full size (see the module docstring): the fault
    run, its last reads against SCRATCH on the final graph, then the same
    traffic with no fault and no checkpoint directory.  A server and its
    session hold each other (the straggler policy, the supervisor's
    restore hook), so each run's device memory is freed by ``gc.collect``,
    not by ``del`` alone."""
    import gc

    import torch

    from repro_torch.core.scratch import scratch_like
    from repro_torch.kernels import ell_spmv as K1

    fault = serve_run(graph0, stream, sources, device=device, chunk=chunk, num_updates=num_updates,
                      ckpt_dir=OUT_DIR / "serve_ckpt")
    out = fault["out"]
    rec = out["recovery"]
    faults = [h for h in rec["history"] if h.startswith("fault@")]
    if out["faults"] != 1 or faults != [f"fault@{SERVE_FAULT_AT}:InjectedFault"]:
        raise AssertionError(f"faults {out['faults']}, history {rec['history']}: only the injected one may fire")
    server = fault["server"]
    sess = server.session
    eng = sess._impl.impl
    tickets = fault["tickets"]
    qids = [server.registry.qid_of(t) for _, t in tickets]
    slots = [sess._handles[q] for q in qids]
    got = np.stack([fault["reads"][t.ticket_id].values for _, t in tickets])
    if got.shape != (len(tickets), graph0.num_vertices) or np.isnan(got).any():
        raise AssertionError(f"bad answers: shape {got.shape}")
    K1.reset_launches()
    t0 = time.perf_counter()
    want = scratch_like(eng.cfg, eng.graph, eng.state.init[slots], device=device).answers()
    scratch_s = time.perf_counter() - t0
    np.testing.assert_array_equal(got, want)
    out["scratch_check"] = {"equal": True, "seconds": scratch_s, "ell_spmv_launches": K1.LAUNCHES}
    del want, sess, eng, server, fault
    gc.collect()
    torch.cuda.empty_cache()

    clean = serve_run(graph0, stream, sources, device=device, chunk=chunk, num_updates=num_updates, ckpt_dir=None)
    c_out = clean["out"]
    c_got = np.stack([clean["reads"][t.ticket_id].values for _, t in clean["tickets"]])
    np.testing.assert_array_equal(got, c_got)
    if (c_out["nbytes_per_query"], c_out["query_qids"]) != (out["nbytes_per_query"], out["query_qids"]):
        raise AssertionError(f"per-query bytes {out['nbytes_per_query']} against the fault-free run's "
                             f"{c_out['nbytes_per_query']} (actions {out['actions']} / {c_out['actions']})")
    del clean
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "num_vertices": graph0.num_vertices,
        "bloom_bits_per_query": 1 << 26,
        "note": ("GovernorConfig(representation='prob', bloom_bits=2**26), main_fused prob's width (the "
                 "scenario's 2**10 a query saturates at 3.77 M vertices); checkpoint_keep=2 in place of 3"),
        "fault_run": out,
        "clean_run": c_out,
        "equal_to_scratch": True,
        "equal_to_fault_free_run": True,
        "updates_per_s_with_checkpointing": out["updates_per_s"],
        "updates_per_s_without_checkpointing": c_out["updates_per_s"],
    }


class Clock:
    """Wall seconds of the wrapped callables, a device sync on both sides
    (the work they queue is inside their time), summed per name."""

    def __init__(self):
        self.s: dict[str, float] = {}
        self.wrapped: list[tuple] = []

    def wrap(self, obj, attr: str, name: str) -> None:
        import torch

        fn = getattr(obj, attr)
        self.wrapped.append((obj, attr, obj.__dict__.get(attr)))

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t0

        setattr(obj, attr, timed)

    def take(self) -> dict:
        out, self.s = self.s, {}
        return out

    def unwrap(self) -> None:
        for obj, attr, fn in reversed(self.wrapped):
            if fn is None:
                delattr(obj, attr)  # an instance's wrapper over its class's method
            else:
                setattr(obj, attr, fn)
        self.wrapped = []


def landmark_targets(sess, handles) -> list[float]:
    """Every SPSP target through ``CQPSession.aggregate`` (the first read
    after a chunk runs the lazy refresh)."""
    return [sess.aggregate(h)["value"] for h in handles]


def main_landmark(graph0, stream, sources, *, device, chunk: int, num_updates: int = 128) -> dict:
    """The plan optimizer at full size: 8 SPSP plans through
    ``CQPSession(engine="dense", backend="fused", optimize="always")`` on a
    copy of the main graph, ``num_updates`` of the main stream in chunks of
    ``chunk``, every target read after every chunk; the targets at the end
    must equal SCRATCH bit for bit and K2 must launch (the forward index
    rows).  The launch counts are zeroed just before the registration and
    read just after the last read."""
    import torch

    from repro_torch.core import landmark as lm
    from repro_torch.core import plan as tplan
    from repro_torch.core import semiring as tsr
    from repro_torch.core.scratch import scratch_like
    from repro_torch.core.session import CQPSession
    from repro_torch.kernels import bloom as K3
    from repro_torch.kernels import diff_lookup as K4
    from repro_torch.kernels import ell_spmv as K1
    from repro_torch.kernels import fused_sweep as K2

    v = graph0.num_vertices
    pairs = [(s, (s + v // 2) % v) for s in sources]
    graph = copy_graph(graph0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    clock = Clock()
    clock.wrap(lm, "transpose_graph", "transpose_graph_s")
    try:
        for K in (K1, K2, K3, K4):
            K.reset_launches()  # ---- the main path starts here
        sess = CQPSession(graph, engine="dense", backend="fused", batch_capacity=chunk, device=device,
                          optimize="always")
        rule = sess._planner.rules[0]
        clock.wrap(sess, "_register_internal", "host_register_s")
        clock.wrap(rule, "_twin_session", "twin_session_s")
        t0 = time.perf_counter()
        handles = sess.register_many([tplan.spsp(s, t, max_iters=48) for s, t in pairs])
        torch.cuda.synchronize()
        build = {"register_many_s": time.perf_counter() - t0, **clock.take()}
        # the twin's registration: what _build_index spends beyond the
        # host rows and the twin's construction (landmark selection included)
        build["twin_register_s"] = build["register_many_s"] - build["host_register_s"] - build["twin_session_s"]
        t0 = time.perf_counter()
        landmark_targets(sess, handles)
        build["first_refresh_s"] = time.perf_counter() - t0
        clock.wrap(sess._impl, "apply_updates_batched", "host_maintain_s")
        clock.wrap(rule.rev_session, "apply_updates", "twin_maintain_s")
        chunks, reads = [], []
        for lo in range(0, num_updates, chunk):
            work0, sec0 = rule.pruned_work_total, rule.scratch_seconds
            t0 = time.perf_counter()
            sess.apply_updates_batched(stream[lo:lo + chunk])
            reads = landmark_targets(sess, handles)
            wall = time.perf_counter() - t0
            iters, work = rule.pruned_iters_last, rule.pruned_work_total - work0
            internal = sess._nbytes_per_query_map()
            chunks.append({
                "wall_s": wall, **clock.take(), "refresh_s": rule.scratch_seconds - sec0,
                "pruned_iters": iters, "pruned_work": work,
                "work_cut": 1.0 - work / max(iters * len(pairs) * v, 1),
                "index_rows_nbytes": sum(internal[q] for q in sess._internal),
                "twin_nbytes": sess._planner.extra_nbytes(),
            })
        launches = {K.__name__.rsplit(".", 1)[-1]: K.LAUNCHES for K in (K1, K2, K3, K4)}  # ---- and ends here
    finally:
        clock.unwrap()
    peak = torch.cuda.max_memory_allocated()
    if launches["fused_sweep"] == 0:
        raise AssertionError("main_landmark: the forward index rows launched no fused_sweep")
    cfg = lm.engine_cfg(len(pairs), v, tsr.min_plus(), max_iters=48)
    want = scratch_like(cfg, sess.graph, lm.source_init([s for s, _ in pairs], v), device=device).answers()
    want = [float(want[q, t]) for q, (_, t) in enumerate(pairs)]
    if reads != want:
        raise AssertionError(f"main_landmark: targets {reads} differ from SCRATCH {want}")
    stats = sess.stats()["planner"]
    timed = chunks[1:]  # chunk 0 is warm-up
    out = {"num_vertices": v, "queries": len(pairs), "num_landmarks": rule.num_landmarks,
           "landmarks": stats["landmark"]["landmarks"], "chunk": chunk, "updates": num_updates,
           "build": build, "chunks": chunks,
           "updates_per_s": chunk * len(timed) / sum(c["wall_s"] for c in timed),
           "work_cut_mean": statistics.fmean(c["work_cut"] for c in chunks),
           "index_nbytes_peak": max(c["index_rows_nbytes"] + c["twin_nbytes"] for c in chunks),
           "launches": launches, "max_memory_allocated": peak, "memory_allocated_at_start": at_start,
           "planner": stats, "targets": reads, "equals_scratch": True}
    del sess, rule, handles
    torch.cuda.empty_cache()
    return out


def parity_planner(device, num_vertices: int = 1 << 16) -> dict:
    """``CQPSession(engine="dense", backend="fused", optimize="always")`` at
    V = 2**16, 8 SPSP plans, three chunks of 32: the card against the
    port's CPU run on the same inputs (every pruned field, ``iters``,
    ``work`` and the planner's snapshot after every chunk); the card run is
    checkpointed after the first chunk, restored on the card and replayed
    to the same fields.  Then a governed leg on the card at a starved
    budget: the index sheds, the targets stay equal to SCRATCH, the budget
    is raised and calm passes re-materialise it, still exact."""
    import shutil

    import torch

    from repro_torch.core import landmark as lm
    from repro_torch.core import plan as tplan
    from repro_torch.core import semiring as tsr
    from repro_torch.core.graph import DynamicGraph
    from repro_torch.core.scratch import scratch_like
    from repro_torch.core.session import CQPSession
    from repro_torch.kernels import fused_sweep as K2

    rng = np.random.default_rng(SEED + 7)
    num_edges = round(num_vertices * PATENTS_E / PATENTS_V)
    initial, stream = split_and_stream(uniform_edges(num_vertices, num_edges, rng), 96, 0.2, rng)
    sources = pick_sources(DynamicGraph(num_vertices, initial), 8, rng)
    pairs = [(s, (s + num_vertices // 2) % num_vertices) for s in sources]
    chunks = [stream[lo:lo + 32] for lo in range(0, 96, 32)]
    ckpt = OUT_DIR / "planner_ckpt"

    def session(dev, **kw):
        sess = CQPSession(DynamicGraph(num_vertices, initial), engine="dense", backend="fused",
                          batch_capacity=32, optimize="always", device=dev, **kw)
        return sess, sess.register_many([tplan.spsp(s, t, max_iters=48) for s, t in pairs])

    def snapshot(sess, handles) -> dict:
        lmk = dict(sess.stats()["planner"]["landmark"])
        del lmk["scratch_seconds"]
        return {"fields": np.stack([sess.answers(h) for h in handles]), "landmark": lmk}

    def scratch_targets(sess) -> list[float]:
        cfg = lm.engine_cfg(len(pairs), num_vertices, tsr.min_plus(), max_iters=48)
        want = scratch_like(cfg, sess.graph, lm.source_init(sources, num_vertices), device=device).answers()
        return [float(want[q, t]) for q, (_, t) in enumerate(pairs)]

    shutil.rmtree(ckpt, ignore_errors=True)
    runs = {}
    try:
        for dev in (device, "cpu"):
            K2.reset_launches()
            sess, handles = session(dev)
            steps = [snapshot(sess, handles)]
            for k, batch in enumerate(chunks):
                sess.apply_updates_batched(batch)
                steps.append(snapshot(sess, handles))
                if dev == device and k == 0:
                    sess.checkpoint(str(ckpt))
            runs[dev] = steps, K2.LAUNCHES, sess
        card, launches, sess = runs[device]
        cpu = runs["cpu"][0]
        for k, (a, b) in enumerate(zip(card, cpu)):
            np.testing.assert_array_equal(a["fields"], b["fields"], err_msg=f"pruned fields, step {k}")
            if a["landmark"] != b["landmark"]:
                raise AssertionError(f"planner snapshot, step {k}: {a['landmark']} vs {b['landmark']}")
        if launches == 0:
            raise AssertionError("parity_planner: no fused_sweep launch on the card")
        if [float(x) for x in card[-1]["fields"][np.arange(len(pairs)), [t for _, t in pairs]]] \
                != scratch_targets(sess):
            raise AssertionError("parity_planner: targets differ from SCRATCH")
        restored = CQPSession.restore(str(ckpt), device=device)
        for batch in chunks[1:]:
            restored.apply_updates_batched(batch)
        back = snapshot(restored, restored.handles())
        np.testing.assert_array_equal(back["fields"], card[-1]["fields"], err_msg="restore + replay")
        restore_info = {"step": restored.restore_info["step"], "timings": restored.restore_info["timings"],
                        "landmarks": back["landmark"]["landmarks"], "fields_equal": True}
        del restored, runs, sess
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()

    gov, handles = session(device, budget_bytes=1)
    gov.apply_updates_batched(chunks[0])
    shed = dict(gov.stats()["planner"]["landmark"])
    if not shed["shed"] or shed["sheds_total"] < 1:
        raise AssertionError(f"parity_planner: the starved index did not shed: {shed}")
    if landmark_targets(gov, handles) != scratch_targets(gov):
        raise AssertionError("parity_planner: shed targets differ from SCRATCH")
    gov.governor.budget_bytes = 1 << 40
    for batch in chunks[1:]:
        gov.apply_updates_batched(batch)
    calm = 0
    while not gov.stats()["planner"]["landmark"]["remats_total"] and calm < 8:
        gov.apply_updates_batched([])
        calm += 1
    remat = dict(gov.stats()["planner"]["landmark"])
    if not remat["live"] or remat["remats_total"] < 1:
        raise AssertionError(f"parity_planner: the index did not re-materialise: {remat}")
    if landmark_targets(gov, handles) != scratch_targets(gov):
        raise AssertionError("parity_planner: re-materialised targets differ from SCRATCH")
    del gov
    torch.cuda.empty_cache()
    return {"num_vertices": num_vertices, "num_edges_initial": int(initial.shape[0]), "queries": len(pairs),
            "chunks": len(chunks), "card_equals_cpu": True, "fused_sweep_launches": launches,
            "landmark": card[-1]["landmark"], "restore": restore_info,
            "governed": {"shed": shed, "calm_passes": calm, "rematerialised": remat, "exact": True}}


def cqp_serve_drill_start() -> dict:
    """``python -m repro_torch.launch.cqp_serve --json`` at its defaults on
    the card, per backend (``fused``, ``ell``): a plain run, a drill
    (checkpoint every 2 chunks, a fault before chunk 3) and a ``--restore``
    from the drill's directory; the three must end with equal per-query
    bytes and answer digests, and the kernel of the backend must launch.
    Then ``--query spsp --optimize always``, plain and drilled (equal
    digests; the landmark index live, the backend's kernel launched for its
    forward rows), and ``--query spsp --engine scratch``: the target answers
    of the three are equal.  On ``fused``, the vertex-sharded sweep: ``--mesh
    data --shards 4 --emulate-devices 4`` plain and drilled, then a
    ``--restore`` of its 4-shard checkpoint at ``--mesh none``: every digest
    equal to the unsharded plain run's.  Five chains run side by side on
    threads of their own, each process to its end, while the main process
    goes on (the parity phases); :func:`cqp_serve_drill_finish` collects and
    checks them."""
    import os
    import shutil

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **ONE_THREAD)
    base = [sys.executable, "-m", "repro_torch.launch.cqp_serve", "--json"]
    drill = ["--checkpoint-every", "2", "--inject-fault-at", "3"]
    spsp = ["--query", "spsp", "--optimize", "always"]
    sharded = ["--mesh", "data", "--shards", "4", "--emulate-devices", "4"]

    def chain(job: tuple[str, str]) -> dict:
        backend, query = job
        d = OUT_DIR / f"drill_{backend}_{query}"
        shutil.rmtree(d, ignore_errors=True)
        steps = {"sssp": (("plain", []),
                          ("drill", ["--checkpoint-dir", str(d)] + drill),
                          ("restore", ["--checkpoint-dir", str(d), "--restore"])),
                 "spsp": (("spsp", spsp),
                          ("spsp_drill", spsp + ["--checkpoint-dir", str(d)] + drill),
                          ("spsp_scratch", ["--query", "spsp", "--engine", "scratch"])),
                 "sharded": (("sharded", sharded),
                             ("sharded_drill", sharded + ["--checkpoint-dir", str(d)] + drill),
                             ("sharded_restore", ["--checkpoint-dir", str(d), "--restore"]))}[query]
        runs = {}
        try:
            for name, extra in steps:
                t0 = time.perf_counter()
                proc = subprocess.run(base + ["--backend", backend] + extra, capture_output=True, text=True,
                                      env=env, cwd=str(ROOT), timeout=600)
                if proc.returncode != 0:
                    raise AssertionError(f"cqp_serve {backend} {name} exited {proc.returncode}:\n"
                                         f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
                res = json.loads(proc.stdout.strip().splitlines()[-1])
                runs[name] = {"wall_s": time.perf_counter() - t0, **{k: res[k] for k in (
                    "updates_per_sec", "p50_ms", "p99_ms", "nbytes_per_query", "answers_sha256",
                    "kernel_launches", "shards", "nbytes_per_device", "peak_diff_bytes_per_device")}}
                if query == "spsp":
                    runs[name]["targets"] = [a["value"] for a in res["aggregates"]]
                    if "planner" in res:
                        runs[name]["planner"] = res["planner"]
                if "recovery" in res:
                    runs[name]["recovery"] = {k: res["recovery"][k] for k in (
                        "history", "restarts", "replayed_chunks", "checkpoints", "checkpoint_bytes",
                        "restore_latency_s")}
        finally:
            shutil.rmtree(d, ignore_errors=True)
        kernel = "fused_sweep" if backend == "fused" else "ell_spmv"
        first, drilled = {"sssp": ("plain", "drill"), "spsp": ("spsp", "spsp_drill"),
                          "sharded": ("sharded", "sharded_drill")}[query]
        for name in (first, drilled):
            if runs[name]["kernel_launches"][kernel] == 0:
                raise AssertionError(f"cqp_serve {backend} {name} launched no {kernel}")
        if "fault@3:InjectedFault" not in runs[drilled]["recovery"]["history"]:
            raise AssertionError(f"cqp_serve {backend} {drilled} history {runs[drilled]['recovery']['history']}")
        if query == "sharded":
            for name in (first, drilled):
                if runs[name]["shards"] != 4 or len(runs[name]["nbytes_per_device"]) != 4:
                    raise AssertionError(f"cqp_serve {name}: {runs[name]['shards']} shards")
            return runs
        if query == "sssp":
            for name in ("drill", "restore"):
                for key in ("nbytes_per_query", "answers_sha256"):
                    if runs[name][key] != runs["plain"][key]:
                        raise AssertionError(f"cqp_serve {backend} {name}: {key} differs from the plain run")
            return runs
        if runs["spsp_drill"]["answers_sha256"] != runs["spsp"]["answers_sha256"]:
            raise AssertionError(f"cqp_serve {backend} spsp drill: answer digests differ from the plain run")
        for name in ("spsp", "spsp_drill"):
            lmk = runs[name]["planner"]["landmark"]
            if runs[name]["planner"]["rewrites_total"] < len(runs[name]["targets"]) or not lmk["live"]:
                raise AssertionError(f"cqp_serve {backend} {name}: planner {runs[name]['planner']}")
            if runs[name]["targets"] != runs["spsp_scratch"]["targets"]:
                raise AssertionError(f"cqp_serve {backend} {name}: targets differ from the scratch run")
        return runs

    jobs = [(b, q) for b in ("fused", "ell") for q in ("sssp", "spsp")] + [("fused", "sharded")]
    ex = ThreadPoolExecutor(max_workers=len(jobs))
    return {"ex": ex, "futures": {job: ex.submit(chain, job) for job in jobs}, "t0": time.perf_counter()}


def cqp_serve_drill_finish(handle: dict) -> dict:
    """Wait for :func:`cqp_serve_drill_start`'s chains (each raises on a
    failed check of its own) and hold the sharded chain's digests to the
    unsharded plain run's."""
    try:
        done = {job: f.result() for job, f in handle["futures"].items()}
    finally:
        handle["ex"].shutdown(wait=True)
    plain = done[("fused", "sssp")]["plain"]
    for name, run in done[("fused", "sharded")].items():
        for key in ("nbytes_per_query", "answers_sha256"):
            if run[key] != plain[key]:
                raise AssertionError(f"cqp_serve fused {name}: {key} differs from the unsharded plain run")
    return {"args": "--v 512 --e 2048 --queries 8 --updates 256 --batch 32 (the CLI defaults)",
            "seconds_since_start": time.perf_counter() - handle["t0"], "equal": True,
            **{b: {**done[(b, "sssp")], **done[(b, "spsp")]} for b in ("fused", "ell")},
            "fused_sharded": done[("fused", "sharded")]}


def parity_session(device, num_vertices: int = 1 << 16) -> dict:
    """Sessions at V = 2**16 whose pools grow 1 → 8 one registration at a
    time (4 SSSP queries, a 32-update chunk, 4 more, a second chunk; 8
    queries, not 16, for the script's time limit), then a
    policy rewrite (det/prob: an iterate shed of one query; VDC: its join
    dropped and re-materialized), a deregistration and a third chunk.  JOD
    on ``coo``, ``ell`` and ``fused``; det and prob on ``ell`` and
    ``fused``; VDC on ``coo`` and ``fused``.  Sessions of one drop mode end
    leaf-equal across backends and JOD answers equal SCRATCH.  The fused
    det session's ``export_state`` after the second chunk imports into a
    CPU engine of the port; the third chunk on both ends leaf-equal."""
    import torch

    from repro_torch.core import dropping as dr
    from repro_torch.core import engine as E
    from repro_torch.core import plan as qplan
    from repro_torch.core.graph import DynamicGraph
    from repro_torch.core.scratch import scratch_like
    from repro_torch.core.session import CQPSession
    from repro_torch.kernels import bloom as K3
    from repro_torch.kernels import diff_lookup as K4
    from repro_torch.kernels import ell_spmv as K1
    from repro_torch.kernels import fused_sweep as K2

    rng = np.random.default_rng(SEED + 5)
    num_edges = round(num_vertices * PATENTS_E / PATENTS_V)
    initial, stream = split_and_stream(uniform_edges(num_vertices, num_edges, rng), 96, 0.2, rng)
    sources = pick_sources(DynamicGraph(num_vertices, initial), 8, rng)
    sessions = {  # name: (backend, engine mode, drop mode)
        "coo": ("coo", "jod", "none"), "ell": ("ell", "jod", "none"), "fused": ("fused", "jod", "none"),
        "ell_det": ("ell", "jod", "det"), "fused_det": ("fused", "jod", "det"),
        "ell_prob": ("ell", "jod", "prob"), "fused_prob": ("fused", "jod", "prob"),
        "vdc_coo": ("coo", "vdc", "none"), "vdc_fused": ("fused", "vdc", "none"),
    }
    out, leaves, exported = {}, {}, None
    for name, (backend, mode, drop_mode) in sessions.items():
        drop = drop_policy(drop_mode, 1 << 20)
        for K in (K1, K2, K3, K4):
            K.reset_launches()
        sess = CQPSession(DynamicGraph(num_vertices, initial), engine="dense", backend=backend,
                          mode=mode, drop=drop, batch_capacity=32, device=device)
        plans = [qplan.sssp(s, max_iters=48, drop=drop) for s in sources]
        handles, caps = [], []
        for k, plan in enumerate(plans):
            handles.append(sess.register(plan))
            caps.append(sess._impl.impl.slot_capacity)
            if k == 3:
                sess.apply_updates_batched(stream[:32])
        sess.apply_updates_batched(stream[32:64])
        eng = sess._impl.impl
        row = {"slot_capacity": caps}
        if drop is not None:
            heavier = dataclasses.replace(drop, p=0.9, seed=9)
            row["shed_freed"] = sess.set_drop_policy(handles[3], heavier)
            if row["shed_freed"] <= 0:
                raise AssertionError(f"{name}: the shed freed {row['shed_freed']} bytes")
        if mode == "vdc":
            row["join_freed"] = sess.set_drop_policy(handles[2], dr.DropConfig(mode="det", p=1.0),
                                                     op="join")
            row["join_back"] = sess.set_drop_policy(handles[2], dr.DropConfig(), op="join")
            if row["join_freed"] <= 0 or row["join_back"] != 0:
                raise AssertionError(f"{name}: join flip {row['join_freed']}, {row['join_back']}")
        row["deregister_freed"] = sess.deregister(handles.pop(5))
        if name == "fused_det":
            arrays, meta = eng.export_state()
            cpu = E.DiffIFE(eng.cfg, copy_graph(eng.graph), np.zeros((eng.cfg.num_queries, num_vertices)),
                            batch_capacity=32, active=np.zeros(eng.cfg.num_queries, bool), device="cpu")
            cpu.import_state(arrays, meta)
            exported = (cpu, len(arrays), meta)
        sess.apply_updates_batched(stream[64:])
        row["launches"] = {K.__name__.rsplit(".", 1)[-1]: K.LAUNCHES for K in (K1, K2, K3, K4)}
        need = {"ell": "ell_spmv", "fused": "fused_sweep", "coo": None}[backend]
        if need is not None and row["launches"][need] == 0:
            raise AssertionError(f"{name}: no {need} launch")
        if mode == "vdc" and row["launches"]["diff_lookup"] == 0:
            raise AssertionError(f"{name}: no diff_lookup launch")
        live = eng.active_slots()
        got = eng.answers()[live]
        want = scratch_like(eng.cfg, eng.graph, eng.state.init[live], device=device).answers()
        np.testing.assert_array_equal(got, want)
        row["equals_scratch"] = True
        key = "vdc" if mode == "vdc" else drop_mode
        got_leaves = {k: x.cpu() for k, x in (vdc_leaves if mode == "vdc" else state_leaves)(eng.state).items()}
        if key in leaves:
            same_leaves(got_leaves, leaves[key][1], f"{name} vs {leaves[key][0]}")
            row["leaf_equal_to"] = leaves[key][0]
        else:
            leaves[key] = (name, got_leaves)
        if name == "fused_det":
            cpu, n_arrays, meta = exported
            cpu.apply_updates_batched(stream[64:])
            same_leaves(state_leaves(cpu.state), got_leaves, "CPU import vs the card")
            row["export"] = {"arrays": n_arrays, "meta": meta, "cpu_import_leaf_equal": True}
            del cpu, exported
        out[name] = row
        del sess, eng, got_leaves
        torch.cuda.empty_cache()
    return {"num_vertices": num_vertices, "num_edges_initial": int(initial.shape[0]),
            "sources": len(sources), "sessions": out}


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
    initial, stream = split_and_stream(uniform_edges(num_vertices, num_edges, rng), PARITY_UPDATES, 0.2, rng)
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
    half = len(stream) // 2  # updates on both sides of the flip
    iters, rows = run(engines, stream[:half])
    freed = {be: e.set_join_store(0, False) for be, e in engines.items()}
    back = {be: e.set_join_store(0, True) for be, e in engines.items()}
    more_iters, more_rows = run(engines, stream[half:])
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
    initial, stream = split_and_stream(uniform_edges(num_vertices, num_edges, rng), PARITY_UPDATES, 0.2, rng)
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
LM_MAIN = dict(batch=8, prompt=4096, steps=32)  # 64 until the training phases took the time
LM_LONG = dict(seq=32768, batch=32, steps=8)  # 16 until the training phases took the time
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
    # the transformer's form since the q-scale repair (qwen2-moe's D = 128):
    # q scaled by D**-0.5 in bf16 first, the kernel told scale=1.0
    scaled = {"max_abs_err": 0.0, "max_row_rel_err": 0.0}
    scaled_shapes = [(1, 16, 16, 128, 128, True), (2, 16, 16, 256, 256, True), (8, 16, 16, 1, 4097, False),
                     (4, 16, 16, 1, 33, False)]
    for (b, hq, hkv, sq, sk, causal), strided in itertools.product(scaled_shapes, (False, True)):
        q, k, v = flash_operands(gen, b, hq, hkv, sq, sk, 128, torch.bfloat16, device, strided=strided)
        q = q * 128**-0.5
        e = flash_err(K5.flash_attention(q, k, v, causal=causal, scale=1.0),
                      K5.flash_attention_plain(q, k, v, causal=causal, scale=1.0))
        if not flash_within(e, "bfloat16"):
            raise AssertionError(f"flash_attention {(b, hq, hkv, sq, sk, 128)} causal={causal} scale=1.0 "
                                 f"strided={strided}: {e} from its plain version")
        scaled = {key: max(scaled[key], x) for key, x in e.items()}
        cases += 1
    torch.cuda.synchronize()
    return {"cases": cases, "head_dims": list(FLASH_DIMS), "max_abs_err": max(x["max_abs_err"] for x in err.values()),
            "prescaled_q_d128_bf16": {"cases": 2 * len(scaled_shapes), **scaled},
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

    def __call__(self, q, k, v, *, causal=True, scale=None):
        form = "decode" if q.shape[2] == 1 else "prefill"
        if form not in self.calls:
            self.calls[form] = (q.clone(), strided_copy(k), strided_copy(v), causal, scale)
        return self.fn(q, k, v, causal=causal, scale=scale)


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
    """Run the path's first prefill (on ``tokens``; none when ``tokens`` is
    None) and first decode step (position ``pos``, fed ``first``) again
    under ``capture``, to keep the operands K5 got there.  It runs after the
    main path's launches, times and peak memory are read, so the copies are
    in none of them; the decode step rewrites cache position ``pos`` with
    the values it holds."""
    import torch

    from repro_torch.configs import lm_harness as H

    with patched_attention(capture):
        if tokens is not None:
            H.make_prefill(cfg)(params, tokens)
        H.make_decode(cfg)(params, cache, first, torch.full((first.shape[0],), pos, dtype=torch.long,
                                                             device=first.device))
    torch.cuda.synchronize()


def plain_attention(q, k, v, *, causal=True, scale=None):
    """The port's plain path for one attention call of the transformer:
    ``chunked_attention`` (the reference's function, at its default blocks)
    on the same operands (the model scales q before it calls K5 with
    ``scale=1.0``, so ``scale`` comes along)."""
    from repro_torch.models import common as cm

    return cm.chunked_attention(q, k, v, causal=causal, scale=scale)


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

    q, k, v, causal, scale = call
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    run = lambda: K5.flash_attention(q, k, v, causal=causal, scale=scale)  # noqa: E731
    plain = lambda: K5.flash_attention_plain(q, k, v, causal=causal, scale=scale)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True,  # noqa: E731
                                                 scale=scale)
    got = run()
    err = flash_err(got, plain())
    if not flash_within(err, dtype_name(q.dtype)):
        raise AssertionError(f"flash_attention {list(q.shape)} x {list(k.shape)}: {err} from its plain version")
    if not bool(torch.equal(run(), got)):  # no atomics: the split-K merge runs in one order
        raise AssertionError(f"flash_attention {list(q.shape)} x {list(k.shape)}: a second call differs")
    lib_err = max_abs_diff(lib().float(), got.float())
    del got
    slow = sq * sk > 1 << 26  # the plain version's direct softmax takes seconds there
    return {"q": list(q.shape), "k": list(k.shape), "k_strides": list(k.stride()), "causal": causal, "scale": scale,
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
        out[name] = flash_real((q, k, v, causal, None))  # the kernel's default scale
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
        traced = device_busy(prof, OUT_DIR / f"chip_smoke_{tag}_{name}_trace.json", k5=True,
                             ranges=PROFILE_RANGES)
        traced["wall_ms"] = wall * 1e3
        traced["device_idle_share"] = 1.0 - traced["device_busy_ms"] / traced["wall_ms"]
        out[name] = traced
    return out


def teacher_forced(cfg, params, tokens, cache, gen, steps: int, start: int, attention=None):
    """The prefill on ``tokens`` (none when None; its cache written into
    ``cache``), then ``steps`` decode steps from position ``start`` fed
    ``gen[0..steps-1]``, with the transformer's attention routed to
    ``attention`` (default: K5).  Returns (the prefill's last logits or
    None, the steps' logits)."""
    with contextlib.ExitStack() as stack:
        if attention is not None:
            stack.enter_context(patched_attention(attention))
        last = None
        if tokens is not None:
            last, pcache, _ = lm_prefill(cfg, params, tokens)
            copy_prefill_cache(cfg, cache, pcache)
            del pcache
        logits, _ = lm_decode(cfg, params, cache, gen[0], start, steps, feed=gen[:steps])
    return last, logits


def logit_agreement(gen, last_k, logits_k, last_p, logits_p) -> dict:
    """Path p's logits against path k's: the largest differences, and how
    often p's top-1 is k's greedy token (``gen``: the token each logits row
    chose on path k)."""
    import torch

    pairs = ([(last_k, last_p)] if last_k is not None else []) + list(zip(logits_k, logits_p))
    preds = ([(gen[0], last_p)] if last_k is not None else []) + list(zip(gen[1:], logits_p))
    scale = max(float(k.float().abs().max()) for k, _ in pairs)
    hits = [int((torch.argmax(p, dim=-1) == g).sum()) for g, p in preds]
    agree = [h / g.numel() for h, (g, _) in zip(hits, preds)]
    out = {"max_abs_logit": scale,
           "decode_logits_max_abs_diff": max(max_abs_diff(k.float(), p.float()) for k, p in zip(logits_k, logits_p)),
           "teacher_forced_top1_agreement": float(np.mean(agree)),
           "teacher_forced_predictions": int(sum(g.numel() for g, _ in preds)),
           "top1_hits_by_step": hits}
    if last_k is not None:
        out["prefill_last_logits_max_abs_diff"] = max_abs_diff(last_k.float(), last_p.float())
    out["logits_max_abs_diff"] = max(max_abs_diff(k.float(), p.float()) for k, p in pairs)
    out["logits_rel_diff"] = out["logits_max_abs_diff"] / scale
    return out


class RouteTape:
    """Wraps ``models.moe.topk_routing``: in mode ``"record"`` it keeps the
    top-k expert indices of every call, in order; in mode ``"replay"`` it
    hands the recorded indices back in the same order, the gates a softmax
    of the call's own logits at them (as ``topk_routing``'s), so a second
    run takes the first run's routes; otherwise it only calls through."""

    def __init__(self, fn):
        self.fn, self.mode, self.idx, self.pos = fn, None, [], 0

    def __call__(self, logits, k: int):
        import torch

        if self.mode == "replay":
            idx = self.idx[self.pos]
            self.pos += 1
            return torch.softmax(torch.gather(logits, -1, idx).float(), dim=-1), idx
        gates, idx = self.fn(logits, k)
        if self.mode == "record":
            self.idx.append(idx.clone())
        return gates, idx


def lm_compare(cfg, params, tokens, cache, gen, logits_k, last_k, start: int, *, routes: bool = False) -> dict:
    """The kernel path's logits against the plain path's (attention through
    ``chunked_attention``) on the same inputs: the prefill's last logits,
    then the decode steps teacher-forced with the kernel run's tokens
    (``cache`` is reused: every position a plain step reads, the plain run
    has written).  K5 must launch no time on a plain path.

    With ``routes`` (an MoE), the same once more with the experts forced
    too (:class:`RouteTape`): the kernel path re-run teacher-forced records
    every layer's routes and the plain path replays them, so the two part
    only where their values do; ``q_scale`` then holds the forced plain
    path in the kernel path's form (q scaled in bf16 by the model, then
    ``flash_attention_plain`` with ``scale=1.0``) against
    ``chunked_attention``, which scales q the same way: the difference left
    after the model took the reference's rounding of q * D**-0.5 at D =
    128 (before, K5 scaled in float32 and the two parted by 1.96% of the
    largest |logit|).  Free routing is reported,
    with the share of tokens whose experts differ layer by layer: one bf16
    rounding moves a token at a top-k boundary to another expert, and the
    move spreads over the layers."""
    import torch

    from repro_torch.kernels import flash_attn as K5
    from repro_torch.models import moe

    steps = len(logits_k)

    def plain(attention):
        n0 = K5.LAUNCHES
        got = teacher_forced(cfg, params, tokens, cache, gen, steps, start, attention)
        if K5.LAUNCHES != n0:
            raise AssertionError("the plain path launched flash_attention")
        return got

    if not routes:
        return logit_agreement(gen, last_k, logits_k, *plain(plain_attention))
    free = RouteTape(moe.topk_routing)
    with patched(moe, "topk_routing", free):
        free.mode = "record"
        out = logit_agreement(gen, last_k, logits_k, *plain(plain_attention))
    tape = RouteTape(moe.topk_routing)
    k5_form = lambda q, k, v, *, causal=True, scale=None: K5.flash_attention_plain(  # noqa: E731
        q, k, v, causal=causal, scale=scale)
    with patched(moe, "topk_routing", tape):
        tape.mode = "record"
        last_r, logits_r = teacher_forced(cfg, params, tokens, cache, gen, steps, start)
        tape.mode = "replay"
        forced = plain(plain_attention)
        tape.pos = 0
        forced_k5 = plain(k5_form)
        tape.mode = None
    out["free_routing_top1_agreement"] = out["teacher_forced_top1_agreement"]
    # the first forward call's layers (the prefill's, else the first decode
    # step's): the share of tokens whose expert set differs between the
    # kernel path and the free plain path
    out["free_routes_differ_by_layer"] = [
        float((torch.sort(a, dim=-1).values != torch.sort(b, dim=-1).values).any(dim=-1).float().mean())
        for a, b in zip(tape.idx[:cfg.num_layers], free.idx[:cfg.num_layers])]
    out["routes_forced"] = logit_agreement(gen, last_r, logits_r, *forced)
    out["routes_forced"]["routing_calls"] = len(tape.idx)
    out["kernel_rerun_bit_equal"] = all(bool((a == b).all()) for a, b in zip(logits_r, logits_k)) and (
        last_k is None or bool((last_r == last_k).all()))
    gen_f = [None if forced_k5[0] is None else torch.argmax(forced_k5[0], dim=-1)] + [
        torch.argmax(lg, dim=-1) for lg in forced_k5[1]]
    q = logit_agreement(gen_f, forced_k5[0], forced_k5[1], *forced)
    out["q_scale"] = {"what": "plain path, routes forced, after the repair: the kernel path's form (q scaled "
                              "in bf16 by the model, flash_attention_plain with scale=1.0) against "
                              "chunked_attention (q scaled in bf16)",
                      "logits_max_abs_diff": q["logits_max_abs_diff"], "logits_rel_diff": q["logits_rel_diff"],
                      "top1_agreement": q["teacher_forced_top1_agreement"]}
    return out


def copy_prefill_cache(cfg, cache, pcache) -> None:
    """Write a prefill's stacked cache into the head of a decode cache along
    its position axis (GQA keys and values; MLA's latents)."""
    from repro_torch.models import transformer as tf

    axis = tf.cache_seq_axis(cfg)
    for c, p in zip(cache, pcache):
        c.narrow(axis, 0, p.shape[axis]).copy_(p)


def k5_calls(cfg, calls: int) -> int:
    """K5's launches for ``calls`` forward calls: one a layer a call for
    GQA; none for MLA, whose attention is ``chunked_attention``."""
    return cfg.num_layers * calls if cfg.attention == "gqa" else 0


def lm_prefill_decode_phase(cfg, params, *, batch: int, prompt: int, steps: int, tag: str,
                            device, capture: FlashCapture | None = None, tally=None,
                            compare: bool = True, profile: bool = True) -> tuple[dict, dict]:
    """``make_prefill`` on batch × prompt random tokens, then ``steps``
    greedy ``make_decode`` steps against a cache of prompt + steps
    positions (the prefill's cache copied in); K5's count zeroed just before
    and read just after, and it must equal layers × calls (none for MLA).
    ``tally`` (a :class:`MoeTap`) has its ``phase`` set to ``"prefill"``
    and ``"decode"`` around the two.  Then, with ``capture``, K5's operands
    of the first prefill and decode step (:func:`capture_forms`), with
    ``profile`` one profiled prefill and decode step, and, with ``compare``, the plain path
    on the same inputs.  Returns the phase's fields and the run (tokens,
    greedy tokens, logits, the decode cache)."""
    import torch

    from repro_torch.kernels import flash_attn as K5
    from repro_torch.models import transformer as tf

    rng = np.random.default_rng(SEED + 6)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt))).to(device)
    torch.cuda.reset_peak_memory_stats()
    K5.reset_launches()  # ---- the main path starts here
    if tally is not None:
        tally.phase = "prefill"
    last, pcache, prefill_s = lm_prefill(cfg, params, tokens)
    cache = tf.init_cache(cfg, batch, prompt + steps, device=device)
    copy_prefill_cache(cfg, cache, pcache)
    del pcache
    first = torch.argmax(last, dim=-1)
    if tally is not None:
        tally.phase = "decode"
    logits, step_ms = lm_decode(cfg, params, cache, first, prompt, steps)
    launches = K5.LAUNCHES  # ---- and ends here
    if tally is not None:
        tally.phase = None
    peak = torch.cuda.max_memory_allocated()
    if launches != k5_calls(cfg, 1 + steps):
        raise AssertionError(f"{tag}: {launches} flash_attention launches for {cfg.num_layers} layers x "
                             f"{1 + steps} calls ({cfg.attention})")
    if capture is not None:
        capture_forms(cfg, params, tokens, cache, first, prompt, capture)
    gen = [first] + [torch.argmax(lg, dim=-1) for lg in logits]
    for lg in [last, *logits]:
        if tuple(lg.shape) != (batch, cfg.vocab_size) or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{tag}: logits of shape {tuple(lg.shape)} or not finite")
    traced = lm_profile(cfg, params, tokens, cache, gen[-2], prompt + steps - 1, tag) if profile else None
    out = {"batch": batch, "prompt_len": prompt, "decode_steps": steps, "prefill_s": prefill_s,
           "prefill_tokens_per_s": batch * prompt / prefill_s,
           "decode_tokens_per_s": batch * steps / (sum(step_ms) / 1e3),
           "decode_step_ms_p50": float(np.percentile(step_ms, 50)),
           "decode_step_ms_p99": float(np.percentile(step_ms, 99)), "decode_step_ms": step_ms,
           "peak_device_memory": peak, "launches": launches,
           "launches_expected": f"{cfg.num_layers} layers x {1 + steps} calls" if cfg.attention == "gqa"
           else "none: MLA attention is chunked_attention",
           "traced": traced}
    if compare:
        out["vs_plain"] = lm_compare(cfg, params, tokens, cache, gen, logits, last, prompt, routes=cfg.moe)
    return out, {"tokens": tokens, "gen": gen, "logits": logits, "last": last, "cache": cache}


def main_lm(device, capture: FlashCapture) -> tuple[dict, dict]:
    """llama3.2-1b at its published widths in bf16, weights from a seeded
    generator: ``make_prefill`` on 8 x 4096 tokens and 32 decode steps,
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
    phase, run = lm_prefill_decode_phase(cfg, params, **LM_MAIN, tag="lm", device=device, capture=capture)
    out.update(phase)
    del run
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
    then :data:`LM_LONG`'s 8 ``make_decode`` steps at batch 32 against a
    32768-position cache filled from the generator (positions
    32760..32767)."""
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
    phase, run = lm_prefill_decode_phase(cfg, params, **LM_F32, tag="lm_f32", device=device, capture=capture)
    out.update(phase)
    del run
    rel = out["vs_plain"]["logits_rel_diff"]
    if not rel <= F32_LOGIT_REL_TOL:
        raise AssertionError(f"main_lm_f32: logits differ from the plain path by {rel} of the largest")
    del params
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------- MoE, MLA and MIND
# the cells' sizes and their cuts (PERF.md §4)
MOE_MAIN = dict(batch=8, prompt=4096, steps=16)  # 32 until the training phases took the time
# 24 steps, where there were 8: at 8, 32 teacher-forced tokens hold the 0.9
# floor to chance (25/32 once the model scaled q in bf16 as the reference
# does).  The steps decode positions seq - steps .. seq - 1, so the 8-step
# run's tokens are not the first 8 of these; over 24 steps the check reads
# 92/96 (PERF.md §6), every step's hits in ``top1_hits_by_step``
MOE_LONG = dict(seq=32768, batch=4, steps=24)
# minicpm3's decode steps are cut to 8 and 2 (the time limit: on an H100
# a step of the plain MLA attention takes 0.38-0.46 s at 4k positions and
# 1.4-1.6 s at 32k)
# batch 8 and 16 steps before the GNN phase took the time, 8 steps until the
# training phases did
MLA_MAIN = dict(batch=4, prompt=4096, steps=8)
MLA_LONG = dict(seq=32768, batch=4, steps=2)  # 4 before it
MLA_F32 = dict(layers=2, batch=2, prompt=128, steps=4)
MOE_F32 = dict(layers=4, batch=2, prompt=1024, steps=8)
# main_mla: decode logits at position t against a forward's at t, over the
# largest |logit|: the bfloat16 limit of the port's CUDA-vs-plain tests
# (tests/test_torch_transformer.py)
BF16_LOGIT_REL_TOL = 5e-2
# main_mind: the card's serve_p99 scores against the CPU's (float32, TF32
# off), relative, with an absolute floor of the same share of the largest
# |score| (a max over interests of 64-term dot products lands near zero
# for some candidates, where a relative limit alone says nothing)
MIND_RTOL = 1e-5
# the profiler ranges the transformer and the MoE FFN open
PROFILE_RANGES = ("attention", "mlp", "moe.dispatch", "moe.experts", "moe.combine", "moe.aux")


@contextlib.contextmanager
def patched(obj, name: str, fn):
    """Set ``obj.name`` to ``fn`` for the duration."""
    old = getattr(obj, name)
    setattr(obj, name, fn)
    try:
        yield fn
    finally:
        setattr(obj, name, old)


class MoeTap:
    """Taps ``models.moe``'s ``dispatch_indices`` and ``topk_routing``,
    calling both unchanged.  While ``phase`` is set (the timed run) it adds
    up on the device the choices the dispatch drops, by phase; while it is
    None it keeps a copy of the router logits of the first ``topk_routing``
    call at each token count (layer 0 of a prefill, of a decode step)."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.phase = moe, None
        self.dispatch_fn, self.routing_fn = moe.dispatch_indices, moe.topk_routing
        self.drops: dict[str, list] = {}
        self.logits: dict[int, object] = {}

    def dispatch(self, idx, num_experts: int, capacity: int):
        slot = self.dispatch_fn(idx, num_experts, capacity)
        if self.phase is not None:
            self.drops.setdefault(self.phase, []).append(((slot < 0).sum(), slot.numel()))
        return slot

    def routing(self, logits, k: int):
        if self.phase is None and logits.shape[0] not in self.logits:
            self.logits[logits.shape[0]] = logits.clone()
        return self.routing_fn(logits, k)

    @contextlib.contextmanager
    def installed(self):
        with patched(self.moe, "dispatch_indices", self.dispatch), \
                patched(self.moe, "topk_routing", self.routing):
            yield self

    def dropped(self) -> dict:
        """Per phase: choices made, dropped, and the dropped share."""
        out = {}
        for phase, calls in self.drops.items():
            dropped = int(sum(int(d) for d, _ in calls))
            total = sum(n for _, n in calls)
            out[phase] = {"calls": len(calls), "choices": total, "dropped": dropped,
                          "dropped_share": dropped / total}
        return out


def routing_check(cfg, logits) -> dict:
    """``topk_routing`` and ``dispatch_indices`` on one layer's router
    logits from the card, run on the card and on a host copy, with the
    model's capacity for that many tokens: top-k indices, slots and
    per-expert counts must be equal bit for bit."""
    import torch

    from repro_torch.models import moe

    t, k = logits.shape[0], cfg.top_k
    e = cfg.num_experts_padded or cfg.num_experts
    capacity = max(1, int(cfg.capacity_factor * t * k / cfg.num_experts))
    got = {}
    for where, lg in (("cuda", logits), ("cpu", logits.cpu())):
        gates, idx = moe.topk_routing(lg, k)
        slot = moe.dispatch_indices(idx, e, capacity)
        counts = torch.bincount((slot[slot >= 0] // capacity).long(), minlength=e)
        got[where] = [x.cpu() for x in (idx, slot, counts, gates)]
    for name, a, b in zip(("idx", "slot", "counts"), got["cuda"], got["cpu"]):
        if not torch.equal(a, b):
            raise AssertionError(f"routing of {t} tokens: {name} on the card differs from the CPU's "
                                 f"in {int((a != b).sum())} places")
    top = torch.sort(logits.cpu(), dim=-1, descending=True).values
    return {"tokens": t, "capacity": capacity, "idx_slot_counts_equal": True,
            "gates_max_abs_diff": max_abs_diff(got["cuda"][3], got["cpu"][3]),
            "top_k_boundary_ties": int((top[:, k - 1] == top[:, k]).sum()),
            "dropped_choices": int((got["cpu"][1] < 0).sum()),
            "max_expert_load": int(got["cpu"][2].max())}


def init_lm(cfg, device) -> tuple[dict, dict]:
    """``init_params`` from a CUDA generator seeded ``SEED``: the weights
    and the init's seconds, the weights' bytes, and the init's peak device
    memory above what the finished weights hold in the allocator, which may
    be at most the largest float32 slice ``ParamFactory`` draws at once,
    rounded up to the allocator's 2 MiB granule (a large block keeps an
    unsplit remainder under that)."""
    import torch

    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tf

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    leaves = list(tf._leaves(params))
    weights = sum(x.numel() * x.element_size() for x in leaves)
    slice_bytes = 0
    for x in leaves:
        row = x[0].numel() if x.ndim > 1 else 1
        slice_bytes = max(slice_bytes, min(x.shape[0], max(1, cm.ParamFactory.DRAW_ELEMENTS // row)) * row * 4)
    granule = 2 << 20
    limit = -(-slice_bytes // granule) * granule
    if peak - held > limit:
        raise AssertionError(f"{cfg.name}: init peaked {peak - held} bytes above the {held} the weights hold, "
                             f"more than one float32 slice ({slice_bytes}, {limit} in 2 MiB granules)")
    return params, {"init_s": init_s, "init_peak_device_memory": peak, "weights_bytes": weights,
                    "weights_allocated": held, "init_draw_slice_bytes": slice_bytes,
                    "init_peak_over_weights": peak - held, "init_peak_over_weights_limit": limit}


def lm_serve_check(arch, cfg, device) -> dict:
    """``lm_serve`` at the CLI defaults (batch 4, prompt 16, gen 8) on
    ``cfg``, K5's count zeroed before and read after: one launch a layer a
    step for GQA, none for MLA; the tokens in the vocabulary."""
    from repro_torch.kernels import flash_attn as K5
    from repro_torch.launch import model_serve as MS

    K5.reset_launches()  # ---- lm_serve's path starts here
    served = MS.lm_serve(arch, 4, 16, 8, cfg=cfg, device=device)
    launches = K5.LAUNCHES  # ---- and ends here
    if launches != k5_calls(cfg, 16 + 8 - 1):
        raise AssertionError(f"lm_serve {cfg.name}: {launches} flash_attention launches")
    toks = served["tokens"]
    if tuple(toks.shape) != (4, 8) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"lm_serve {cfg.name} returned tokens {toks}")
    return {"batch": 4, "prompt_len": 16, "gen": 8, "seconds": served["seconds"],
            "tokens_per_s": served["tokens_per_s"], "launches": launches, "tokens_row0": toks[0].tolist()}


def moe_expert_bytes(cfg) -> int:
    """Bytes of every layer's expert weights, which each decode step reads
    whole: the padded experts' three matrices (the capacity is at least
    one row an expert, so every expert's product runs)."""
    e = cfg.num_experts_padded or cfg.num_experts
    return 3 * e * cfg.d_model * cfg.d_ff_expert * 2 * cfg.num_layers


def long_decode(cfg, params, *, seq: int, batch: int, steps: int, seed: int, device, tally=None):
    """``decode_32k`` at ``batch`` rows: ``steps`` ``make_decode`` steps
    at positions seq - steps .. seq - 1 against a ``seq``-position cache
    filled from a CUDA generator seeded ``seed``, the first fed a seeded
    token; K5's count zeroed just before and read just after (one launch a
    layer a step for GQA, none for MLA), ``tally`` in its ``"decode"``
    phase, the logits finite.  Returns the decode's fields and the run
    (cache, the fed token, logits)."""
    import torch

    from repro_torch.kernels import flash_attn as K5
    from repro_torch.models import transformer as tf

    feed = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch,))).to(device)
    cache = tf.init_cache(cfg, batch, seq, device=device)
    gen_t = torch.Generator(device=device).manual_seed(seed)
    for c in cache:
        c.normal_(generator=gen_t)
    torch.cuda.reset_peak_memory_stats()
    K5.reset_launches()  # ---- the main path starts here
    if tally is not None:
        tally.phase = "decode"
    logits, step_ms = lm_decode(cfg, params, cache, feed, seq - steps, steps)
    launches = K5.LAUNCHES  # ---- and ends here
    if tally is not None:
        tally.phase = None
    if launches != k5_calls(cfg, steps) or not all(bool(torch.isfinite(lg).all()) for lg in logits):
        raise AssertionError(f"{cfg.name} 32k decode: {launches} flash_attention launches for "
                             f"{cfg.num_layers} x {steps} ({cfg.attention}), or logits not finite")
    out = {"seq_len": seq, "decode_batch": batch, "decode_steps": steps,
           "cache_bytes": sum(c.numel() * c.element_size() for c in cache),
           "decode_tokens_per_s": batch * steps / (sum(step_ms) / 1e3),
           "decode_step_ms_p50": float(np.percentile(step_ms, 50)),
           "decode_step_ms_p99": float(np.percentile(step_ms, 99)), "decode_step_ms": step_ms,
           "peak_device_memory": torch.cuda.max_memory_allocated(), "launches": launches}
    return out, {"cache": cache, "feed": feed, "logits": logits}


def main_moe(device, capture: FlashCapture) -> dict:
    """qwen2-moe-a2.7b at its published widths in bf16, weights from a
    seeded generator: ``make_prefill`` on 8 x 4096 tokens and 16 decode
    steps (K5 one launch a layer a call), the dropped share of the routed
    choices in each, the dispatch on the card against the CPU's on one
    layer's router logits, the plain path teacher-forced beside it with
    free and with forced routes (top-1 >= :data:`BF16_TOP1_FLOOR` forced,
    :func:`lm_compare`) and the logit difference the q scaling's rounding
    makes at D = 128, ``lm_serve`` at the CLI defaults on ``arch.full()``,
    then :func:`moe_f32_check`."""
    import torch

    from repro_torch.configs import get_arch

    arch = get_arch("qwen2-moe-a2.7b")
    cfg = arch.full()
    params, init = init_lm(cfg, device)
    lm_prefill(cfg, params, torch.zeros((1, 64), dtype=torch.long, device=device))  # warm-up
    out = {"arch": arch.name, "dtype": dtype_name(cfg.dtype), "num_params": cfg.num_params(),
           "num_active_params": cfg.num_active_params(), **init,
           "reduced": {"prefill_32k.global_batch": "32 -> 8", "prefill_32k.seq_len": "32768 -> 4096"}}
    tap = MoeTap()
    with tap.installed():
        phase, run = lm_prefill_decode_phase(cfg, params, **MOE_MAIN, tag="moe", device=device,
                                             capture=capture, tally=tap)
    out.update(phase)
    out["dispatch_dropped"] = tap.dropped()
    prefill_t = MOE_MAIN["batch"] * MOE_MAIN["prompt"]
    out["routing_card_vs_cpu"] = {"prefill_layer0": routing_check(cfg, tap.logits[prefill_t]),
                                  "decode_layer0": routing_check(cfg, tap.logits[MOE_MAIN["batch"]])}
    agree = out["vs_plain"]["routes_forced"]["teacher_forced_top1_agreement"]
    if not agree >= BF16_TOP1_FLOOR:
        raise AssertionError(f"main_moe: with the routes forced, the plain path agrees with the kernel "
                             f"path's tokens {agree} of the time")
    del run
    nbytes = moe_expert_bytes(cfg)
    out["decode_expert_weight_bytes_per_step"] = nbytes
    out["decode_weight_bytes_per_step"] = init["weights_bytes"]
    out["decode_weight_read_bound_ms"] = init["weights_bytes"] / HBM_BYTES_PER_S * 1e3
    del params
    torch.cuda.empty_cache()
    out["lm_serve"] = lm_serve_check(arch, cfg, device)
    out["float32_vs_plain"] = moe_f32_check(device)
    torch.cuda.empty_cache()
    return out


def moe_f32_check(device) -> dict:
    """qwen2-moe-a2.7b at full width with its depth cut to
    ``MOE_F32["layers"]``, float32, TF32 off: the kernel path (K5 at D =
    128 in float32, the dispatch on the card) against the plain path
    (``chunked_attention``) on the same weights, prefill
    ``MOE_F32["batch"]`` x ``MOE_F32["prompt"]`` and ``MOE_F32["steps"]``
    greedy decode steps, teacher-forced; logits within
    :data:`F32_LOGIT_REL_TOL` of the largest |logit|.  In float32 a
    rounding difference almost never crosses a top-k boundary, so the
    routes agree without forcing."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = MOE_F32
    cfg = dataclasses.replace(get_arch("qwen2-moe-a2.7b").full(), num_layers=c["layers"], dtype=torch.float32)
    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(SEED + 1), device=device)
    out = {"layers": c["layers"], "dtype": "float32", "allow_tf32": False, "rel_tolerance": F32_LOGIT_REL_TOL}
    phase, run = lm_prefill_decode_phase(cfg, params, batch=c["batch"], prompt=c["prompt"], steps=c["steps"],
                                         tag="moe_f32", device=device)
    del run
    out.update({k: phase[k] for k in ("batch", "prompt_len", "decode_steps", "launches", "vs_plain")})
    rel = phase["vs_plain"]["logits_rel_diff"]
    if not rel <= F32_LOGIT_REL_TOL:
        raise AssertionError(f"main_moe float32: logits differ from the plain path by {rel} of the largest")
    del params
    torch.cuda.empty_cache()
    return out


def main_moe_long(device, capture: FlashCapture) -> dict:
    """qwen2-moe-a2.7b's ``decode_32k`` with its batch cut to 4: 8
    ``make_decode`` steps against a 32768-position cache filled from the
    generator (positions 32760..32767), K5 one launch a layer a step, the
    dropped share, and the plain path teacher-forced on the same cache."""
    import torch

    from repro_torch.configs import get_arch

    cfg = get_arch("qwen2-moe-a2.7b").full()
    seq, steps = MOE_LONG["seq"], MOE_LONG["steps"]
    params, init = init_lm(cfg, device)
    tap = MoeTap()
    with tap.installed():
        decode, run = long_decode(cfg, params, **MOE_LONG, seed=SEED + 9, device=device, tally=tap)
    cache, feed, logits = run["cache"], run["feed"], run["logits"]
    capture_forms(cfg, params, None, cache, feed, seq - steps, capture)
    gen = [feed] + [torch.argmax(lg, dim=-1) for lg in logits]
    vs_plain = lm_compare(cfg, params, None, cache, gen, logits, None, seq - steps, routes=True)
    forced = vs_plain["routes_forced"]
    agree = forced["teacher_forced_top1_agreement"]
    if not agree >= BF16_TOP1_FLOOR:
        raise AssertionError(f"main_moe_long: with the routes forced, the plain path agrees with the kernel "
                             f"path's tokens {agree} of the time")
    hits, n = forced["top1_hits_by_step"], forced["teacher_forced_predictions"]
    out = {"arch": cfg.name, "dtype": dtype_name(cfg.dtype), "init_s": init["init_s"],
           "reduced": {"decode_32k.global_batch": "128 -> 4"}, **decode,
           "launches_expected": f"{cfg.num_layers} layers x {steps} calls",
           "dispatch_dropped": tap.dropped(), "vs_plain": vs_plain,
           # the floor's margin in tokens, and the first 8 steps on their own
           "routes_forced_hits": sum(hits), "routes_forced_floor_hits": math.ceil(BF16_TOP1_FLOOR * n),
           "routes_forced_hits_first_8_steps": sum(hits[:8])}
    del cache, params, logits, run
    torch.cuda.empty_cache()
    return out


def mla_decode_vs_forward(cfg, params, run, rows: int = 2) -> dict:
    """Check 1 of ``main_mla``: the decode steps' logits at positions
    P..P+n-1 (greedy, each fed its predecessor's token) against one forward
    over the prompt and those tokens (its logits at the same positions) on
    the first ``rows`` rows, and the prefill's last logits against the
    forward's at P-1; the largest difference over the largest |logit|
    within :data:`BF16_LOGIT_REL_TOL`.  A latent written to the wrong place
    of the cache moves the decode logits by far more."""
    import torch

    from repro_torch.models import transformer as tf

    tokens, gen = run["tokens"][:rows], run["gen"]
    p, n = tokens.shape[1], len(run["logits"])
    ext = torch.cat([tokens, torch.stack([g[:rows] for g in gen[:n]], dim=1)], dim=1)
    full, cache, _ = tf.forward(cfg, params, ext)
    del cache
    pairs = [(run["last"][:rows], full[:, p - 1])] + [(lg[:rows], full[:, p + i]) for i, lg in enumerate(run["logits"])]
    scale = max(float(b.float().abs().max()) for _, b in pairs)
    diffs = [max_abs_diff(a.float(), b.float()) for a, b in pairs]
    agree = float(np.mean([float((torch.argmax(a, -1) == torch.argmax(b, -1)).float().mean()) for a, b in pairs]))
    rel = max(diffs) / scale
    if not rel <= BF16_LOGIT_REL_TOL:
        raise AssertionError(f"main_mla: decode logits differ from the forward's by {rel} of the largest")
    return {"rows": rows, "positions": f"{p - 1}..{p + n - 1}", "max_abs_logit": scale,
            "max_abs_diff": max(diffs), "rel_diff": rel, "rel_tolerance": BF16_LOGIT_REL_TOL,
            "max_abs_diff_by_position": diffs, "top1_agreement": agree}


def mla_f32_check(device) -> dict:
    """Check 2 of ``main_mla``: minicpm3-4b at full width with its depth
    cut to 2 layers, float32, TF32 off, on the card against the CPU on the
    same weights (drawn on the CPU, copied over): the prefill's logits at
    every position and 4 decode steps (each fed a seeded token) within
    :data:`F32_LOGIT_REL_TOL` of the largest |logit|."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs import lm_harness as H
    from repro_torch.models import transformer as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = MLA_F32
    cfg = dataclasses.replace(get_arch("minicpm3-4b").full(), num_layers=c["layers"], dtype=torch.float32)
    host = tf.init_params(cfg, torch.Generator().manual_seed(SEED + 3), device="cpu")
    dev = {k: ({n: a.to(device) for n, a in v.items()} if isinstance(v, dict) else v.to(device))
           for k, v in host.items()}
    rng = np.random.default_rng(SEED + 3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (c["batch"], c["prompt"])))
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size, (c["steps"], c["batch"])))
    res = {}
    for where, params in (("cuda", dev), ("cpu", host)):
        d = "cpu" if where == "cpu" else device
        logits, pcache, _ = tf.forward(cfg, params, tokens.to(d))
        cache = tf.init_cache(cfg, c["batch"], c["prompt"] + c["steps"], device=d)
        copy_prefill_cache(cfg, cache, pcache)
        steps = [logits]
        for i in range(c["steps"]):
            pos = torch.full((c["batch"],), c["prompt"] + i, dtype=torch.long, device=d)
            lg, cache = H.make_decode(cfg)(params, cache, feed[i].to(d), pos)
            steps.append(lg)
        res[where] = [x.cpu() for x in steps]
    scale = max(float(x.abs().max()) for x in res["cpu"])
    diffs = [max_abs_diff(a, b) for a, b in zip(res["cuda"], res["cpu"])]
    rel = max(diffs) / scale
    if not rel <= F32_LOGIT_REL_TOL:
        raise AssertionError(f"main_mla float32: the card's logits differ from the CPU's by {rel} of the largest")
    del dev, host
    torch.cuda.empty_cache()
    return {"layers": c["layers"], "batch": c["batch"], "prompt_len": c["prompt"], "decode_steps": c["steps"],
            "allow_tf32": False, "max_abs_logit": scale, "prefill_max_abs_diff": diffs[0],
            "decode_max_abs_diff": max(diffs[1:]), "rel_diff": rel, "rel_tolerance": F32_LOGIT_REL_TOL}


def main_mla(device) -> dict:
    """minicpm3-4b at its published widths in bf16, weights from a seeded
    generator: ``make_prefill`` on 4 x 4096 and 8 decode steps (MLA runs
    ``chunked_attention``: K5 launches no time), check 1
    (:func:`mla_decode_vs_forward`), a batch-4 decode at 32768 positions
    against a latent cache from the generator, ``lm_serve`` at the CLI
    defaults on ``arch.full()``, and check 2 (:func:`mla_f32_check`)."""
    import torch

    from repro_torch.configs import get_arch

    arch = get_arch("minicpm3-4b")
    cfg = arch.full()
    params, init = init_lm(cfg, device)
    lm_prefill(cfg, params, torch.zeros((1, 64), dtype=torch.long, device=device))  # warm-up
    out = {"arch": arch.name, "dtype": dtype_name(cfg.dtype), "num_params": cfg.num_params(), **init,
           "reduced": {"prefill_32k.global_batch": f"32 -> {MLA_MAIN['batch']}",
                       "prefill_32k.seq_len": "32768 -> 4096", "decode_32k.global_batch": "128 -> 4"}}
    phase, run = lm_prefill_decode_phase(cfg, params, **MLA_MAIN, tag="mla", device=device, compare=False)
    out.update(phase)
    for form in ("prefill", "decode_step"):
        t = phase["traced"][form]
        out[f"{form}_attention_share"] = t["device_ms_by_range"]["attention"] / t["device_busy_ms"]
    out["decode_vs_forward"] = mla_decode_vs_forward(cfg, params, run)
    del run
    torch.cuda.empty_cache()
    # decode_32k at batch 4: the latents from the generator
    out["decode_32k"], run = long_decode(cfg, params, **MLA_LONG, seed=SEED + 10, device=device)
    del run, params
    torch.cuda.empty_cache()
    out["lm_serve"] = lm_serve_check(arch, cfg, device)
    out["float32_2_layers_card_vs_cpu"] = mla_f32_check(device)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- the model axis: qwen2-72b, arctic-480b
# depth cut, widths the published ones (PERF.md §4)
QWEN72B = dict(layers=8, batch=4, prompt=4096, steps=8)
QWEN72B_LONG = dict(seq=32768, batch=16, steps=8)  # decode_32k: batch 128 -> 16, 17.2 GB of cache
QWEN72B_F32 = dict(layers=2, batch=2, prompt=512, steps=4)
ARCTIC = dict(layers=2, batch=4, prompt=4096, steps=8)
ARCTIC_DECODE_BATCH = 8  # the reference's capacity floor: one slot an expert
MLA_DLSE = dict(layers=2, batch=2, prompt=128, steps=4)
DLSE_MESH = (1, 4)  # ("data", "model"), emulated on the one card


def dlse_compare(cfg, params, cache, gen, logits_k, start: int, *, routes: bool = False) -> dict:
    """The decode steps of a K5 run teacher-forced again (fed ``gen``,
    from position ``start``) under an emulated :data:`DLSE_MESH` mesh, so
    every decode attention is ``models/common.dlse_*`` over the cache split
    along its sequence by ``cache_specs`` (the blocks views of ``cache``;
    K5 must launch no time), against the K5 run's logits ``logits_k``.
    With ``routes`` (an MoE) the K5 steps are re-run teacher-forced first,
    recording every layer's routes, which the dlse run then replays
    (:class:`RouteTape`).  The step times are the emulation's, not a speed
    of sequence parallelism."""
    import torch

    from repro_torch.kernels import flash_attn as K5
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import common as cm
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import mesh_rules as mr

    mesh = make_mesh(DLSE_MESH, ("data", "model"), device=cache[0].device, emulate=True)
    placed = [s.place(c) for s, c in zip(mr.shardings_for(tf.cache_specs(cfg), mesh), cache)]
    views = all(b.untyped_storage().data_ptr() == c.untyped_storage().data_ptr()
                for p, c in zip(placed, cache) for b in p.blocks.values())
    if not views:
        raise AssertionError(f"{cfg.name}: the cache's blocks on the emulated mesh are not views of it")
    steps = len(logits_k)
    tape = RouteTape(moe.topk_routing)
    with patched(moe, "topk_routing", tape):
        ref_logits = logits_k
        if routes:
            tape.mode = "record"
            ref_logits, _ = lm_decode(cfg, params, cache, gen[0], start, steps, feed=gen[:steps])
            tape.mode = "replay"
        n0 = K5.LAUNCHES
        with cm.activation_mesh(mesh):
            logits_d, step_ms = lm_decode(cfg, params, cache, gen[0], start, steps, feed=gen[:steps])
        launched = K5.LAUNCHES - n0
    if launched:
        raise AssertionError(f"{cfg.name}: the dlse decode launched flash_attention {launched} times")
    if not all(bool(torch.isfinite(lg).all()) for lg in logits_d):
        raise AssertionError(f"{cfg.name}: the dlse decode's logits are not finite")
    out = logit_agreement(gen, None, ref_logits, None, logits_d)
    out.update({"mesh": dict(zip(("data", "model"), DLSE_MESH)), "emulated": True, "cache_blocks_are_views": True,
                "dlse_decode_step_ms": step_ms, "dlse_decode_step_ms_p50": float(np.percentile(step_ms, 50)),
                "what_the_times_are": "the cost of emulating the mesh on one card, not a speed of sequence "
                                      "parallelism"})
    if routes:
        out["routing_calls"] = len(tape.idx)
        out["kernel_rerun_bit_equal"] = all(bool((a == b).all()) for a, b in zip(ref_logits, logits_k))
    return out


def plain_decode(cfg, params, cache, gen, start: int, steps: int):
    """The decode steps teacher-forced on the plain path (attention through
    ``chunked_attention``, no mesh); K5 must launch no time."""
    from repro_torch.kernels import flash_attn as K5

    n0 = K5.LAUNCHES
    _, logits = teacher_forced(cfg, params, None, cache, gen, steps, start, plain_attention)
    if K5.LAUNCHES != n0:
        raise AssertionError("the plain path launched flash_attention")
    return logits


def main_qwen72b(device, capture: FlashCapture) -> dict:
    """qwen2-72b at its published widths with its depth cut to
    ``QWEN72B["layers"]``, bf16, weights from a seeded generator:
    ``make_prefill`` on 4 x 4096 through K5 (8 query heads a KV head at D =
    128) and 8 decode steps, K5 one launch a layer a call; the plain path
    teacher-forced beside it and the dlse path under an emulated (1, 4)
    mesh (:func:`dlse_compare`), each at top-1 >= :data:`BF16_TOP1_FLOOR`;
    a ``decode_32k``-shaped run at batch 16 on a cache from the generator
    on K5 and on the dlse path; then :func:`qwen72b_f32_check`."""
    import torch

    from repro_torch.configs import get_arch

    arch = get_arch("qwen2-72b")
    c = QWEN72B
    cfg = dataclasses.replace(arch.full(), num_layers=c["layers"])
    params, init = init_lm(cfg, device)
    lm_prefill(cfg, params, torch.zeros((1, 64), dtype=torch.long, device=device))  # warm-up
    out = {"arch": arch.name, "dtype": dtype_name(cfg.dtype), "layers": cfg.num_layers,
           "num_params": cfg.num_params(), "num_params_full": arch.full().num_params(), **init,
           "reduced": {"num_layers": f"80 -> {c['layers']}", "prefill_32k.global_batch": f"32 -> {c['batch']}",
                       "prefill_32k.seq_len": f"32768 -> {c['prompt']}",
                       "decode_32k.global_batch": f"128 -> {QWEN72B_LONG['batch']}"}}
    phase, run = lm_prefill_decode_phase(cfg, params, batch=c["batch"], prompt=c["prompt"], steps=c["steps"],
                                         tag="qwen72b", device=device, capture=capture, compare=False)
    out.update(phase)
    # the dlse path first, on the cache the kernel path wrote; the plain
    # path's prefill then rewrites it
    out["vs_dlse"] = dlse_compare(cfg, params, run["cache"], run["gen"], run["logits"], c["prompt"])
    out["vs_plain"] = lm_compare(cfg, params, run["tokens"], run["cache"], run["gen"], run["logits"], run["last"],
                                 c["prompt"])
    del run
    for what in ("vs_plain", "vs_dlse"):
        agree = out[what]["teacher_forced_top1_agreement"]
        if not agree >= BF16_TOP1_FLOOR:
            raise AssertionError(f"main_qwen72b: the {what[3:]} path agrees with the kernel path's tokens "
                                 f"{agree} of the time")
    torch.cuda.empty_cache()
    s = QWEN72B_LONG
    long, lrun = long_decode(cfg, params, **s, seed=SEED + 11, device=device)
    lgen = [lrun["feed"]] + [torch.argmax(lg, dim=-1) for lg in lrun["logits"]]
    long["vs_dlse"] = dlse_compare(cfg, params, lrun["cache"], lgen, lrun["logits"], s["seq"] - s["steps"])
    long["launches_expected"] = f"{cfg.num_layers} layers x {s['steps']} calls"
    out["decode_32k"] = long
    del lrun, params
    torch.cuda.empty_cache()
    out["float32"] = qwen72b_f32_check(device)
    return out


def qwen72b_f32_check(device) -> dict:
    """qwen2-72b at full width, ``QWEN72B_F32["layers"]`` layers, float32,
    TF32 off: a prefill and greedy decode steps on the kernel path, then
    the decode steps teacher-forced on the plain path and on the dlse path
    (:func:`dlse_compare`); the K5 path's logits (prefill and decode) and
    the dlse path's decode logits each within :data:`F32_LOGIT_REL_TOL` of
    the plain path's largest |logit|."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = QWEN72B_F32
    cfg = dataclasses.replace(get_arch("qwen2-72b").full(), num_layers=c["layers"], dtype=torch.float32)
    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(SEED + 12), device=device)
    phase, run = lm_prefill_decode_phase(cfg, params, batch=c["batch"], prompt=c["prompt"], steps=c["steps"],
                                         tag="qwen72b_f32", device=device, compare=False, profile=False)
    # on the cache the kernel path wrote: the plain decode, the dlse decode
    # against it, then the plain path from the prefill on
    plain = plain_decode(cfg, params, run["cache"], run["gen"], c["prompt"], c["steps"])
    dlse = dlse_compare(cfg, params, run["cache"], run["gen"], plain, c["prompt"])
    vs_plain = lm_compare(cfg, params, run["tokens"], run["cache"], run["gen"], run["logits"], run["last"],
                          c["prompt"])
    out = {"layers": c["layers"], "dtype": "float32", "allow_tf32": False, "batch": c["batch"],
           "prompt_len": c["prompt"], "decode_steps": c["steps"], "launches": phase["launches"],
           "rel_tolerance": F32_LOGIT_REL_TOL, "k5_vs_plain": vs_plain, "dlse_vs_plain": dlse}
    for what, rel in (("k5", vs_plain["logits_rel_diff"]), ("dlse", dlse["logits_rel_diff"])):
        if not rel <= F32_LOGIT_REL_TOL:
            raise AssertionError(f"main_qwen72b float32: the {what} path's logits differ from the plain path's "
                                 f"by {rel} of the largest")
    del run, params
    torch.cuda.empty_cache()
    return out


def main_arctic(device, capture: FlashCapture) -> dict:
    """arctic-480b at its published widths with its depth cut to
    ``ARCTIC["layers"]``, bf16: ``make_prefill`` on 4 x 4096 through K5 (7
    query heads a KV head at D = 128; at 16,384 tokens the expert capacity
    is 320) and 8 decode steps, the dropped share of each, layer 0's routing
    on the card against the CPU, the plain path teacher-forced with forced
    routes at top-1 >= :data:`BF16_TOP1_FLOOR` (as ``main_moe``), the dlse
    path under an emulated (1, 4) mesh with forced routes likewise; then 8
    decode steps at batch :data:`ARCTIC_DECODE_BATCH` on a cache from the
    generator, where the reference's capacity floor leaves one slot an
    expert, and their dropped share."""
    import torch

    from repro_torch.configs import get_arch

    arch = get_arch("arctic-480b")
    c = ARCTIC
    cfg = dataclasses.replace(arch.full(), num_layers=c["layers"])
    params, init = init_lm(cfg, device)
    lm_prefill(cfg, params, torch.zeros((1, 64), dtype=torch.long, device=device))  # warm-up
    out = {"arch": arch.name, "dtype": dtype_name(cfg.dtype), "layers": cfg.num_layers,
           "num_params": cfg.num_params(), "num_params_full": arch.full().num_params(),
           "num_active_params": cfg.num_active_params(), **init,
           "reduced": {"num_layers": f"35 -> {c['layers']}", "prefill_32k.global_batch": f"32 -> {c['batch']}",
                       "prefill_32k.seq_len": f"32768 -> {c['prompt']}",
                       "decode_32k": f"batch 128 -> {ARCTIC_DECODE_BATCH} at {c['prompt'] + c['steps']} positions"}}
    tap = MoeTap()
    with tap.installed():
        phase, run = lm_prefill_decode_phase(cfg, params, batch=c["batch"], prompt=c["prompt"], steps=c["steps"],
                                             tag="arctic", device=device, capture=capture, tally=tap,
                                             compare=False)
    out.update(phase)
    out["dispatch_dropped"] = tap.dropped()
    t = c["batch"] * c["prompt"]
    out["routing_card_vs_cpu"] = {"prefill_layer0": routing_check(cfg, tap.logits[t]),
                                  "decode_layer0": routing_check(cfg, tap.logits[c["batch"]])}
    # the dlse path first, on the cache the kernel path wrote
    out["vs_dlse"] = dlse_compare(cfg, params, run["cache"], run["gen"], run["logits"], c["prompt"], routes=True)
    out["vs_plain"] = lm_compare(cfg, params, run["tokens"], run["cache"], run["gen"], run["logits"], run["last"],
                                 c["prompt"], routes=True)
    del run
    for what, agree in (("plain", out["vs_plain"]["routes_forced"]["teacher_forced_top1_agreement"]),
                        ("dlse", out["vs_dlse"]["teacher_forced_top1_agreement"])):
        if not agree >= BF16_TOP1_FLOOR:
            raise AssertionError(f"main_arctic: with the routes forced, the {what} path agrees with the kernel "
                                 f"path's tokens {agree} of the time")
    torch.cuda.empty_cache()
    tap8 = MoeTap()
    with tap8.installed():
        b8, brun = long_decode(cfg, params, seq=c["prompt"] + c["steps"], batch=ARCTIC_DECODE_BATCH,
                               steps=c["steps"], seed=SEED + 13, device=device, tally=tap8)
    b8["dispatch_dropped"] = tap8.dropped()
    b8["capacity"] = max(1, int(cfg.capacity_factor * ARCTIC_DECODE_BATCH * cfg.top_k / cfg.num_experts))
    b8["launches_expected"] = f"{cfg.num_layers} layers x {c['steps']} calls"
    out["decode_batch8"] = b8
    out["decode_weight_read_bound_ms"] = init["weights_bytes"] / HBM_BYTES_PER_S * 1e3
    del brun, params
    torch.cuda.empty_cache()
    return out


def mla_dlse(device) -> dict:
    """minicpm3-4b at full width, ``MLA_DLSE["layers"]`` layers, float32,
    TF32 off, a short cache: a prefill and greedy decode steps on the
    port's own MLA decode, then the steps teacher-forced under an emulated
    (1, 4) mesh (``dlse_mla_decode_attention``: each shard expands only its
    own block of latents), within :data:`F32_LOGIT_REL_TOL` of the largest
    |logit|.  A check, not timed."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = MLA_DLSE
    cfg = dataclasses.replace(get_arch("minicpm3-4b").full(), num_layers=c["layers"], dtype=torch.float32)
    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(SEED + 14), device=device)
    phase, run = lm_prefill_decode_phase(cfg, params, batch=c["batch"], prompt=c["prompt"], steps=c["steps"],
                                         tag="mla_dlse", device=device, compare=False, profile=False)
    dlse = dlse_compare(cfg, params, run["cache"], run["gen"], run["logits"], c["prompt"])
    del dlse["dlse_decode_step_ms"], dlse["dlse_decode_step_ms_p50"], dlse["what_the_times_are"]
    if not dlse["logits_rel_diff"] <= F32_LOGIT_REL_TOL:
        raise AssertionError(f"mla_dlse: the dlse path's logits differ from the MLA decode's by "
                             f"{dlse['logits_rel_diff']} of the largest")
    del run, params
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "layers": c["layers"], "dtype": "float32", "allow_tf32": False,
            "batch": c["batch"], "prompt_len": c["prompt"], "decode_steps": c["steps"],
            "launches": phase["launches"], "rel_tolerance": F32_LOGIT_REL_TOL, "vs_mla_decode": dlse}


def mind_inputs(cfg, batch: int, candidates: int, rng, device, *, slab: bool = False):
    """``batch`` users' behaviour (a random number of valid items, 1 to
    ``seq_len``, at the head of each row) and ``candidates`` random items a
    user, or one slab of them with ``slab``; on ``device``."""
    import torch

    beh = rng.integers(0, cfg.num_items, (batch, cfg.seq_len))
    lens = rng.integers(1, cfg.seq_len + 1, batch)
    valid = np.arange(cfg.seq_len)[None] < lens[:, None]
    cands = rng.integers(0, cfg.num_items, (candidates,) if slab else (batch, candidates))
    return tuple(torch.from_numpy(a).to(device) for a in (beh, valid, cands))


def main_mind(device) -> dict:
    """MIND at its published widths (an 8,388,608 x 64 float32 item table,
    4 interests, 3 routing iterations, 50 behaviours), weights from a seeded
    generator: ``serve_p99`` (512 users x 1024 candidates) on the card
    against the CPU on the same weights and inputs (TF32 off; scores within
    rtol :data:`MIND_RTOL`); then ``serve_p99``, ``serve_bulk`` (262,144 x
    128) and ``retrieval_cand`` (1 x 1,000,000) through the config's step
    makers, each timed with CUDA events, and ``mind_serve`` at the CLI
    defaults on ``arch.full()``."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs import mind as C
    from repro_torch.launch import model_serve as MS
    from repro_torch.models.recsys import mind as m

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = get_arch("mind")
    cfg = arch.full()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = m.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device=device)
    torch.cuda.synchronize()
    out = {"arch": arch.name, "dtype": "float32", "allow_tf32": False, "init_s": time.perf_counter() - t0,
           "num_params": sum(x.numel() for x in params.values()),
           "table_bytes": params["item_table"].numel() * 4}
    rng = np.random.default_rng(SEED + 11)
    serve, retrieve = C.make_serve(cfg), C.make_retrieval(cfg)
    # the check: serve_p99 on the card against the CPU
    meta = C.SHAPES["serve_p99"].meta
    inputs = mind_inputs(cfg, meta["batch"], meta["candidates"], rng, device)
    got = serve(params, *inputs).cpu()
    host = {k: v.cpu() for k, v in params.items()}
    want = serve(host, *(x.cpu() for x in inputs))
    del host
    scale = float(want.abs().max())
    err = (got - want).abs()
    bad = int((err > MIND_RTOL * want.abs() + MIND_RTOL * scale).sum())
    if bad or tuple(got.shape) != (meta["batch"], meta["candidates"]):
        raise AssertionError(f"main_mind: {bad} serve_p99 scores differ from the CPU's beyond rtol {MIND_RTOL}")
    out["serve_p99_card_vs_cpu"] = {"max_abs_diff": float(err.max()), "max_abs_score": scale,
                                    "max_rel_diff": float((err / want.abs().clamp_min(1e-30)).max()),
                                    "rtol": MIND_RTOL, "atol": MIND_RTOL * scale, "outside": bad}
    # the cells: users/s and candidates/s at the shapes' own sizes
    d = cfg.embed_dim
    cells = {}
    for name in ("serve_p99", "serve_bulk", "retrieval_cand"):
        meta = C.SHAPES[name].meta
        b, c = meta["batch"], meta["candidates"]
        slab = C.SHAPES[name].kind == "retrieval"
        inputs = mind_inputs(cfg, b, c, rng, device, slab=slab)
        step = retrieve if slab else serve
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        scores = step(params, *inputs)
        if tuple(scores.shape) != (b, c) or not bool(torch.isfinite(scores).all()):
            raise AssertionError(f"main_mind {name}: scores of shape {tuple(scores.shape)} or not finite")
        del scores
        ms = time_ms(lambda: step(params, *inputs), reps=5 if b * c > 1 << 24 else 20)  # noqa: B023
        # gathered rows: behaviour and candidates, float32, read once
        gathered = (b * cfg.seq_len + (c if slab else b * c)) * d * 4
        cells[name] = {"batch": b, "candidates": c, "ms": ms, "users_per_s": b / (ms / 1e3),
                       "candidates_per_s": b * c / (ms / 1e3), "gathered_bytes": gathered,
                       "gather_bound_ms": gathered / HBM_BYTES_PER_S * 1e3,
                       "peak_device_memory": torch.cuda.max_memory_allocated()}
        del inputs
        torch.cuda.empty_cache()
    out["cells"] = cells
    del params
    torch.cuda.empty_cache()
    served = MS.mind_serve(arch, 4, cfg=cfg, device=device)
    if tuple(served["scores"].shape) != (4, 64) or not bool(torch.isfinite(served["scores"]).all()):
        raise AssertionError("mind_serve returned bad scores")
    out["mind_serve"] = {"batch": 4, "candidates": 64, "seconds": served["seconds"]}
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- LM and MIND training
# llama3.2-1b's train_4k cell (global batch 256 x 4096) cut to 16 sequences
# a step, in 8 microbatches of 2; 1 warm-up and 4 timed steps
LM_TRAIN = dict(batch=16, seq=4096, grad_accum=8, steps=4)
# k5_grad: (B, Hq, Hkv, S, D) at llama3.2-1b's heads and at qwen2-moe's (D = 128)
K5_GRAD_SHAPES = ((2, 32, 8, 4096, 64), (2, 16, 16, 4096, 128))
# the Function's gradients against autograd through the plain version, of
# each gradient's largest |value|: float32 (TF32 off) as the CPU tests'
# leaves, bf16 at K5's row limit (the bf16 output O enters dS)
K5_GRAD_TOL = {"float32": 1e-4, "bfloat16": 2.0**-6}
LM_CHECK = dict(layers=2, batch=2, seq=128)  # lm_train_card_vs_cpu: full widths, 2 layers
LM_CHECK_TOL = {"loss_rtol": 1e-6, "leaf_rel": 1e-4, "adamw_leaf_rel": 1e-6}
# the AdamW step card vs CPU takes every leaf, but of qwen2-moe's expert
# stacks [L, E, ...] only the first LM_CHECK_EXPERTS experts: its 1.83 B
# float32 parameters through the CPU's AdamW took ~40 s of the script's
# limit, its expert stacks 1.1 B of them (the cut tree keeps every kind of
# leaf; the clip is over the tree both devices are given)
LM_CHECK_EXPERTS = 8
EXPERT_STACKS = ("we_g", "we_i", "we_o")
MIND_TRAIN_STEPS = 4  # timed, after one warm-up
MIND_CHECK_BATCH = 1024
MIND_CHECK_TOL = {"loss_rtol": 1e-6, "leaf_rel": 1e-5}
TRAIN_RANGES = ("attention", "attention.backward", "mlp", "loss", "adamw")


def ranged(name: str, fn):
    """``fn`` under a ``torch.profiler.record_function`` range ``name``."""
    import torch

    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return wrapper


def k5_grad(device) -> dict:
    """K5's ``FlashAttention`` (the kernel forward, the plain backward) on
    the card against autograd through ``flash_attention_plain`` on the same
    causal operands, at :data:`K5_GRAD_SHAPES` in float32 (TF32 off) and
    bf16, each gradient within :data:`K5_GRAD_TOL` of its largest |value|;
    one K5 launch a call.  Then ``flash_attention_backward_plain`` timed
    beside ``scaled_dot_product_attention``'s backward on the same operands
    (a yardstick only) and the backward's bound: 4 products of 2·d
    operations per visible (row, key) pair (dV, dP, dQ, dK), q, k, v, O and
    dO read once, dq, dk, dv written once."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn as K5

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"tolerance": K5_GRAD_TOL, "cases": []}
    gen = torch.Generator(device=device).manual_seed(SEED + 50)
    for b, hq, hkv, s, d in K5_GRAD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = dtype_name(dtype)
            q = torch.randn((b, hq, s, d), generator=gen, device=device).to(dtype).requires_grad_(True)
            k = torch.randn((b, hkv, s, d), generator=gen, device=device).to(dtype).requires_grad_(True)
            v = torch.randn((b, hkv, s, d), generator=gen, device=device).to(dtype).requires_grad_(True)
            dout = torch.randn((b, hq, s, d), generator=gen, device=device).to(dtype)
            K5.reset_launches()
            o = K5.flash_attention(q, k, v, causal=True)
            got = torch.autograd.grad(o, (q, k, v), dout)
            launches = K5.LAUNCHES
            if launches != 1 or type(o.grad_fn).__name__ != "FlashAttentionBackward":
                raise AssertionError(f"k5_grad: {launches} launches, grad_fn {o.grad_fn}")
            want = torch.autograd.grad(K5.flash_attention_plain(q, k, v, causal=True), (q, k, v), dout)
            rel = {}
            for g, a, w in zip(("dq", "dk", "dv"), got, want):
                w = w.float()
                rel[g] = float((a.float() - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            del want, got
            row = {"b": b, "hq": hq, "hkv": hkv, "s": s, "d": d, "dtype": name, "launches": launches,
                   "grad_rel_diff": rel}
            if not max(rel.values()) <= K5_GRAD_TOL[name]:
                raise AssertionError(f"k5_grad: {row}")
            od = o.detach()
            plain_bw = lambda: K5.flash_attention_backward_plain(q, k, v, od, dout, causal=True)  # noqa: E731
            qs, ks, vs = (x.detach().requires_grad_(True) for x in (q, k, v))
            lib_o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
            lib_bw = lambda: torch.autograd.grad(lib_o, (qs, ks, vs), dout, retain_graph=True)  # noqa: E731
            m = s * (s + 1) // 2
            flops = 4 * 2 * b * hq * m * d
            nbytes = q.element_size() * d * (4 * b * hq * s + 4 * b * hkv * s)  # q, O, dO, dq; k, v, dk, dv
            t_ops = flops / (BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S)
            t_bytes = nbytes / HBM_BYTES_PER_S
            row.update(plain_backward_ms=time_ms(plain_bw, reps=2, warmup=1),
                       library_backward_ms=time_ms(lib_bw, reps=5, warmup=2),
                       library="torch.nn.functional.scaled_dot_product_attention backward",
                       bound_ms=max(t_ops, t_bytes) * 1e3, bound_by="operations" if t_ops >= t_bytes else "bytes",
                       flops=flops, bytes=nbytes)
            out["cases"].append(row)
            del q, k, v, dout, o, od, qs, ks, vs, lib_o
            torch.cuda.empty_cache()
    return out


def lm_train_step_profile(step) -> dict:
    """One train step under ``torch.profiler``: wall, device-busy, idle share,
    top kernels, K5's kernel time, and device ms by range — the layers'
    ``attention`` and ``mlp`` (forward and remat recompute), the plain
    backward of K5 (``attention.backward``), the loss's forward (``loss``),
    AdamW (``adamw``); ``unattributed`` holds the other gradients' kernels,
    which autograd launches outside the forward's ranges."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import lm_harness as LH
    from repro_torch.kernels import flash_attn as K5
    from repro_torch.models import common as cm

    torch.cuda.synchronize()
    with patched(K5, "flash_attention_backward_plain", ranged("attention.backward", K5.flash_attention_backward_plain)), \
            patched(cm, "cross_entropy_loss", ranged("loss", cm.cross_entropy_loss)), \
            patched(LH, "adamw_update", ranged("adamw", LH.adamw_update)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            loss = step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    traced = device_busy(prof, OUT_DIR / "chip_smoke_lm_train_step_trace.json", k5=True, ranges=TRAIN_RANGES)
    traced["wall_ms"] = wall * 1e3
    traced["device_idle_share"] = 1.0 - traced["device_busy_ms"] / traced["wall_ms"]
    traced["loss"] = loss
    return traced


def main_lm_train(device, params) -> dict:
    """llama3.2-1b's ``train_4k`` at ``full()`` widths in bf16 with remat,
    through ``launch/train.lm_setup`` (``make_train_step`` with
    :data:`LM_TRAIN`'s microbatches, AdamW at lr 3e-4) from ``params``:
    one warm-up step on ``lm_batch(0)``, then the timed steps on
    ``lm_batch(1..)``, K5's count zeroed just before them and read just
    after — 16 layers x 8 microbatches x 2 (the forward and the remat
    recompute) a step; step p50/p99, tokens/s, the model-FLOPs share of the
    bf16 peak (6 x params x tokens), peak memory; one profiled step; then 3
    steps on one fixed 2 x 4096 batch whose lowest later loss must be below
    the first.  Every loss and gradient norm finite."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs import lm_harness as LH
    from repro_torch.kernels import flash_attn as K5
    from repro_torch.launch import train as T

    arch = get_arch("llama3.2-1b")
    cfg = arch.full()
    b, s, acc, steps = LM_TRAIN["batch"], LM_TRAIN["seq"], LM_TRAIN["grad_accum"], LM_TRAIN["steps"]
    if not cfg.remat:
        raise AssertionError("main_lm_train: llama3.2-1b's full config has remat off")
    (p, opt), step_fn, data = T.lm_setup(arch, cfg, batch=b, seq=s, grad_accum=acc, params=params,
                                         device=device)
    del params
    losses, gnorms, step_s = [], [], []

    def run(i, fn=step_fn, batch=None):
        nonlocal p, opt
        t0 = time.perf_counter()
        p, opt, m = fn(p, opt, *(data(i) if batch is None else batch))
        loss, gn = float(m["loss"]), float(m["gnorm"])  # waits for the device
        return time.perf_counter() - t0, loss, gn

    torch.cuda.synchronize()
    warm_s, warm_loss, warm_gn = run(0)
    # the first torch.utils.checkpoint call of a process imports
    # torch._dynamo, and that import keeps its callers' frames (here up to
    # a warm-up step's state, ~30 GB) until the collector's next full pass
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K5.reset_launches()  # ---- the main path starts here
    for i in range(1, steps + 1):
        dt, loss, gn = run(i)
        step_s.append(dt)
        losses.append(loss)
        gnorms.append(gn)
    launches = K5.LAUNCHES  # ---- and ends here
    peak = torch.cuda.max_memory_allocated()
    expected = cfg.num_layers * acc * 2 * steps
    if launches != expected or launches == 0:
        raise AssertionError(f"main_lm_train: {launches} flash_attention launches, want {expected}")
    if not np.isfinite([warm_loss, warm_gn, *losses, *gnorms]).all():
        raise AssertionError(f"main_lm_train: losses {losses}, gradient norms {gnorms}")
    tokens = b * s
    p50 = float(np.percentile(step_s, 50))
    n = cfg.num_params()
    traced = lm_train_step_profile(lambda: run(steps + 1)[1])
    fixed = tuple(x[:2] for x in data(steps + 2))
    step1 = LH.make_train_step(cfg, 1)
    fixed_losses = [run(0, step1, fixed)[1] for _ in range(3)]
    if not (np.isfinite(fixed_losses).all() and min(fixed_losses[1:]) < fixed_losses[0]):
        raise AssertionError(f"main_lm_train: the fixed batch's losses {fixed_losses}")
    del p, opt
    torch.cuda.empty_cache()
    return {"arch": arch.name, "cell": "llama3.2-1b-train_4k", "dtype": dtype_name(cfg.dtype), "remat": cfg.remat,
            "num_params": n, "batch": b, "seq_len": s, "grad_accum": acc, "tokens_per_step": tokens,
            "reduced": {"train_4k.global_batch": "256 -> 16 (8 microbatches of 2)"},
            "warmup_step_s": warm_s, "step_s": step_s, "step_ms_p50": p50 * 1e3,
            "step_ms_p99": float(np.percentile(step_s, 99)) * 1e3, "tokens_per_s": tokens / p50,
            "model_flops_per_step": 6.0 * n * tokens,
            "bf16_peak_share": 6.0 * n * tokens / p50 / BF16_OPS_PER_S,
            "losses": [warm_loss, *losses], "gnorms": [warm_gn, *gnorms], "peak_device_memory": peak,
            "launches": launches, "launches_expected": f"{cfg.num_layers} layers x {acc} microbatches x 2 "
                                                       f"(forward, remat recompute) x {steps} steps",
            "traced_step": traced, "fixed_batch_losses": fixed_losses}


def adamw_check_tree(tree):
    """``tree`` (a transformer's parameters or gradients) with each expert
    stack cut to its first :data:`LM_CHECK_EXPERTS` experts; a dense or MLA
    tree as it is."""
    lay = tree["layers"]
    return {**tree, "layers": {k: v[:, :LM_CHECK_EXPERTS] if k in EXPERT_STACKS else v for k, v in lay.items()}}


def lm_train_card_vs_cpu(device) -> dict:
    """llama3.2-1b, qwen2-moe-a2.7b and minicpm3-4b at ``full()`` widths cut
    to 2 layers, float32, TF32 off, weights drawn on the card and copied to
    the CPU: ``loss_fn``'s value and gradient on 2 x 128 tokens of
    ``lm_batch`` (remat on) on both devices — the card's GQA through K5's
    Function, the CPU's through ``chunked_attention``; MoE and MLA as on
    the CPU — then one AdamW step (lr 3e-4) on the CPU's gradients on both
    (:func:`adamw_check_tree`: qwen2-moe's expert stacks cut to their first
    :data:`LM_CHECK_EXPERTS` experts).
    Limits :data:`LM_CHECK_TOL`: the loss, each gradient leaf of its largest
    |value|, each stepped leaf of its largest |value|."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.common import value_and_grad
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels import flash_attn as K5
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.optim.adamw import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"tolerance": LM_CHECK_TOL, **LM_CHECK, "adamw_experts": LM_CHECK_EXPERTS}
    for name in ("llama3.2-1b", "qwen2-moe-a2.7b", "minicpm3-4b"):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_arch(name).full(), num_layers=LM_CHECK["layers"], dtype=torch.float32)
        p_card = tf.init_params(cfg, torch.Generator(device=device).manual_seed(SEED + 60), device=device)
        p_cpu = tree_map(lambda x: x.cpu(), p_card)
        t, lab = (torch.from_numpy(x).long() for x in lm_batch(0, batch=LM_CHECK["batch"], seq_len=LM_CHECK["seq"],
                                                               vocab=cfg.vocab_size))
        K5.reset_launches()  # ---- the card's training path starts here
        l_card, g_card = value_and_grad(lambda p: tf.loss_fn(cfg, p, t.to(device), lab.to(device)), p_card)  # noqa: B023
        launches = K5.LAUNCHES  # ---- and ends here
        if launches != k5_calls(cfg, 2):
            raise AssertionError(f"lm_train_card_vs_cpu {name}: {launches} flash_attention launches")
        l_cpu, g_cpu = value_and_grad(lambda p: tf.loss_fn(cfg, p, t, lab), p_cpu)  # noqa: B023
        loss_rel = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
        g_cpu_on_card = tree_map(lambda x: x.to(device), g_cpu)
        grad_rel = _leaf_rel(g_card, g_cpu_on_card)
        del g_card
        row = {"num_params": cfg.num_params(), "loss_card": float(l_card), "loss_cpu": float(l_cpu),
               "loss_rel_diff": loss_rel, "grad_leaf_rel_diff": grad_rel, "launches": launches}
        pa_card, ga_card, pa_cpu, ga_cpu = map(adamw_check_tree, (p_card, g_cpu_on_card, p_cpu, g_cpu))
        new_card, _, _ = adamw_update(pa_card, ga_card, adamw_init(pa_card), lr=3e-4)
        new_cpu, _, _ = adamw_update(pa_cpu, ga_cpu, adamw_init(pa_cpu), lr=3e-4)
        row["adamw_on_cpu_grads_leaf_rel_diff"] = _leaf_rel(new_card, new_cpu)
        row["adamw_params"] = sum(x.numel() for x in tree_leaves(pa_cpu))
        del new_card, new_cpu, pa_card, ga_card, pa_cpu, ga_cpu
        row["seconds"] = time.perf_counter() - t0
        out[name] = row
        del p_card, p_cpu, g_cpu, g_cpu_on_card
        gc.collect()  # the process's first checkpoint call keeps its callers' frames (main_lm_train)
        torch.cuda.empty_cache()
        if not (loss_rel <= LM_CHECK_TOL["loss_rtol"] and grad_rel <= LM_CHECK_TOL["leaf_rel"]
                and row["adamw_on_cpu_grads_leaf_rel_diff"] <= LM_CHECK_TOL["adamw_leaf_rel"]):
            raise AssertionError(f"lm_train_card_vs_cpu {name}: {row}")
    return out


def main_mind_train(device) -> dict:
    """MIND's ``train_batch`` at ``full()`` size (an 8,388,608 x 64 float32
    table, B = 65,536 users of 50 behaviours, 20 sampled negatives each),
    uncut, through ``launch/train.mind_setup`` (AdamW at lr 1e-3) under
    ``torch.use_deterministic_algorithms``: one warm-up and
    :data:`MIND_TRAIN_STEPS` timed steps on ``mind_batch(step)``; step ms,
    users/s, peak memory, every loss finite.  Then the card against the CPU
    at B = :data:`MIND_CHECK_BATCH` on the same weights (TF32 off): the
    loss and every gradient leaf (the dense table gradient too) within
    :data:`MIND_CHECK_TOL`."""
    import os

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs import mind as MC
    from repro_torch.configs.common import value_and_grad
    from repro_torch.data.synthetic import mind_batch
    from repro_torch.launch import train as T
    from repro_torch.models.recsys import mind as m
    from repro_torch.optim.adamw import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arch = get_arch("mind")
    cfg = arch.full()
    batch = MC.SHAPES["train_batch"].meta["batch"]
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # what deterministic cuBLAS asks for
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (p, opt), step_fn, data = T.mind_setup(arch, cfg, batch=batch, device=device)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        params0 = tree_map(lambda x: x.clone(), p)
        losses, step_s = [], []
        for i in range(MIND_TRAIN_STEPS + 1):
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            args = data(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, opt, met = step_fn(p, opt, *args)
            losses.append(float(met["loss"]))  # waits for the device
            step_s.append(time.perf_counter() - t0)
            if not np.isfinite([losses[-1], float(met["gnorm"])]).all():
                raise AssertionError(f"main_mind_train: step {i} loss {losses[-1]}, gnorm {float(met['gnorm'])}")
        peak = torch.cuda.max_memory_allocated()
        del p, opt
        torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(was)
    timed = step_s[1:]
    p50 = float(np.percentile(timed, 50))
    out = {"arch": arch.name, "cell": "mind-train_batch", "dtype": "float32", "allow_tf32": False,
           "deterministic_algorithms": True, "batch": batch, "seq_len": cfg.seq_len, "negatives": 20,
           "num_params": sum(x.numel() for x in params0.values()),
           "table_bytes": params0["item_table"].numel() * 4, "init_s": init_s,
           "warmup_step_s": step_s[0], "step_s": timed, "step_ms_p50": p50 * 1e3,
           "step_ms_p99": float(np.percentile(timed, 99)) * 1e3, "users_per_s": batch / p50,
           "losses": losses, "peak_device_memory": peak}
    # the check: the card against the CPU on the first weights, B = 1,024
    args = tuple(torch.from_numpy(x) for x in mind_batch(0, batch=MIND_CHECK_BATCH, seq_len=cfg.seq_len,
                                                           num_items=cfg.num_items))
    args = tuple(x.long() if x.dtype == torch.int32 else x for x in args)
    l_card, g_card = value_and_grad(lambda q: m.loss_fn(cfg, q, *(x.to(device) for x in args)), params0)
    host = tree_map(lambda x: x.cpu(), params0)
    del params0
    l_cpu, g_cpu = value_and_grad(lambda q: m.loss_fn(cfg, q, *args), host)
    loss_rel = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
    grad_rel = _leaf_rel(g_card, g_cpu)
    out["card_vs_cpu"] = {"batch": MIND_CHECK_BATCH, "loss_card": float(l_card), "loss_cpu": float(l_cpu),
                          "loss_rel_diff": loss_rel, "grad_leaf_rel_diff": grad_rel, "tolerance": MIND_CHECK_TOL}
    del g_card, g_cpu, host
    torch.cuda.empty_cache()
    if not (loss_rel <= MIND_CHECK_TOL["loss_rtol"] and grad_rel <= MIND_CHECK_TOL["leaf_rel"]):
        raise AssertionError(f"main_mind_train: card vs CPU {out['card_vs_cpu']}")
    return out


# --------------------------------------------------------------------------- main
# --------------------------------------------------------------------------- GNN training
GNN_STEPS = 8  # timed train steps a cell, after one warm-up step
# (arch, shape): the cells one 80 GB card holds at full() widths
GNN_CELLS = (("pna", "minibatch_lg"), ("gatedgcn", "minibatch_lg"), ("dimenet", "minibatch_lg"),
             ("pna", "full_graph_sm"), ("gatedgcn", "full_graph_sm"), ("dimenet", "full_graph_sm"),
             ("equiformer-v2", "full_graph_sm"), ("dimenet", "molecule"), ("equiformer-v2", "molecule"))
GNN_GEOMETRIC = ("dimenet", "equiformer-v2")
# archs whose loss on a fixed batch bounces at the reference's lr of 1e-3:
# EquiformerV2's first AdamW step lifts it 2-9x (gradient norms 1e4-1e7)
# and the later steps fall unevenly, so its last of 9 losses can end above
# the first (PERF.md §6); held to their lowest timed loss below the
# first, every other fixed batch to its last.  The reference does the same
# on the CPU: its jitted step at full() widths bounces from step to step,
# and weights nudged by a relative 1e-7 take another path
# (tests/equiformer_witness.py)
GNN_BOUNCY = ("equiformer-v2",)
GNN_CLASSES = 47  # labels of the synthesized node-classification graphs (the full configs' classes)
GNN_CHECK = dict(nodes=256, edges=1024, graphs=8)  # gnn_card_vs_cpu's small batches
# EquiformerV2's depth in gnn_card_vs_cpu: at full widths and random weights
# its gradients grow chaotic with depth (a relative 1e-7 nudge of the
# weights moves them by under 1e-5 of a leaf's largest value at one layer
# and by over 1e-4 at three, in the port and in the reference alike:
# tests/test_torch_gnn.py), so no two float32 roundings agree at 1e-4 past
# one layer; the full depth is reported beside its own sensitivity on the
# card
GNN_CHECK_EQUIFORMER_LAYERS = 1
GNN_TOL = {"loss_rtol": 1e-5, "leaf_rel": 1e-4}  # of each leaf's largest |value|


def gnn_cfg(name: str, shape: str):
    """``arch.full()`` as the shape's cell takes it (``_cfg_for_shape``)."""
    import importlib

    from repro_torch.configs import get_arch
    from repro_torch.configs.gnn_harness import GNN_SHAPES

    arch = get_arch(name)
    mod = importlib.import_module(f"repro_torch.configs.{name.replace('-', '_')}")
    return arch, mod._cfg_for_shape(arch.full(), shape, GNN_SHAPES[shape].meta)


def gnn_triplets(batch, cap: int):
    """DimeNet's host triplets of ``batch`` on its device, and the host ms."""
    from repro_torch.models.gnn import dimenet

    t0 = time.perf_counter()
    host = [x.cpu().numpy() for x in (batch.edge_src, batch.edge_dst, batch.edge_mask)]
    tri = dimenet.build_triplets(*host, cap)
    ms = (time.perf_counter() - t0) * 1e3
    return dimenet.triplets_to(tri, batch.edge_src.device), ms, int(tri[2].sum())


def gnn_profile(step) -> dict:
    """One train step under ``torch.profiler``: wall, device-busy (the sum of
    the kernels' times), idle share and the top kernels by device time,
    read from the profiler's raw events (``key_averages()`` took 10-12 s to
    build its tables for an EquiformerV2 step, the raw events 0.3 s)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict[str, float] = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            key = ev.name()[:80]
            by_name[key] = by_name.get(key, 0.0) + ev.duration_ns() / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    out = {"device_busy_ms": sum(by_name.values()), "top_device_ms": dict(top[:10]), "wall_ms": wall * 1e3}
    out["device_idle_share"] = 1.0 - out["device_busy_ms"] / out["wall_ms"]
    out["loss"] = loss
    return out


def gnn_cell(name: str, shape: str, batches, *, triplets=None, device) -> dict:
    """Train ``name``'s ``full()`` config one warm-up step and
    :data:`GNN_STEPS` timed steps (forward, backward, AdamW at lr 1e-3
    through the port's ``make_gnn_train_step``), ``batches(i)`` giving step
    i's batch; then one profiled step.  Every loss and gradient norm must
    be finite (a finite norm: every gradient leaf finite); :func:`main_gnn`
    holds the fixed batches' losses."""
    import torch

    from repro_torch.configs.gnn_harness import GNN_SHAPES, MOLECULE, model_flops_estimate
    from repro_torch.launch import train

    arch, cfg = gnn_cfg(name, shape)
    meta = dict(GNN_SHAPES[shape].meta)
    torch.cuda.synchronize()
    at_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_setup = time.perf_counter()
    (params, opt), step_fn, _ = train.gnn_setup(arch, cfg, batches(0), device, triplets=triplets)
    setup_s = time.perf_counter() - t_setup
    losses, gnorms, step_ms, batch_ms = [], [], [], []
    for i in range(1 + GNN_STEPS):
        t0 = time.perf_counter()
        batch = batches(i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        loss, gnorm = float(m["loss"]), float(m["gnorm"])  # wait for the device
        t2 = time.perf_counter()
        batch_ms.append((t1 - t0) * 1e3)
        step_ms.append((t2 - t1) * 1e3)
        losses.append(loss)
        gnorms.append(gnorm)
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"gnn {name}/{shape}: step {i} loss {loss}, gradient norm {gnorm}")
    peak = torch.cuda.max_memory_allocated()
    state = {"p": params, "o": opt}

    def one():
        state["p"], state["o"], mm = step_fn(state["p"], state["o"], batches(1 + GNN_STEPS))
        return float(mm["loss"])

    t_prof = time.perf_counter()
    prof = gnn_profile(one)
    prof["profile_s"] = time.perf_counter() - t_prof  # the profiled step and the profiler's tables
    timed = step_ms[1:]
    p50 = float(np.percentile(timed, 50))
    b0 = batches(0)
    real_nodes = int(b0.node_mask.sum())
    if triplets is not None:
        meta["triplets"] = int(triplets[2].sum())
    flops = model_flops_estimate(name, cfg, meta)
    out = {"cell": f"{name}-{shape}", "arch": name, "shape": shape,
           "config": dataclasses.asdict(cfg), "nodes_padded": b0.num_nodes, "edges_padded": b0.num_edges,
           "real_nodes_step0": real_nodes, "real_edges_step0": int(b0.edge_mask.sum()),
           "warmup_step_ms": step_ms[0], "step_ms": timed, "step_ms_p50": p50,
           "step_ms_p99": float(np.percentile(timed, 99)), "steps_per_s": 1e3 / p50,
           "batch_ms_p50": float(np.percentile(batch_ms[1:], 50)),
           "losses": losses, "gnorms": gnorms, "finite": True,
           "model_flops": flops, "f32_rate_share": flops / (p50 / 1e3) / F32_OPS_PER_S,
           "max_memory_allocated": peak, "memory_allocated_at_start": at_start, "profiled_step": prof,
           "setup_s": setup_s, "steps_s": (sum(step_ms) + sum(batch_ms)) / 1e3}
    if shape == "molecule":
        out["graphs_per_s"] = real_nodes // MOLECULE["nodes"] * 1e3 / p50
    else:
        out["nodes_per_s"] = real_nodes * 1e3 / p50
    if triplets is not None:
        out["triplets"] = meta["triplets"]
    del params, opt, state, step_fn
    torch.cuda.empty_cache()
    return out


def main_gnn(device) -> dict:
    """GNN training at ``full()`` widths on the cells one card holds
    (:data:`GNN_CELLS`), float32 with TF32 off.  ``minibatch_lg``: a seeded
    uniform base graph at Reddit's published size (232,965 vertices,
    114,615,892 edges; CSR built from a multinomial of out-degrees), 602
    float32 features and 47 labels a vertex on the card; PNA and GatedGCN
    take a fresh ``sample_subgraph`` each step (1,024 seeds, fanout 15-10;
    the same samples for both), DimeNet the first sample and its triplets
    every step.  ``full_graph_sm`` (Cora's sizes) and ``molecule`` (128
    graphs of 30 nodes and 64 edges) are seeded and fixed.  Host sampling
    and triplets are timed apart from the steps.  The five kernels' launch
    counts are zeroed before and read after: the GNN path reaches none of
    them, as in the reference."""
    import torch

    from repro_torch.configs import gnn_harness as H
    from repro_torch.data import sampler as S
    from repro_torch.kernels import bloom as K3
    from repro_torch.kernels import diff_lookup as K4
    from repro_torch.kernels import ell_spmv as K1
    from repro_torch.kernels import flash_attn as K5
    from repro_torch.kernels import fused_sweep as K2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = (K1, K2, K3, K4, K5)
    for K in kernels:
        K.reset_launches()
    out: dict = {"tf32": False, "cells": {}}
    meta = H.GNN_SHAPES["minibatch_lg"].meta
    t0 = time.perf_counter()
    csr = H.uniform_base_graph(meta["base_nodes"], meta["base_edges"], np.random.default_rng(SEED + 20))
    out["base_graph_host_s"] = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    v = meta["base_nodes"]
    feats = torch.randn((v, meta["d_feat"]), generator=gen, device=device)
    labels = torch.randint(0, GNN_CLASSES, (v,), generator=gen, device=device)
    pos = torch.randn((v, 3), generator=gen, device=device)  # synthesized coordinates
    rng = np.random.default_rng(SEED + 22)
    subs, sample_ms = [], []
    for _ in range(2 + GNN_STEPS):  # warm-up, timed, profiled
        t0 = time.perf_counter()
        seeds = rng.choice(v, meta["batch_nodes"], replace=False)
        subs.append(S.sample_subgraph(csr, seeds, meta["fanout"], max_nodes=H._pad(meta["n_nodes"]),
                                      max_edges=H._pad(meta["n_edges"]), rng=rng))
        sample_ms.append((time.perf_counter() - t0) * 1e3)
    del csr
    out["minibatch_lg"] = {"base_nodes": v, "base_edges": meta["base_edges"], "base_feature_bytes": feats.nbytes,
                           "sample_host_ms": sample_ms,
                           "sampled_nodes": [int(s.node_mask.sum()) for s in subs],
                           "sampled_edges": [int(s.edge_mask.sum()) for s in subs]}
    egen = torch.Generator(device=device).manual_seed(SEED + 23)
    fixed: dict = {}
    for i, (name, shape) in enumerate(GNN_CELLS):
        geometric = name in GNN_GEOMETRIC
        triplets, tri_ms = None, None
        if shape == "minibatch_lg" and not geometric:
            batches = lambda j: H.sampled_batch(subs[j], feats, labels, None, generator=egen)  # noqa: E731
        else:
            if shape == "minibatch_lg":
                b = H.sampled_batch(subs[0], feats, labels, pos, generator=egen)
            elif shape == "molecule":
                b = H.molecule_batch(H.GNN_SHAPES[shape].meta, num_species=16,
                                     generator=torch.Generator(device=device).manual_seed(SEED + 30 + i),
                                     device=device)
            else:
                b = H.graph_batch(H.GNN_SHAPES[shape].meta, geometric=geometric,
                                  num_classes=getattr(gnn_cfg(name, shape)[1], "num_classes", GNN_CLASSES),
                                  generator=torch.Generator(device=device).manual_seed(SEED + 30 + i),
                                  device=device)
            if name == "dimenet":
                triplets, tri_ms, _ = gnn_triplets(b, H.triplet_cap(shape))
            batches = lambda j, b=b: b  # noqa: E731
        cell = gnn_cell(name, shape, batches, triplets=triplets, device=device)
        if tri_ms is not None:
            cell["triplets_host_ms"] = tri_ms
        if shape != "minibatch_lg" or geometric:
            losses = cell["losses"]
            cell["last_loss_below_first"] = losses[-1] < losses[0]
            cell["lowest_timed_loss_below_first"] = min(losses[1:]) < losses[0]
            fixed[cell["cell"]] = {"first": losses[0], "last": losses[-1], "lowest_timed": min(losses[1:])}
            held = "lowest_timed_loss_below_first" if name in GNN_BOUNCY else "last_loss_below_first"
            if not cell[held]:
                emit("main_gnn", **cell)
                raise AssertionError(f"gnn {cell['cell']}: on a fixed batch the loss went {losses}")
        out["cells"][cell["cell"]] = cell
        emit("main_gnn", **cell)
        del batches, triplets
        torch.cuda.empty_cache()
    del feats, labels, pos, subs
    torch.cuda.empty_cache()
    out["launches"] = {K.__name__.split(".")[-1]: K.LAUNCHES for K in kernels}
    if any(out["launches"].values()):
        raise AssertionError(f"the GNN path launched a kernel of the graph or LM paths: {out['launches']}")
    out["fixed_batch_losses"] = fixed
    return out


def _loss_and_grads(loss_fn, params):
    import torch

    from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten

    p = tree_map(lambda x: x.detach().requires_grad_(True), params)
    loss = loss_fn(p)
    leaves = tree_leaves(p)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)  # GatedGCN's last edge norm feeds nothing
    return float(loss.detach()), tree_unflatten(params, [torch.zeros_like(x) if gr is None else gr
                                                         for x, gr in zip(leaves, grads)])


def _leaf_rel(got, want) -> float:
    """The largest over leaves of max |got - want| / max |want|, computed on
    ``got``'s device: each leaf of ``want`` is moved there (at full widths
    seconds faster than pulling ``got`` to the CPU; the same subtractions
    and maxima)."""
    from repro_torch.optim.adamw import tree_leaves

    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        b = b.detach().to(a.device).float()
        worst = max(worst, float((a.detach().float() - b).abs().max()) / max(float(b.abs().max()), 1e-30))
    return worst


def gnn_card_vs_cpu(device) -> dict:
    """Each arch at ``full()`` widths on a small seeded batch (256 nodes and
    1,024 edges; DimeNet and EquiformerV2 on 8 graphs of ``molecule``'s
    layout): the card's loss and every gradient leaf against the port's CPU
    run on the same parameters (drawn on the CPU, copied to the card), the
    loss within rtol 1e-5 and each leaf within 1e-4 of its largest |value|;
    then one AdamW step on the CPU's gradients on both devices, held to the
    same limit.  The step on each device's own gradients is reported: a
    gradient component whose sign the two devices' roundings disagree on
    moves by 2 lr there, whatever its size."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs import gnn_harness as H
    from repro_torch.models.gnn import common as g
    from repro_torch.models.gnn import dimenet
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.optim.adamw import tree_leaves, tree_map

    out = {"tolerance": GNN_TOL}
    for name in ("pna", "gatedgcn", "dimenet", "equiformer-v2"):
        arch = get_arch(name)
        cfg = arch.full()
        if name == "equiformer-v2":
            cfg = dataclasses.replace(cfg, num_layers=GNN_CHECK_EQUIFORMER_LAYERS)
        m = __import__(f"repro_torch.models.gnn.{name.replace('-', '_')}", fromlist=["loss_fn"])
        gen = torch.Generator().manual_seed(SEED + 40)
        if name in GNN_GEOMETRIC:
            k = GNN_CHECK["graphs"]
            cpu_b = H.molecule_batch(dict(n_nodes=30 * k, n_edges=64 * k, d_feat=16), num_species=16,
                                     generator=gen, device="cpu")
        else:
            cpu_b = g.random_graph_batch(np.random.default_rng(SEED + 40), GNN_CHECK["nodes"], GNN_CHECK["edges"],
                                         cfg.d_in, edge_feat_dim=8, num_classes=cfg.num_classes, device="cpu")
        card_b = cpu_b.to(device)
        extra_cpu = extra_card = ()
        if name == "dimenet":
            host = [x.numpy() for x in (cpu_b.edge_src, cpu_b.edge_dst, cpu_b.edge_mask)]
            tri = dimenet.build_triplets(*host, H.triplet_cap("molecule"))
            extra_cpu, extra_card = (dimenet.triplets_to(tri, "cpu"),), (dimenet.triplets_to(tri, device),)
        p_cpu = m.init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
        p_card = tree_map(lambda x: x.to(device), p_cpu)
        l_cpu, g_cpu = _loss_and_grads(lambda p: m.loss_fn(cfg, p, cpu_b, *extra_cpu), p_cpu)
        l_card, g_card = _loss_and_grads(lambda p: m.loss_fn(cfg, p, card_b, *extra_card), p_card)
        grad_rel = _leaf_rel(g_card, g_cpu)
        loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
        o_cpu = adamw_init(p_cpu)
        new_cpu, _, _ = adamw_update(p_cpu, g_cpu, o_cpu, lr=1e-3)
        new_card, _, _ = adamw_update(p_card, tree_map(lambda x: x.to(device), g_cpu),
                                      tree_map(lambda x: x.to(device), o_cpu), lr=1e-3)
        own_card, _, _ = adamw_update(p_card, g_card, tree_map(lambda x: x.to(device), o_cpu), lr=1e-3)
        flips = sum(int(((a.cpu() > 0) != (b > 0)).sum()) for a, b in zip(tree_leaves(g_card), tree_leaves(g_cpu)))
        row = {"loss_card": l_card, "loss_cpu": l_cpu, "loss_rel_diff": loss_rel, "grad_leaf_rel_diff": grad_rel,
               "adamw_on_cpu_grads_leaf_rel_diff": _leaf_rel(new_card, new_cpu),
               "adamw_on_own_grads_leaf_rel_diff": _leaf_rel(own_card, new_cpu),
               "grad_sign_differences": flips, "grad_elements": sum(x.numel() for x in tree_leaves(g_cpu)),
               "nodes": cpu_b.num_nodes, "edges": cpu_b.num_edges}
        row["num_layers"] = getattr(cfg, "num_layers", getattr(cfg, "num_blocks", None))
        out[name] = row
        if not (loss_rel <= GNN_TOL["loss_rtol"] and grad_rel <= GNN_TOL["leaf_rel"]
                and row["adamw_on_cpu_grads_leaf_rel_diff"] <= GNN_TOL["leaf_rel"]):
            raise AssertionError(f"gnn_card_vs_cpu {name}: {row}")
        del p_card, g_card, new_card, own_card
        torch.cuda.empty_cache()
    out["equiformer-v2_full_depth"] = equiformer_full_depth(cpu_b, card_b, device)
    return out


def equiformer_full_depth(cpu_b, card_b, device) -> dict:
    """EquiformerV2's ``full()`` (12 layers) on ``gnn_card_vs_cpu``'s batch,
    reported, not held: the card against the CPU, and the card against
    itself with the weights nudged by a relative 1e-7 (seeded), the
    function's own sensitivity that the card-vs-CPU gap sits inside."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.gnn import equiformer_v2 as m
    from repro_torch.optim.adamw import tree_map

    cfg = get_arch("equiformer-v2").full()
    p_cpu = m.init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    gen = torch.Generator().manual_seed(SEED + 41)
    nudged = tree_map(lambda x: x * (1 + 1e-7 * torch.randn(x.shape, generator=gen)), p_cpu)
    l_cpu, g_cpu = _loss_and_grads(lambda p: m.loss_fn(cfg, p, cpu_b), p_cpu)
    l_card, g_card = _loss_and_grads(lambda p: m.loss_fn(cfg, p, card_b), tree_map(lambda x: x.to(device), p_cpu))
    l_nud, g_nud = _loss_and_grads(lambda p: m.loss_fn(cfg, p, card_b), tree_map(lambda x: x.to(device), nudged))
    g_card_cpu = tree_map(lambda x: x.cpu(), g_card)
    return {"num_layers": cfg.num_layers, "loss_card": l_card, "loss_cpu": l_cpu,
            "loss_rel_diff": abs(l_card - l_cpu) / abs(l_cpu), "grad_leaf_rel_diff": _leaf_rel(g_card, g_cpu),
            "card_nudged_1e-7_loss_rel_diff": abs(l_nud - l_card) / abs(l_card),
            "card_nudged_1e-7_grad_leaf_rel_diff": _leaf_rel(g_nud, g_card_cpu)}


# the drill's pairs: (arch, steps, checkpoint every, fault before step)
TRAIN_DRILL = {"gatedgcn": (20, 10, 15), "llama3.2-1b": (20, 10, 15), "mind": (20, 10, 15)}


def train_drill_start() -> dict:
    """Start ``python -m repro_torch.launch.train`` as subprocesses on the
    card (the reference's CLI at the smoke config), side by side: for each
    arch of :data:`TRAIN_DRILL` (GatedGCN, llama3.2-1b, MIND) a run with a
    checkpoint every 10 steps and an injected fault before step 15, and the
    same with no fault (``main`` trains under
    ``torch.use_deterministic_algorithms``); and EquiformerV2 for 5 steps.
    They run beside the parity phases (no time of either is held to a
    limit); :func:`train_drill_finish` collects and checks them.
    Checkpoints go under ``build/chip_smoke/`` and are removed after."""
    import os
    import shutil

    root = OUT_DIR / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUBLAS_WORKSPACE_CONFIG": ":4096:8", **ONE_THREAD}
    base = [sys.executable, "-m", "repro_torch.launch.train", "--json"]
    runs = {"equiformer": base + ["--arch", "equiformer-v2", "--steps", "5", "--ckpt-dir", str(root / "equi")]}
    for arch, (steps, every, fault) in TRAIN_DRILL.items():
        cmd = base + ["--arch", arch, "--steps", str(steps), "--ckpt-every", str(every)]
        runs[f"{arch}_clean"] = cmd + ["--ckpt-dir", str(root / f"{arch}_clean")]
        runs[f"{arch}_drill"] = cmd + ["--inject-fault-at", str(fault), "--ckpt-dir", str(root / f"{arch}_drill")]
    procs = {k: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
             for k, cmd in runs.items()}
    return {"procs": procs, "root": root, "t0": time.perf_counter()}


def train_drill_stop(handle: dict) -> None:
    """Kill whatever of the drill still runs and remove its checkpoints."""
    import shutil

    for p in handle["procs"].values():
        if p.poll() is None:
            p.kill()
            p.wait()
    shutil.rmtree(handle["root"], ignore_errors=True)


def train_drill_finish(handle: dict) -> dict:
    """Each drill must restart once, its history hold the injected fault
    alone, and its losses and final parameters equal the run without the
    fault bit for bit; EquiformerV2's 5 losses finite."""
    res = {}
    try:
        for k, p in handle["procs"].items():
            stdout, stderr = p.communicate(timeout=300)
            if p.returncode != 0:
                raise AssertionError(f"train_drill {k}: exit {p.returncode}\n{stderr[-3000:]}")
            lines = stdout.strip().splitlines()
            res[k] = {**json.loads(lines[-1]), "printed": lines[:-1]}
    finally:
        train_drill_stop(handle)
    pairs = {}
    for arch, (steps, _, fault) in TRAIN_DRILL.items():
        clean, drill = res[f"{arch}_clean"], res[f"{arch}_drill"]
        faults = [h for h in drill["history"] if h.startswith("fault")]
        if drill["restarts"] != 1 or faults != [f"fault@{fault}:InjectedFault"] or clean["restarts"] != 0:
            raise AssertionError(f"train_drill {arch}: restarts {drill['restarts']}, history {drill['history']}")
        if drill["losses"] != clean["losses"] or drill["params_sha256"] != clean["params_sha256"]:
            raise AssertionError(f"train_drill {arch}: the replay differs: {drill['losses']} vs {clean['losses']}")
        if not np.isfinite(clean["losses"]).all() or clean["steps"] != steps:
            raise AssertionError(f"train_drill {arch}: losses {clean['losses']}")
        pairs[arch] = {"restarts": drill["restarts"], "history": drill["history"],
                       "final_loss": drill["final_loss"], "losses": drill["losses"]}
    equi = res["equiformer"]
    if not np.isfinite(equi["losses"]).all() or equi["steps"] != 5:
        raise AssertionError(f"train_drill: equiformer {equi}")
    return {"seconds_since_start": time.perf_counter() - handle["t0"], "runs": res,
            "replay": "bit-equal under torch.use_deterministic_algorithms(True): losses and the sha256 of the "
                      "final parameters equal the run without the fault",
            "pairs": pairs}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; it has no CPU path")
    gc.callbacks.append(_time_gc)
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
    builds = ThreadPoolExecutor(max_workers=len(sources))
    built_at: dict[str, float] = {}
    try:
        futures = {s: builds.submit(_build.compile_source, s) for s in sources}
        for s, f in futures.items():
            f.add_done_callback(lambda _, s=s: built_at.setdefault(s, time.perf_counter()))
        # the card-vs-CPU training check runs while the other sources compile
        # (K5 first): its CPU half takes the cores nvcc leaves idle, one kept
        # for nvcc, and nothing before the graph phases is timed
        futures[K5.SOURCE].result()
        K5._lib()
        threads = torch.get_num_threads()
        torch.set_num_threads(max(1, threads - 1))
        t1 = time.perf_counter()
        try:
            lm_check = lm_train_card_vs_cpu("cuda")
        finally:
            torch.set_num_threads(threads)
        emit("lm_train_card_vs_cpu", **lm_check, seconds=time.perf_counter() - t1)
        for f in futures.values():
            f.result()
    finally:
        builds.shutdown(wait=True)
    for K in (K1, K2, K3, K4, K5):
        K._lib()
    # seconds: from the first nvcc's start to the last one's end (the LM
    # check's own seconds are on its line)
    emit("build", seconds=max(built_at.values()) - t0, sources=sources,
         build_s={s: _build.build_info[s]["seconds"] for s in sources},
         ptxas={s: [ln for ln in _build.build_info[s]["log"].splitlines()
                    if "registers" in ln or "spill" in ln] for s in sources})

    emit("flash_sass", **flash_sass())

    dev = "cuda"
    emit("kernel_small", **kernel_small(dev))
    emit("kernel_small_flash", **kernel_small_flash(dev))

    chunk, num_queries = 32, 8
    num_updates = MAIN_UPDATES
    # the base graph's host objects live to the last graph phase: made with
    # the collector off, then frozen, so no full collection scans them again
    # (the collector took 28.5-42.4 s of a run before, 23.1-23.4 s after;
    # PERF.md §6)
    gc.disable()
    graph0, stream, qsources, host_setup_s = make_data(PATENTS_V, PATENTS_E, STREAM_UPDATES, chunk, num_queries)
    gc.freeze()
    gc.enable()
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
    sharded_out = main_sharded(graph0, qsources, stream, real.pop("prob_run"), device=dev,
                               num_updates=num_updates, chunk=chunk)
    emit("main_sharded", cell="patents-uniform-fused-prob-shard4", num_vertices=graph0.num_vertices,
         queries=len(qsources), chunk=chunk, **sharded_out)
    vdc_runs, vdc_real = main_vdc(graph0, qsources, stream, main_out["peak_nbytes"], device=dev,
                                  num_updates=VDC_UPDATES, chunk=chunk)
    session_out = main_session(graph0, stream, qsources, runs["none"], runs["det"], device=dev,
                               chunk=chunk)
    emit("main_session", **session_out)
    serve_out = main_serve(graph0, stream, qsources, device=dev, chunk=chunk, num_updates=SERVE_UPDATES)
    emit("main_serve", **serve_out)
    landmark_out = main_landmark(graph0, stream, qsources, device=dev, chunk=chunk, num_updates=LANDMARK_UPDATES)
    emit("main_landmark", **landmark_out)
    del graph0
    torch.cuda.empty_cache()

    # the CLI drills run as subprocesses beside the parity phases, which time
    # nothing
    cqp_run = cqp_serve_drill_start()
    train_run = train_drill_start()
    try:
        emit("parity_fused", **parity_fused(dev))
        parity_sh = parity_sharded(dev)
        emit("parity_sharded", **parity_sh)
        emit("parity_vdc", **parity_vdc(dev))
        emit("parity_session", **parity_session(dev))
        emit("parity_planner", **parity_planner(dev))
        drill = cqp_serve_drill_finish(cqp_run)
    except BaseException:
        train_drill_stop(train_run)
        raise
    emit("cqp_serve_drill", **drill)
    emit("train_drill", **train_drill_finish(train_run))

    lm_capture, long_capture = FlashCapture(K5.flash_attention), FlashCapture(K5.flash_attention)
    lm_out, params = main_lm(dev, lm_capture)
    emit("main_lm", **lm_out)
    long_out = main_lm_long(dev, params, long_capture)
    emit("main_lm_long", **long_out)
    lm_train_out = main_lm_train(dev, params)
    del params
    torch.cuda.empty_cache()
    emit("main_lm_train", **lm_train_out)
    f32_capture = FlashCapture(K5.flash_attention)
    f32_out = main_lm_f32(dev, f32_capture)
    emit("main_lm_f32", **f32_out)
    moe_capture, moe_long_capture = FlashCapture(K5.flash_attention), FlashCapture(K5.flash_attention)
    moe_out = main_moe(dev, moe_capture)
    emit("main_moe", **moe_out)
    moe_long_out = main_moe_long(dev, moe_long_capture)
    emit("main_moe_long", **moe_long_out)
    mla_out = main_mla(dev)
    emit("main_mla", **mla_out)
    qwen72b_capture, arctic_capture = FlashCapture(K5.flash_attention), FlashCapture(K5.flash_attention)
    qwen72b_out = main_qwen72b(dev, qwen72b_capture)
    emit("main_qwen72b", **qwen72b_out)
    arctic_out = main_arctic(dev, arctic_capture)
    emit("main_arctic", **arctic_out)
    emit("mla_dlse", **mla_dlse(dev))
    emit("main_mind", **main_mind(dev))
    emit("main_mind_train", **main_mind_train(dev))
    k5_grad_out = k5_grad(dev)
    emit("k5_grad", **k5_grad_out)
    flash = {"prefill": flash_real(lm_capture.calls["prefill"]),
             "decode": flash_real(lm_capture.calls["decode"]),
             "prefill_32k": flash_real(long_capture.calls["prefill"]),
             "decode_32k": flash_real(long_capture.calls["decode"]),
             "prefill_f32": flash_real(f32_capture.calls["prefill"]),
             "decode_f32": flash_real(f32_capture.calls["decode"]),
             "moe_prefill": flash_real(moe_capture.calls["prefill"]),
             "moe_decode": flash_real(moe_capture.calls["decode"]),
             "moe_decode_32k": flash_real(moe_long_capture.calls["decode"]),
             "qwen72b_prefill": flash_real(qwen72b_capture.calls["prefill"]),
             "qwen72b_decode": flash_real(qwen72b_capture.calls["decode"]),
             "arctic_prefill": flash_real(arctic_capture.calls["prefill"]),
             "arctic_decode": flash_real(arctic_capture.calls["decode"])}
    del lm_capture, long_capture, f32_capture, moe_capture, moe_long_capture, qwen72b_capture, arctic_capture
    torch.cuda.empty_cache()
    flash.update(flash_rows(dev))
    real["bloom_query"] = bloom_real(*real.pop("bloom_filter"), dev)

    emit("kernel_real", q=q, v=v, d=d, ell_spmv=real1,
         fused_sweep={**{m: real[m] for m in ("none", "det", "prob")},
                      "vdc_new": vdc_real["fused_sweep_new"]},
         bloom_query=real["bloom_query"],
         diff_lookup={"vdc_jstore": vdc_real["diff_lookup"], "det_store": real["diff_lookup_det"]},
         flash_attention=flash)
    emit("other_semirings", **other_semirings(dev))
    gnn = main_gnn(dev)
    emit("main_gnn_summary", **{k: v for k, v in gnn.items() if k != "cells"})
    emit("gnn_card_vs_cpu", **gnn_card_vs_cpu(dev))

    mp = real1["min_plus"]
    k2 = real["none"]
    k2n = vdc_real["fused_sweep_new"]
    k3 = real["bloom_query"]
    k4 = vdc_real["diff_lookup"]
    # launches over every main-path run: the ell engine, the three fused
    # ones, the two VDC ones, the governed session, the two server runs, the
    # landmark session, the sharded run and its parity phase, and the
    # fifteen cqp_serve processes of the drill
    all_runs = {"ell": main_out, **{f"fused_{m}": r for m, r in runs.items()},
                **{f"vdc_{b}": r for b, r in vdc_runs.items()}, "session": session_out,
                "serve": serve_out["fault_run"], "serve_clean": serve_out["clean_run"],
                "landmark": landmark_out, "sharded": sharded_out, "parity_sharded": parity_sh,
                **{f"cqp_serve_{b}_{n}": {"launches": r["kernel_launches"]}
                   for b in ("fused", "ell", "fused_sharded") for n, r in drill[b].items()}}
    launches = {k: sum(r["launches"][k] for r in all_runs.values())
                for k in ("ell_spmv", "fused_sweep", "bloom", "diff_lookup")}
    # K5 over the LM runs, each counted from 0: prefill + decode, lm_serve,
    # the 32k cell, float32; qwen2-moe's prefill + decode, lm_serve and 32k
    # decode; minicpm3's (MLA: none); llama's timed train steps (forward and
    # remat recompute) and the 2-layer card-vs-CPU gradients; qwen2-72b's
    # prefill + decode, 32k decode and float32 run, arctic-480b's prefill +
    # decode and batch-8 decode (their dlse decodes launch none)
    lm_launches = {"lm_prefill_and_decode": lm_out["launches"], "lm_serve": lm_out["lm_serve"]["launches"],
                   "lm_long": long_out["launches"], "lm_f32": f32_out["launches"],
                   "moe_prefill_and_decode": moe_out["launches"], "moe_serve": moe_out["lm_serve"]["launches"],
                   "moe_long": moe_long_out["launches"], "mla_prefill_and_decode": mla_out["launches"],
                   "mla_long": mla_out["decode_32k"]["launches"], "mla_serve": mla_out["lm_serve"]["launches"],
                   "lm_train": lm_train_out["launches"],
                   "qwen72b_prefill_and_decode": qwen72b_out["launches"],
                   "qwen72b_decode_32k": qwen72b_out["decode_32k"]["launches"],
                   "qwen72b_f32": qwen72b_out["float32"]["launches"],
                   "arctic_prefill_and_decode": arctic_out["launches"],
                   "arctic_decode_batch8": arctic_out["decode_batch8"]["launches"],
                   **{f"train_card_vs_cpu_{n}": lm_check[n]["launches"]
                      for n in ("llama3.2-1b", "qwen2-moe-a2.7b", "minicpm3-4b")}}
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
            "out_of_place_ms": k2["out_of_place_ms"],
            "plain_ms": k2["plain_ms"],
            "bound_ms": k2["bound_ms"],
            "bound_by": "bytes",
            "out_of_place_floor_ms": k2["out_of_place_floor_ms"],
            "library_ms": None,
            "drop_mode": "none",
            "offset": "the coin and the Bloom key hash v + off (the shard's first vertex)",
            "launches_by_run": {k: r["launches"]["fused_sweep"] for k, r in all_runs.items()},
            "by_drop_mode": {m: real[m] for m in ("none", "det", "prob")},
            "new_variant": {k: k2n[k] for k in ("max_abs_err", "ms", "out_of_place_ms", "plain_ms",
                                                 "bound_ms", "bound_by", "out_of_place_floor_ms",
                                                 "library_ms")},
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
            "device_ms": k3["device_ms"],  # calls queued back to back: no host time between them
            "library_ms": None,  # no single call computes it; torch.take (index only) is a note
            "index_only_take_ms": k3["index_only_take_ms"],
            "key_set": "every vertex at i = 2",
            "by_key_set": k3["key_sets"],
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
            # training: the Function's backward is plain PyTorch (the reference's kernel has none)
            "backward": {f"{r['dtype']}_d{r['d']}": {k: r[k] for k in (
                "grad_rel_diff", "plain_backward_ms", "library_backward_ms", "bound_ms", "bound_by")}
                for r in k5_grad_out["cases"]},
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
