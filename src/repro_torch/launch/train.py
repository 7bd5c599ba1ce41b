"""Training entry point of the port: the LM, recsys and GNN archs under the
production runtime — checkpoint/restart under the fault supervisor and
straggler detection.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --steps 20                                        # on the GPU
    ... --device cpu                                      # plain PyTorch on the CPU
    ... --ckpt-every 10 --inject-fault-at 15              # a fault drill
    ... --ckpt-dir DIR --json                             # keep the checkpoints; a JSON summary

The port of ``repro/launch/train.py``'s ``main`` with its command line
(``--smoke`` is accepted: ``main`` trains the smoke config, as the
reference's does) and its printed lines, for the five LMs
(``llama3.2-1b``, ``qwen2-moe-a2.7b``, ``minicpm3-4b``, ``qwen2-72b``,
``arctic-480b``), ``mind`` and the four GNNs (``diff-ife`` points to
``examples/continuous_queries.py``, as the reference's does; training
qwen2-72b or arctic-480b at full width needs their products split over
cards, ROADMAP Queue 1).  It adds ``--device`` (default: the CUDA device) and ``--json``
(a last line with every step's loss and wall seconds, the history and a
digest of the final parameters).  Without ``--ckpt-dir`` a run checkpoints
into a fresh directory of its own under the temporary directory and
removes it at the end, so a restart restores only what this run wrote (the
reference's fixed ``/tmp/repro_ckpt`` would let a faulted run resume from
another run's newest step).  ``main`` runs under
``torch.use_deterministic_algorithms`` (restored on return), so a replayed
step equals its first run bit for bit on the card too, where ``index_add_``
otherwise sums in any order.  :func:`lm_setup` and :func:`mind_setup` also
take a config, a batch size and parameters, :func:`gnn_setup` a config, a
batch and triplets, so a caller can train ``arch.full()`` at a real size.

The reference's GNN setup draws the smoke batch's labels from 8 classes
for configs of 4 (PNA, GatedGCN), so its loss is NaN from the first step
(``take_along_axis`` fills out-of-range labels with NaN; the port's loss
does the same).  The port draws them from ``cfg.num_classes`` — the same
draws otherwise, labels being the batch's last — so the drill's losses are
finite (ROADMAP Queue 3).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_NAMES, NOT_PORTED, get_arch
from repro_torch.core.engine import resolve_device
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.fault import FaultPolicy, InjectedFault, StepResult, Supervisor
from repro_torch.runtime.straggler import StragglerDetector, StepTimer

GEOMETRIC = ("dimenet", "equiformer-v2")


def _model(arch):
    from repro_torch.models.gnn import dimenet, equiformer_v2, gatedgcn, pna

    return {"pna": pna, "gatedgcn": gatedgcn, "dimenet": dimenet, "equiformer-v2": equiformer_v2}[arch.name]


def gnn_setup(arch, cfg, batch=None, device=None, *, triplets=None):
    """(state, step_fn, data) for a GNN arch: parameters from
    ``init_params`` with a ``torch.Generator`` seeded 0, AdamW's
    state, :func:`~repro_torch.configs.gnn_harness.make_gnn_train_step` of
    the arch's loss, and ``data(step)`` giving the same batch every step,
    as the reference's ``_gnn_setup``.  ``batch`` defaults to the
    reference's: ``random_graph_batch`` over 64 nodes and 256 edges from
    numpy seed 0 (labels in ``[0, cfg.num_classes)``, module docstring);
    DimeNet's ``triplets`` default to ``build_triplets`` over the batch with
    a cap of 1024, as there."""
    from repro_torch.configs.gnn_harness import make_gnn_train_step
    from repro_torch.models.gnn import common as g

    dev = resolve_device(device)
    m = _model(arch)
    if batch is None:
        rng = np.random.default_rng(0)
        batch = g.random_graph_batch(rng, 64, 256, getattr(cfg, "d_in", 16), edge_feat_dim=8,
                                     num_classes=getattr(cfg, "num_classes", 8),
                                     geometric=arch.name in GEOMETRIC, device=dev)
    if arch.name == "dimenet":
        if triplets is None:
            triplets = m.triplets_to(m.build_triplets(batch.edge_src.cpu().numpy(), batch.edge_dst.cpu().numpy(),
                                                      batch.edge_mask.cpu().numpy(), 1024), dev)
        loss = lambda p, b: m.loss_fn(cfg, p, b, triplets)  # noqa: E731
    else:
        loss = lambda p, b: m.loss_fn(cfg, p, b)  # noqa: E731
    params = m.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = adamw_init(params)
    step_fn = make_gnn_train_step(loss)

    def data(step):
        return (batch,)

    return (params, opt), step_fn, data


def lm_setup(arch, cfg, *, batch: int = 4, seq: int = 32, grad_accum: int = 1, params=None,
             device=None):
    """(state, step_fn, data) for an LM arch, as the reference's
    ``_lm_setup``: parameters from ``init_params`` with a
    ``torch.Generator`` seeded 0 (or ``params``), AdamW's state,
    :func:`~repro_torch.configs.lm_harness.make_train_step` with
    ``grad_accum``, and ``data(step)`` giving ``lm_batch(step)``'s tokens
    and labels ``[batch, seq]`` on the device."""
    from repro_torch.configs.lm_harness import make_train_step
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import transformer as tf

    dev = resolve_device(device)
    if params is None:
        params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, grad_accum)

    def data(step):
        t, lab = lm_batch(step, batch=batch, seq_len=seq, vocab=cfg.vocab_size)
        return tuple(torch.from_numpy(x).to(dev, torch.long) for x in (t, lab))

    return (params, opt), step_fn, data


def mind_setup(arch, cfg, *, batch: int = 32, params=None, device=None):
    """(state, step_fn, data) for MIND, as the reference's ``_mind_setup``:
    parameters from ``init_params`` with a ``torch.Generator`` seeded 0 (or
    ``params``), AdamW's state, :func:`~repro_torch.configs.mind.make_train_step`,
    and ``data(step)`` giving ``mind_batch(step)``'s behaviour, validity,
    targets and 20 negatives a user on the device."""
    from repro_torch.configs.mind import make_train_step
    from repro_torch.data.synthetic import mind_batch
    from repro_torch.models.recsys import mind as m

    dev = resolve_device(device)
    if params is None:
        params = m.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = adamw_init(params)
    step_fn = make_train_step(cfg)

    def data(step):
        b, v, t, n = mind_batch(step, batch=batch, seq_len=cfg.seq_len, num_items=cfg.num_items)
        return (torch.from_numpy(b).to(dev, torch.long), torch.from_numpy(v).to(dev),
                torch.from_numpy(t).to(dev, torch.long), torch.from_numpy(n).to(dev, torch.long))

    return (params, opt), step_fn, data


SETUPS = {"lm": lm_setup, "recsys": mind_setup, "gnn": gnn_setup}


def params_digest(params) -> str:
    """sha256 over the parameter leaves' bytes in tree order."""
    h = hashlib.sha256()
    for x in tree_leaves(params):
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_NAMES + list(NOT_PORTED))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None, help="default: a fresh directory, removed at the end")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--inject-fault-at", type=int, default=-1)
    ap.add_argument("--device", default=None, help="default: the CUDA device")
    ap.add_argument("--json", action="store_true", help="print a JSON summary as the last line")
    args = ap.parse_args(argv)

    if args.arch == "diff-ife":
        raise SystemExit("use examples/continuous_queries.py for diff-ife")
    try:
        arch = get_arch(args.arch)
    except KeyError as e:
        raise SystemExit(str(e)) from None
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # read when cuBLAS starts
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
    torch.use_deterministic_algorithms(True)
    try:
        return _train(args, arch, ckpt_dir)
    finally:
        torch.use_deterministic_algorithms(was_deterministic)
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)


def _train(args, arch, ckpt_dir: str) -> dict:
    dev = resolve_device(args.device)
    cfg = arch.smoke()
    state, step_fn, data = SETUPS[arch.family](arch, cfg, device=dev)

    ckpt = CheckpointManager(ckpt_dir, keep=2)
    detector = StragglerDetector()
    injected = {"done": False}
    losses: dict[int, float] = {}
    step_s: dict[int, float] = {}

    def injector(step):
        if step == args.inject_fault_at and not injected["done"]:
            injected["done"] = True
            raise InjectedFault(f"simulated device failure at step {step}")

    sup = Supervisor(
        ckpt,
        FaultPolicy(checkpoint_every=args.ckpt_every),
        fault_injector=injector if args.inject_fault_at >= 0 else None,
    )

    def one_step(state, step):
        params, opt = state
        t_step = time.perf_counter()
        with StepTimer(detector) as t:
            params, opt, metrics = step_fn(params, opt, *data(step))
            loss = float(metrics["loss"])  # waits for the device
        step_s[step] = time.perf_counter() - t_step
        straggled = t.finish(step)
        losses[step] = loss
        if step % 5 == 0 or straggled:
            print(f"step {step}: loss={loss:.4f}" + (" [straggler]" if straggled else ""))
        return StepResult(state=(params, opt), metrics=metrics)

    t0 = time.time()
    try:
        state, last = sup.run(state, one_step, num_steps=args.steps)
    finally:
        ckpt.wait()  # the writer thread is done with the directory
    print(f"done: {last} steps in {time.time() - t0:.1f}s, "
          f"restarts={sup.restarts}, events={sup.history}")
    out = {"arch": arch.name, "device": str(dev), "steps": last, "restarts": sup.restarts,
           "history": sup.history, "losses": [losses[s] for s in sorted(losses)],
           "step_s": [step_s[s] for s in sorted(step_s)],
           "final_loss": losses.get(last - 1), "params_sha256": params_digest(state[0]),
           "ckpt_dir": ckpt_dir}
    if args.json:
        print(json.dumps(out), flush=True)
    return {**out, "state": state}


if __name__ == "__main__":
    main()
