"""Multi-pod dry-run: build and count every (arch × shape × mesh) cell.

The port of ``repro/launch/dryrun.py``, with its command line and record
schema.  The reference lowers and compiles each cell with ``jax.jit`` on
512 placeholder host devices.  The port has no compiler: it builds each
cell at ``full()`` on a ``meta``-device emulation of the production mesh
(``launch/mesh.PRODUCTION_SHAPE`` / ``PRODUCTION_AXES``: 16 × 16 over
``("data", "model")``, 2 × 16 × 16 with ``"pod"``), so no full-scale
tensor is ever allocated and no card is needed, and runs the cell's step on
its meta arguments under ``launch/hlo_analysis.Counter`` (under
``models.common.activation_mesh(mesh)``, as the reference lowers it).

Each record holds the arguments' bytes per device
(:meth:`~repro_torch.configs.common.Cell.per_device_bytes`, in
``per_device_bytes`` and ``memory_analysis``), the roofline terms of the
counted run, and ``status``.  ``lower_s`` is the seconds to build the cell
and ``compile_s`` those of the counted run.  The counts are one device's:
the whole step's divided by the mesh's size, except ``diff-ife``'s.

- ``diff-ife``: the sweep reads its frontier on the host every iteration,
  so a whole sweep cannot run on meta.  The counts are one iteration of one
  device (the cell's ``dry_fn``: ``engine._shard_body`` with every vertex
  scheduled, and the gathers around it), the per-iteration unit the
  reference's terms use for that cell; the frontier push is left out (it
  selects its edges with ``aten.nonzero``, whose output shape depends on
  the data), as each record's ``left_out`` says.
- The reference's ``_lm_extrapolated_costs`` exists only because XLA counts
  a scanned layer once; the counter runs every layer, so it is not ported.
- A decode step reads its valid length from the positions on the host; on
  meta it attends over the whole cache, the reference's cost.

A cell that fails records its error and the op it failed in.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import ARCH_NAMES, get_arch
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import PRODUCTION_AXES, PRODUCTION_SHAPE, make_mesh

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "reports", "dryrun_torch")


def meta_production_mesh(multi_pod: bool):
    """The production mesh's shape and axes, every coordinate on ``meta``."""
    return make_mesh(PRODUCTION_SHAPE[multi_pod], PRODUCTION_AXES[multi_pod], device="meta", emulate=True)


def count_cell(cell) -> hlo_analysis.Counter:
    """The cell's step (its ``dry_fn`` where it has one) run on its meta
    arguments under a counter, inside the cell's activation mesh."""
    from repro_torch.models.common import activation_mesh

    with activation_mesh(cell.mesh), hlo_analysis.Counter() as counter:
        (cell.dry_fn or cell.fn)(*cell.args)
    return counter


def run_cell(arch_name: str, shape_name: str, multi_pod: bool, *, verbose=True) -> dict:
    arch = get_arch(arch_name)
    mesh = meta_production_mesh(multi_pod)
    cfg = arch.full()
    t0 = time.time()
    cell = arch.build_cell(cfg, shape_name, mesh)
    per_device = cell.per_device_bytes()
    t_build = time.time() - t0
    counter = count_cell(cell)
    t_count = time.time() - t0 - t_build
    split = 1 if cell.dry_fn else mesh.size
    roof = hlo_analysis.analyse(cell.name, counter, mesh.size, cell.model_flops,
                                per_device_hbm_bytes=float(per_device), split=split)
    rec = {
        "arch": arch_name,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "num_devices": mesh.size,
        "lower_s": round(t_build, 1),
        "compile_s": round(t_count, 1),
        "memory_analysis": f"arguments {per_device} B per device (meta; no temporaries)",
        "per_device_bytes": per_device,
        "roofline": roof.to_dict(),
        "kernels": counter.kernels,
        "collectives": counter.collectives,
        "status": "ok",
    }
    if arch.family == "dc":
        from repro_torch.configs.diff_ife import UNIT_LEAVES_OUT

        rec["unit"] = "one sweep iteration of one device"
        rec["left_out"] = UNIT_LEAVES_OUT
    if verbose:
        print(f"[dryrun] {cell.name} mesh={rec['mesh']} OK (build {t_build:.0f}s count {t_count:.0f}s)")
        print(f"  per_device_bytes: {per_device}")
        print(f"  cost: flops={roof.hlo_flops:.3e} bytes={roof.hlo_bytes:.3e} "
              f"coll={roof.coll_bytes:.3e} bottleneck={roof.bottleneck}")
    return rec


def failed_op(tb) -> str:
    """The innermost frame of the port (or torch's op) a traceback ends in."""
    frames = traceback.extract_tb(tb)
    ours = [f for f in frames if "repro_torch" in f.filename]
    last = ours[-1] if ours else frames[-1]
    return f"{os.path.basename(last.filename)}:{last.lineno} {last.name}: {last.line}"


def save(rec: dict) -> None:
    os.makedirs(REPORT_DIR, exist_ok=True)
    key = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}".replace("/", "_")
    with open(os.path.join(REPORT_DIR, key + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_NAMES + [None])
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--continue-on-error", action="store_true")
    args = ap.parse_args(argv)

    jobs = []
    archs = ARCH_NAMES if (args.all or args.arch is None) else [args.arch]
    for a in archs:
        spec = get_arch(a)
        shapes = [args.shape] if args.shape else list(spec.shapes)
        for s in shapes:
            for mp in {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]:
                jobs.append((a, s, mp))

    failures, recs = 0, []
    for a, s, mp in jobs:
        try:
            rec = run_cell(a, s, mp)
        except Exception as e:  # noqa: BLE001
            failures += 1
            rec = {
                "arch": a, "shape": s,
                "mesh": "2x16x16" if mp else "16x16",
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "op": failed_op(e.__traceback__),
                "traceback": traceback.format_exc()[-2000:],
            }
            print(f"[dryrun] {a}:{s} mesh={rec['mesh']} FAILED: {rec['error']} at {rec['op']}")
            if not args.continue_on_error:
                save(rec)
                raise
        save(rec)
        recs.append(rec)
    print(f"[dryrun] done: {len(jobs) - failures}/{len(jobs)} ok")
    if failures:
        raise SystemExit(1)
    return recs


if __name__ == "__main__":
    main()
