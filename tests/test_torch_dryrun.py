"""The port's dry-run trio: ``Cell``/``build_cell``, ``launch/hlo_analysis``,
``launch/dryrun`` and ``launch/sweep_dryrun``.

- ``Cell.per_device_bytes`` of ``diff-ife``'s three shapes and of
  ``llama3.2-1b:train_4k`` on the 16 × 16 production mesh equals the
  reference's figure: its ``build_cell`` structs under its shardings
  (``NamedSharding.shard_shape``), worked in a subprocess on 512 host
  devices as its dry-run sets them up.  The reference's ``diff-ife`` cell
  builds its state shardings without ``EngineState.active`` and raises
  (ROADMAP Queue 3); the subprocess lets ``active`` default to no sharding,
  which ``jax.jit`` places replicated, as the port shards it.
- The counter's product flops for the smoke LM prefill equal an analytic
  count exactly; K5's tap counts its layers.
- ``dryrun.run_cell`` and ``sweep_dryrun`` write records of the
  reference's schema (``sweep_dryrun`` at a tiny V, the kernels' plain
  versions counting as the kernels).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch import dryrun, hlo_analysis, sweep_dryrun

REF_RECORD_KEYS = {"arch", "shape", "mesh", "num_devices", "lower_s", "compile_s", "memory_analysis",
                   "per_device_bytes", "roofline", "status"}
REF_ROOFLINE_KEYS = {"name", "num_chips", "hlo_flops", "hlo_bytes", "coll_bytes", "model_flops", "t_compute_s",
                     "t_memory_s", "t_collective_s", "bottleneck", "useful_flop_ratio", "roofline_fraction",
                     "per_device_hbm_bytes"}
CELLS = [("diff-ife", "maintain_q8k"), ("diff-ife", "maintain_burst"), ("diff-ife", "maintain_q8k_qpar"),
         ("llama3.2-1b", "train_4k")]

REFERENCE_BYTES = r'''
import json, math, os, sys
import jax, numpy as np
from repro.core import engine as eng
eng.EngineState.__new__.__defaults__ = (None, None)  # `active` left out by the reference's diff-ife cell
from repro.configs import get_arch
from repro.launch.mesh import make_production_mesh

def per_device(cell):
    total = 0
    def walk(a, s):
        nonlocal total
        if isinstance(s, jax.sharding.NamedSharding) or s is None:
            for x in jax.tree_util.tree_leaves(a):
                shard = x.shape if s is None else s.shard_shape(x.shape)
                total += math.prod(shard) * np.dtype(x.dtype).itemsize
        elif isinstance(a, dict):
            for k in a:
                walk(a[k], s[k])
        elif isinstance(a, (tuple, list)):
            for x, y in zip(a, s):
                walk(x, y)
    walk(cell.args, cell.in_shardings)
    return total

mesh = make_production_mesh()
out = {}
with mesh:
    for arch, shape in json.loads(sys.argv[1]):
        a = get_arch(arch)
        out[f"{arch}:{shape}"] = per_device(a.build_cell(a.full(), shape, mesh))
print(json.dumps(out))
'''


def test_per_device_bytes_equal_the_references():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=512", JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", REFERENCE_BYTES, json.dumps(CELLS)], env=env, capture_output=True,
                         text=True, timeout=300, check=True)
    want = json.loads(run.stdout.strip().splitlines()[-1])
    mesh = dryrun.meta_production_mesh(False)
    for arch, shape in CELLS:
        spec = get_arch(arch)
        got = spec.build_cell(spec.full(), shape, mesh).per_device_bytes()
        assert got == want[f"{arch}:{shape}"], (arch, shape)


def test_counted_prefill_products_equal_the_analytic_count():
    spec = get_arch("llama3.2-1b")
    cfg = spec.smoke()
    b, s = 2, 32
    from repro_torch.configs.lm_harness import make_prefill, param_structs

    params, tokens = param_structs(cfg), torch.empty((b, s), dtype=torch.int32, device="meta")
    with hlo_analysis.Counter() as c:
        logits, cache = make_prefill(cfg)(params, tokens)
    d, dh = cfg.d_model, cfg.head_dim
    per_layer = d * cfg.num_heads * dh + 2 * d * cfg.num_kv_heads * dh + cfg.num_heads * dh * d + 3 * d * cfg.d_ff
    assert c.product_flops == 2 * b * s * (cfg.num_layers * per_layer + d * cfg.vocab_size)
    assert c.kernels == {"flash_attention": cfg.num_layers}
    k5_flops, _ = __import__("repro_torch.kernels.flash_attn", fromlist=["cost"]).cost(
        b, cfg.num_heads, cfg.num_kv_heads, s, s, dh, True, 4)
    assert c.flops > c.product_flops + cfg.num_layers * k5_flops
    assert logits.shape == (b, cfg.vocab_size) and logits.device.type == "meta"


def test_dryrun_records_the_diff_ife_cell_in_the_references_schema(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "REPORT_DIR", str(tmp_path))
    (rec,) = dryrun.main(["--arch", "diff-ife", "--shape", "maintain_q8k"])
    assert REF_RECORD_KEYS <= set(rec) and REF_ROOFLINE_KEYS <= set(rec["roofline"])
    assert json.loads((tmp_path / "diff-ife__maintain_q8k__16x16.json").read_text()) == rec
    assert rec["status"] == "ok" and rec["per_device_bytes"] == 2903056392
    # one iteration of one device: the front [512, V] f32 and the changed mask gathered over `model`
    assert rec["roofline"]["coll_bytes"] == 512 * 1_048_576 * (4 + 1)
    assert rec["kernels"] == {} and rec["left_out"].startswith("engine._push_cells")


def test_sweep_dryrun_writes_well_formed_records(tmp_path, monkeypatch):
    monkeypatch.setattr(sweep_dryrun, "REPORT_DIR", str(tmp_path))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        recs = sweep_dryrun.main(["--v", "64", "--e", "256", "--queries", "4", "--max-iters", "8",
                                  "--device", "cpu"])
    finally:
        torch.set_num_threads(n)
    assert [(r["arch"], r["mesh"]) for r in recs] == [
        ("sweep-ell", "single"), ("sweep-ell", "1x8"), ("sweep-fused", "single"), ("sweep-fused", "1x8")]
    for r in recs:
        assert REF_RECORD_KEYS <= set(r) and REF_ROOFLINE_KEYS <= set(r["roofline"]) and r["status"] == "ok"
        kernel = "ell_spmv" if r["arch"] == "sweep-ell" else "fused_sweep"
        assert r["kernels"] == {kernel: r["num_devices"] * r["iters_run"]} and r["iters_run"] > 0
        assert r["launches"] == {"ell_spmv": 0, "fused_sweep": 0}  # no card: the plain versions ran
        assert (r["roofline"]["coll_bytes"] > 0) == (r["num_devices"] > 1)
        assert json.loads((tmp_path / f"{r['arch']}__{r['shape']}__{r['mesh']}.json").read_text()) == r


@pytest.mark.parametrize("kernel", ["ell_spmv", "fused_sweep"])
def test_kernel_taps_count_the_kernel_and_not_its_plain_version(kernel):
    from repro_torch.kernels import ell_spmv as K1

    q, v, d = 3, 10, 4
    states = torch.zeros((v + 1, q))
    nbr = torch.zeros((v, d), dtype=torch.int32)
    w, carry = torch.ones((v, d)), torch.zeros((q, v))
    from repro_torch.core import diffstore as ds
    from repro_torch.kernels import fused_sweep as K2

    store = ds.make((q, v), 4)
    sched = torch.ones((q, v), dtype=torch.bool)
    args = (1, sched, torch.ones(q, dtype=torch.bool), carry, carry, ~sched, store, store)
    with hlo_analysis.Counter() as c:
        if kernel == "ell_spmv":
            K1.ell_spmv(states, nbr, w, carry, transposed=True)
            want = K1.cost(q, v, d, "min_plus")
        else:
            K2.fused_sweep(*args, states=states, nbr=nbr, w=w, kcarry=carry, transposed=True)
            want = K2.cost(sched, carry, store, store, states,
                           dict(new=None, nbr=nbr, semiring="min_plus", kcarry=carry, drop_mode="none"))
    assert c.kernels == {kernel: 1} and (c.flops, c.bytes) == want and c.ops == {}
