"""Port parity: GNN training (``configs.gnn_harness.make_gnn_train_step``),
``launch/train.py`` for every ported family, and train state across
packages.

Three steps of the port's GNN train step against the reference's jitted one
from the same carried parameters and batch: the loss of every step within
rtol 1e-5 (EquiformerV2 1e-4), and each leaf of the final parameters within
1e-4 of its largest |value| (the LM and MIND steps: ``test_torch_lm_train.py``,
``test_torch_mind_train.py``).  The CLI on the CPU, for the four GNNs,
``llama3.2-1b``, ``qwen2-moe-a2.7b``, ``minicpm3-4b``, ``mind``,
``qwen2-72b`` and ``arctic-480b``: the reference's printed lines (those a
straggler flag alone adds, which depend on the host's timing, are checked
for their form and not counted); a fault drill with one restart whose final
parameters equal the uninterrupted run's bit for bit; ``diff-ife``, not
ported yet, raising so; the CUDA device as the default.  A ``(params, AdamWState)`` checkpoint written by
the reference restores into the port leaf-equal, and back, for a GNN and a
transformer.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs import gnn_harness as H
from repro_torch.core.convert import adamw_state_from_reference, transformer_params_from_reference
from repro_torch.launch import train as T
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.optim.adamw import tree_leaves

ARCHS = ("pna", "gatedgcn", "dimenet", "equiformer-v2")
LM_MIND = ("llama3.2-1b", "qwen2-moe-a2.7b", "minicpm3-4b", "mind", "qwen2-72b", "arctic-480b")
MODULE = {"pna": "pna", "gatedgcn": "gatedgcn", "dimenet": "dimenet", "equiformer-v2": "equiformer_v2"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test: the smoke configs' operations are tiny,
    and the suite's parallel workers would otherwise run eight threads each
    on the same cores, which slowed these tests up to a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_get_arch_resolves_the_gnns_and_names_what_is_left():
    for name in ARCHS:
        arch = get_arch(name)
        assert (arch.name, arch.family) == (name, "gnn")
    assert get_arch("equiformer_v2").name == "equiformer-v2"
    for name in ("qwen2-72b", "arctic-480b", "arctic_480b"):
        arch = get_arch(name)
        assert (arch.name, arch.family) == (name.replace("_", "-"), "lm")
    with pytest.raises(KeyError, match=r"not ported yet \(ROADMAP Queue 1 item 9\(f3\)"):
        get_arch("diff-ife")


@pytest.mark.parametrize("name", ARCHS)
def test_three_train_steps_match_the_references_jitted_step(name):
    import importlib

    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as ref_get_arch
    from repro.configs.gnn_harness import make_gnn_train_step as ref_step
    from repro.models.gnn import common as rg
    from repro.optim import adamw_init as ref_init

    ref = importlib.import_module(f"repro.models.gnn.{MODULE[name]}")
    port = importlib.import_module(f"repro_torch.models.gnn.{MODULE[name]}")
    ref_cfg = ref_get_arch(name).smoke()
    cfg = type(get_arch(name).smoke())(**dataclasses.asdict(ref_cfg))
    geometric = name in ("dimenet", "equiformer-v2")
    kw = dict(edge_feat_dim=8, num_classes=getattr(cfg, "num_classes", 8), geometric=geometric)
    d_in = getattr(cfg, "d_in", 16)
    rbatch = rg.random_graph_batch(np.random.default_rng(0), 64, 256, d_in, **kw)
    from repro_torch.models.gnn import common as g

    pbatch = g.random_graph_batch(np.random.default_rng(0), 64, 256, d_in, device="cpu", **kw)
    rargs, pargs = (rbatch,), (pbatch,)
    if name == "dimenet":
        host = [np.asarray(x) for x in (rbatch.edge_src, rbatch.edge_dst, rbatch.edge_mask)]
        rargs += (tuple(jnp.asarray(t) for t in ref.build_triplets(*host, 1024)),)
        pargs += (port.triplets_to(port.build_triplets(*host, 1024), "cpu"),)
    rparams = jax.tree.map(np.asarray, ref.init_params(ref_cfg, jax.random.PRNGKey(0)))
    params = transformer_params_from_reference(rparams, "cpu")
    rstep = jax.jit(ref_step(lambda p, *a: ref.loss_fn(ref_cfg, p, *a)))
    pstep = H.make_gnn_train_step(lambda p, *a: port.loss_fn(cfg, p, *a))
    rp, ro, pp, po = rparams, ref_init(rparams), params, adamw_init(params)
    rtol = 1e-4 if name == "equiformer-v2" else 1e-5
    for _ in range(3):
        rp, ro, rm = rstep(rp, ro, *rargs)
        pp, po, pm = pstep(pp, po, *pargs)
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]), rtol=rtol)
        np.testing.assert_allclose(float(pm["gnorm"]), float(rm["gnorm"]), rtol=10 * rtol)
    assert int(po.step) == int(ro.step) == 3
    for a, b in zip(tree_leaves(pp), jax.tree.leaves(rp)):
        b = np.asarray(b)
        assert float(np.abs(a.numpy() - b).max()) <= 1e-4 * max(float(np.abs(b).max()), 1e-30)


def test_gnn_setup_takes_a_config_batch_and_triplets():
    arch = get_arch("dimenet")
    cfg = dataclasses.replace(arch.smoke(), num_blocks=1)
    gen = torch.Generator().manual_seed(0)
    batch = H.molecule_batch(H.GNN_SHAPES["molecule"].meta, num_species=16, generator=gen, device="cpu")
    from repro_torch.models.gnn import dimenet

    host = [x.numpy() for x in (batch.edge_src, batch.edge_dst, batch.edge_mask)]
    tri = dimenet.triplets_to(dimenet.build_triplets(*host, H.triplet_cap("molecule")), "cpu")
    (params, opt), step_fn, data = T.gnn_setup(arch, cfg, batch, "cpu", triplets=tri)
    assert len(params["blocks"]) == 1 and data(3) == (batch,)
    losses = []
    for step in range(3):
        params, opt, m = step_fn(params, opt, *data(step))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0] and int(opt.step) == 3


LINE = re.compile(r"^step \d+: loss=(nan|-?\d+\.\d{4})( \[straggler\])?$")
DONE = re.compile(r"^done: (\d+) steps in \d+\.\ds, restarts=(\d+), events=\[.*\]$")


def _lines(text):
    """The printed ``step N`` and ``done:`` lines, less those printed only
    for a straggler flag (N not a multiple of 5), each checked for its form."""
    out = []
    for ln in text.splitlines():
        if ln.startswith("step ") and ln.endswith(" [straggler]") and int(ln.split()[1][:-1]) % 5:
            assert LINE.match(ln), ln
        elif ln.startswith(("step ", "done: ")):
            out.append(ln)
    return out


@pytest.mark.parametrize("name", ARCHS + LM_MIND)
def test_cli_prints_the_references_lines(name, tmp_path, capsys, monkeypatch):
    import sys

    from repro.launch import train as ref_train

    monkeypatch.setattr(sys, "argv", ["train", "--arch", name, "--steps", "6", "--ckpt-dir", str(tmp_path / "r")])
    ref_train.main()
    want = _lines(capsys.readouterr().out)
    out = T.main(["--arch", name, "--steps", "6", "--device", "cpu", "--ckpt-dir", str(tmp_path / "p")])
    got = _lines(capsys.readouterr().out)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.split(":")[0] == b.split(":")[0]  # "step 0", "step 5", "done"
    assert all(LINE.match(ln) for ln in got[:2]) and DONE.match(got[2]).groups() == ("6", "0")
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) == 6  # the reference's PNA/GatedGCN: nan


# (steps, checkpoint every, fault before): the LM and MIND drills shorter, for
# the suite's time
DRILL = {"gatedgcn": (12, 5, 7), **{name: (6, 2, 3) for name in LM_MIND}}


@pytest.mark.parametrize("name", ("gatedgcn",) + LM_MIND)
def test_cli_fault_drill_restarts_once_and_replays_to_the_same_parameters(name, tmp_path, capsys):
    steps, every, fault = DRILL[name]
    base = ["--arch", name, "--steps", str(steps), "--ckpt-every", str(every), "--device", "cpu", "--json"]
    clean = T.main(base + ["--ckpt-dir", str(tmp_path / "clean")])
    drill = T.main(base + ["--ckpt-dir", str(tmp_path / "drill"), "--inject-fault-at", str(fault)])
    assert clean["restarts"] == 0 and drill["restarts"] == 1
    assert [h for h in drill["history"] if h.startswith("fault")] == [f"fault@{fault}:InjectedFault"]
    assert f"resume@{fault - fault % every}" in drill["history"]
    assert drill["params_sha256"] == clean["params_sha256"] and drill["losses"] == clean["losses"]
    for a, b in zip(tree_leaves(drill["state"]), tree_leaves(clean["state"])):
        assert torch.equal(a, b)
    assert '"restarts": 1' in capsys.readouterr().out.splitlines()[-1]


def test_cli_runs_without_a_ckpt_dir_see_only_their_own_checkpoints(tmp_path, monkeypatch):
    """With no ``--ckpt-dir`` each run checkpoints into a fresh directory
    under the temporary directory and removes it at the end: a faulted run
    after a longer one restores its own step 5, not the other's newest
    step, and ends where a run without the fault ends."""
    import os
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    base = ["--arch", "gatedgcn", "--ckpt-every", "5", "--device", "cpu"]
    longer = T.main(base + ["--steps", "30"])
    drill = T.main(base + ["--steps", "12", "--inject-fault-at", "7"])
    clean = T.main(base + ["--steps", "12"])
    dirs = {r["ckpt_dir"] for r in (longer, drill, clean)}
    assert len(dirs) == 3 and all(os.path.dirname(d) == str(tmp_path) for d in dirs)
    assert not any(os.path.exists(d) for d in dirs) and os.listdir(tmp_path) == []
    assert longer["steps"] == 30 and drill["restarts"] == 1 and "resume@5" in drill["history"]
    assert drill["params_sha256"] == clean["params_sha256"] and drill["losses"] == clean["losses"]


def test_cli_raises_for_what_is_not_ported_and_defaults_to_the_gpu(tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="use examples/continuous_queries.py for diff-ife"):
        T.main(["--arch", "diff-ife"])
    with pytest.raises(KeyError, match="9\\(f3\\)"):
        get_arch("diff-ife")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("pna", "llama3.2-1b", "mind", "qwen2-72b", "arctic-480b"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.main(["--arch", name, "--steps", "1", "--ckpt-dir", str(tmp_path / name)])


def test_train_state_checkpoint_restores_across_packages(tmp_path):
    """(params, AdamWState) of a smoke PNA after one reference step: written
    by the reference's CheckpointManager, restored by the port's; then
    written by the port's, restored by the reference's."""
    import jax

    from repro.checkpoint import CheckpointManager as RefManager
    from repro.configs.gnn_harness import make_gnn_train_step as ref_step
    from repro.models.gnn import common as rg
    from repro.models.gnn import pna as rpna
    from repro.optim import adamw_init as ref_init
    from repro_torch.checkpoint import CheckpointManager

    cfg = get_arch("pna").smoke()
    batch = rg.random_graph_batch(np.random.default_rng(0), 32, 96, cfg.d_in, edge_feat_dim=8,
                                  num_classes=cfg.num_classes)
    rparams = rpna.init_params(cfg, jax.random.PRNGKey(1))
    rstate = ref_step(lambda p, b: rpna.loss_fn(cfg, p, b))(rparams, ref_init(rparams), batch)[:2]
    rstate = jax.tree.map(np.asarray, rstate)
    RefManager(str(tmp_path / "a"), async_write=False).save(1, rstate)

    target = (transformer_params_from_reference(rstate[0], "cpu"), adamw_init(transformer_params_from_reference(rstate[0], "cpu")))
    got, step = CheckpointManager(str(tmp_path / "a")).restore_latest(target)
    assert step == 1 and isinstance(got[1], AdamWState) and int(got[1].step) == 1
    want = (transformer_params_from_reference(rstate[0], "cpu"), adamw_state_from_reference(rstate[1], "cpu"))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)

    CheckpointManager(str(tmp_path / "b"), async_write=False).save(1, got)
    back, _ = RefManager(str(tmp_path / "b")).restore_latest(rstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rstate)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_transformer_train_state_checkpoint_restores_across_packages(tmp_path):
    """(params, AdamWState) of the smoke llama3.2-1b after one reference
    train step: written by the reference's CheckpointManager, restored by
    the port's leaf-equal and trained on by the port's step; then written
    by the port's, restored by the reference's."""
    import jax
    import jax.numpy as jnp

    from repro.checkpoint import CheckpointManager as RefManager
    from repro.configs import get_arch as ref_get_arch
    from repro.configs.lm_harness import make_train_step as ref_step
    from repro.models import transformer as rtf
    from repro.optim import adamw_init as ref_init
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import lm_harness as LH
    from repro_torch.data.synthetic import lm_batch

    rcfg = ref_get_arch("llama3.2-1b").smoke()
    rparams = rtf.init_params(rcfg, jax.random.PRNGKey(1))
    t, lab = lm_batch(0, batch=2, seq_len=16, vocab=rcfg.vocab_size)
    rstate = jax.jit(ref_step(rcfg))(rparams, ref_init(rparams), jnp.asarray(t), jnp.asarray(lab))[:2]
    rstate = jax.tree.map(np.asarray, rstate)
    RefManager(str(tmp_path / "a"), async_write=False).save(1, rstate)

    blank = transformer_params_from_reference(rstate[0], "cpu")
    got, step = CheckpointManager(str(tmp_path / "a")).restore_latest((blank, adamw_init(blank)))
    assert step == 1 and isinstance(got[1], AdamWState) and int(got[1].step) == 1
    want = (transformer_params_from_reference(rstate[0], "cpu"), adamw_state_from_reference(rstate[1], "cpu"))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    params, opt, metrics = LH.make_train_step(get_arch("llama3.2-1b").smoke())(
        *got, *(torch.from_numpy(x).long() for x in lm_batch(1, batch=2, seq_len=16, vocab=rcfg.vocab_size)))
    assert np.isfinite(float(metrics["loss"])) and int(opt.step) == 2

    CheckpointManager(str(tmp_path / "b"), async_write=False).save(1, got)
    back, _ = RefManager(str(tmp_path / "b")).restore_latest(rstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rstate)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
