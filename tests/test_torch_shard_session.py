"""Port parity: sharded sessions, restore across shard counts, ``cqp_serve --mesh``.

A ``CQPSession(engine="dense", mesh=...)`` on 2 and 4 shards emulated on the
CPU is held against the reference's unsharded session on the same seeded
stream: every slot-pool call — register, deregister, the pool's regrow, a
governor shed, ``set_drop_policy`` mid-stream — acts on every shard's rows,
so answers, accounted bytes (per query and per shard) and the governor's
ladder equal the unsharded run's.  Checkpoints are global: one taken at any
shard count, by either package, restores at any other and replays to the
uninterrupted run's answers.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import dropping as rdr
from repro.core import plan as rplan
from repro.core.graph import DynamicGraph as RGraph
from repro.core.session import CQPSession as RSession
from repro_torch.core import dropping as tdr
from repro_torch.core import plan as tplan
from repro_torch.core.graph import DynamicGraph as TGraph
from repro_torch.core.session import CQPSession as TSession
from repro_torch.launch.mesh import make_data_mesh
from test_torch_engine import random_workload

V = 24
MAX_ITERS = 24
CPU = "cpu"


def mesh(n):
    return None if n == 1 else make_data_mesh(n, device=CPU, emulate=True)


def _drop(mod, mode):
    return mod.DropConfig(mode=mode, selection="random", p=0.3, seed=7, bloom_bits=1 << 12)


def _churn(sess, qp, dr, mode, batches):
    """The churn scenario; yields a snapshot of the session after each step:
    answers per live query, accounted bytes (total and per query) and the
    governor's levels."""
    escalate = dr.DropConfig(mode=mode, selection="degree", p=0.8, tau_min=6.0, seed=7, bloom_bits=1 << 12)
    handles = sess.register_many([qp.sssp(0, max_iters=MAX_ITERS, drop=_drop(dr, mode)),
                                  qp.sssp(V // 2, max_iters=MAX_ITERS)])

    def snap():
        gov = sess.stats().get("governor")
        return ([np.asarray(sess.answers(h)) for h in handles], sess.nbytes(),
                list(sess.nbytes_per_query()), None if gov is None else gov["levels"])

    yield snap()
    for j, batch in enumerate(batches):
        sess.apply_updates_batched(batch)
        yield snap()
        if j == 0:  # two registers into a pool of 2: the pool regrows to 4
            handles += sess.register_many([qp.sssp(V // 3, max_iters=MAX_ITERS),
                                           qp.sssp(5, max_iters=MAX_ITERS)])
            yield snap()
        if j == 1:  # escalate query 0 mid-stream: its stored points shed
            assert sess.set_drop_policy(handles[0], escalate) >= 0
            yield snap()
        if j == 2:  # the oldest query retires
            assert sess.deregister(handles.pop(1)) >= 0
            yield snap()


def _session(pkg, initial, mode, shards=1, backend="coo", budget=None):
    kw = dict(engine="dense", drop=_drop(pkg["dr"], mode), min_slots=2, backend=backend, batch_capacity=4)
    if budget is not None:
        kw["budget_bytes"] = budget
    if pkg["name"] == "port":
        kw.update(mesh=mesh(shards), device=CPU)
    return pkg["S"](pkg["G"](V, initial, capacity=512), **kw)


REF = dict(name="ref", S=RSession, G=RGraph, qp=rplan, dr=rdr)
PORT = dict(name="port", S=TSession, G=TGraph, qp=tplan, dr=tdr)
_REF_RUNS: dict = {}


@pytest.mark.parametrize("shards,mode,backend", [(2, "det", "fused"), (4, "prob", "coo"), (4, "det", "ell"),
                                                 (2, "prob", "fused")])
def test_session_churn_on_a_mesh_equals_the_unsharded_reference(shards, mode, backend):
    initial, batches = random_workload(seed=17, num_batches=4)
    budget = 2600  # tight: the governor escalates and sheds
    key = mode
    if key not in _REF_RUNS:
        ref = _session(REF, initial, mode, budget=budget)
        _REF_RUNS[key] = list(_churn(ref, rplan, rdr, mode, batches))
    port = _session(PORT, initial, mode, shards, backend, budget=budget)
    got = list(_churn(port, tplan, tdr, mode, batches))
    assert len(got) == len(_REF_RUNS[key])
    for (ans, nb, per_q, levels), (rans, rnb, rper_q, rlevels) in zip(got, _REF_RUNS[key]):
        for a, b in zip(ans, rans):
            np.testing.assert_array_equal(a, b)
        assert (nb, per_q, levels) == (rnb, rper_q, rlevels)
    assert port.num_shards == shards and port.stats()["shards"] == shards
    assert sum(port.nbytes_per_device()) == port._impl.impl.nbytes()
    assert any(s[3] for s in got)  # the budget binds: the governor escalates
    assert port._impl.impl.slot_capacity == 4


# ------------------------------------------------------------------ restore across shard counts
def _replay(sess, batches):
    for batch in batches:
        sess.apply_updates_batched(batch)
    return [np.asarray(sess.answers(h)) for h in sess.handles()]


def _opened(pkg, initial, shards=1, backend="fused"):
    s = pkg["S"](pkg["G"](V, initial, capacity=512), engine="dense", backend=backend, min_slots=2,
                 drop=_drop(pkg["dr"], "det"), **({"mesh": mesh(shards), "device": CPU}
                                                  if pkg["name"] == "port" else {}))
    s.register_many([pkg["qp"].sssp(0, max_iters=MAX_ITERS, drop=_drop(pkg["dr"], "det")),
                     pkg["qp"].sssp(V // 2, max_iters=MAX_ITERS)])
    return s


@pytest.mark.parametrize("before,after", [(4, 1), (1, 4), (2, 4)])
def test_restore_across_shard_counts(tmp_path, before, after):
    """A checkpoint taken at ``before`` shards restores at ``after``; the
    replayed suffix gives the uninterrupted run's answers, which equal the
    reference's."""
    initial, batches = random_workload(seed=19, num_batches=4)
    ref = _opened(REF, initial, backend="coo")
    want = _replay(ref, batches)
    src = _opened(PORT, initial, before)
    _replay(src, batches[:2])
    src.checkpoint(str(tmp_path))
    back = TSession.restore(str(tmp_path), mesh=mesh(after), device=None if after > 1 else CPU)
    assert back.num_shards == after
    got = _replay(back, batches[2:])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert back.nbytes() == ref.nbytes()


def test_checkpoints_cross_packages_at_any_shard_count(tmp_path):
    """A reference checkpoint restored by the port on a 4-shard mesh replays
    to the reference's answers; the reference restores a port checkpoint
    written on 4 shards and replays to the same answers."""
    initial, batches = random_workload(seed=23, num_batches=4)
    ref = _opened(REF, initial, backend="coo")
    _replay(ref, batches[:2])
    ref.checkpoint(str(tmp_path / "ref"))
    want = _replay(ref, batches[2:])
    port = TSession.restore(str(tmp_path / "ref"), mesh=mesh(4))
    assert port.num_shards == 4
    for a, b in zip(_replay(port, batches[2:]), want):
        np.testing.assert_array_equal(a, b)
    src = _opened(PORT, initial, 4)
    _replay(src, batches[:2])
    src.checkpoint(str(tmp_path / "port"))
    back = RSession.restore(str(tmp_path / "port"))
    for a, b in zip(_replay(back, batches[2:]), want):
        np.testing.assert_array_equal(a, b)


def test_optimizer_under_a_sharded_session(tmp_path):
    """SPSP plans under ``optimize="always"`` on a 4-shard host session: the
    targets equal SCRATCH's, the landmark twin stays unsharded, and the
    session restores onto 2 shards with its planner."""
    initial, batches = random_workload(seed=29, num_batches=2)
    ups = [u for b in batches for u in b]
    queries = [(0, 17), (5, 20), (7, 3)]
    sess = TSession(TGraph(V, initial, capacity=512), engine="dense", mesh=mesh(4), optimize="always")
    hs = sess.register_many([tplan.spsp(s, t) for s, t in queries])
    sess.apply_updates(ups)
    scratch = TSession(TGraph(V, initial, capacity=512), engine="scratch", device=CPU)
    hr = scratch.register_many([tplan.sssp(s) for s, _ in queries])
    scratch.apply_updates(ups)
    for h, r, (_, t) in zip(hs, hr, queries):
        assert sess.answers(h)[t] == scratch.answers(r)[t]
    twins = [r.rev_session for r in sess._planner.rules if getattr(r, "rev_session", None)]
    assert twins and all(t.num_shards == 1 for t in twins)
    assert sess.stats()["planner"]["landmark"]["queries"] == len(queries)
    sess.checkpoint(str(tmp_path))
    back = TSession.restore(str(tmp_path), mesh=mesh(2))
    assert back.num_shards == 2
    for h, (_, t) in zip(back.handles(), queries):
        assert back.answers(h)[t] == sess.answers(hs[[x.qid for x in hs].index(h.qid)])[t]


# ------------------------------------------------------------------ the CLI
def test_cqp_serve_mesh_subprocess_matches_the_unsharded_run(tmp_path):
    """``cqp_serve --mesh data --shards 2 --emulate-devices 2`` prints the
    unsharded run's answer digests, with the fault drill too, and its
    2-shard checkpoint restores at ``--mesh none`` to the same digests;
    ``--mesh data`` without emulation asks for cards the CPU has not."""
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    cmd = [sys.executable, "-m", "repro_torch.launch.cqp_serve", "--smoke", "--json", "--device", "cpu",
           "--backend", "fused"]
    sharded = ["--mesh", "data", "--shards", "2", "--emulate-devices", "2"]

    def run(*extra):
        proc = subprocess.run(cmd + list(extra), capture_output=True, text=True, env=env, timeout=300)
        assert proc.returncode == 0, proc.stderr
        return json.loads(proc.stdout.strip().splitlines()[-1])

    plain = run()
    out = run(*sharded)
    assert out["shards"] == 2 and len(out["nbytes_per_device"]) == 2
    assert out["answers_sha256"] == plain["answers_sha256"]
    ckpt = str(tmp_path / "ckpt")
    drill = run(*sharded, "--checkpoint-dir", ckpt, "--checkpoint-every", "2", "--inject-fault-at", "3")
    assert drill["recovery"]["restarts"] == 1 and drill["answers_sha256"] == plain["answers_sha256"]
    resumed = run("--checkpoint-dir", ckpt, "--restore")
    assert resumed["shards"] == 1 and resumed["answers_sha256"] == plain["answers_sha256"]
    refused = subprocess.run(cmd + ["--mesh", "data", "--shards", "2"], capture_output=True, text=True,
                             env=env, timeout=300)
    assert refused.returncode != 0 and "only 1 cpu device" in refused.stderr
