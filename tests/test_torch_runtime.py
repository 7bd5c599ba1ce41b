"""Port parity: the fault supervisor, the straggler detector and the CQP
recovery supervisor (``repro_torch.runtime``).

Each drill runs through the reference's ``repro.runtime`` and the port on
the same inputs: restart counts, histories and restored states must be
equal.  The recovery supervisor drives real sessions (``device="cpu"``) on
the host and dense engines; a fault mid-stream restores and replays to the
answers of an uninterrupted reference run.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RManager
from repro.core import plan as rplan
from repro.core.graph import DynamicGraph as RGraph
from repro.core.session import CQPSession as RSession
from repro.runtime import fault as rfault
from repro.runtime.recovery import RecoverySupervisor as RRecovery
from repro.runtime.straggler import StragglerDetector as RDetector
from repro_torch.checkpoint import CheckpointManager as TManager
from repro_torch.core import plan as tplan
from repro_torch.core.graph import DynamicGraph as TGraph
from repro_torch.core.session import CQPSession as TSession
from repro_torch.runtime import fault as tfault
from repro_torch.runtime.recovery import RecoverySupervisor as TRecovery
from repro_torch.runtime.straggler import StepTimer, StragglerDetector as TDetector

CPU = "cpu"


def _drill(fault_mod, manager_cls, tmp_path, state, *, fail_at=7, num_steps=10):
    mgr = manager_cls(str(tmp_path), keep=3, async_write=False)
    fired = {"done": False}

    def injector(step):
        if step == fail_at and not fired["done"]:
            fired["done"] = True
            raise fault_mod.InjectedFault("boom")

    sup = fault_mod.Supervisor(mgr, fault_mod.FaultPolicy(checkpoint_every=5), fault_injector=injector)
    executed = []

    def step_fn(st, step):
        executed.append(step)
        return fault_mod.StepResult(state={"x": st["x"] + 1}, metrics={})

    out, last = sup.run(state, step_fn, num_steps=num_steps)
    return out, last, sup, executed


def test_fault_supervisor_restores_and_replays(tmp_path):
    """A fault at step 7 restores the step-5 checkpoint and replays steps 5
    and 6: the same history, executed steps and final count as the
    reference's supervisor; a tensor state comes back as a tensor."""
    r_out, r_last, r_sup, r_exec = _drill(rfault, RManager, tmp_path / "ref", {"x": np.zeros((), np.float32)})
    t_out, t_last, t_sup, t_exec = _drill(tfault, TManager, tmp_path / "port", {"x": torch.zeros(())})
    assert (t_last, t_sup.restarts, t_sup.history, t_exec) == (r_last, r_sup.restarts, r_sup.history, r_exec)
    assert t_exec.count(5) == 2 and t_exec.count(6) == 2
    assert isinstance(t_out["x"], torch.Tensor) and float(t_out["x"]) == float(r_out["x"]) == 10.0


def test_fault_supervisor_genesis_restart_without_a_checkpoint(tmp_path):
    """A fault before the first checkpoint restarts from ``start_step`` and
    ``on_restart`` rebuilds the state."""
    state, last, sup, executed = _drill(tfault, TManager, tmp_path, {"x": torch.zeros(())}, fail_at=2)
    assert last == 10 and sup.restarts == 1 and executed[:3] == [0, 1, 0]
    assert sup.history[:2] == ["fault@2:InjectedFault", "resume@0"]


def test_fault_supervisor_restart_exhaustion_raises(tmp_path):
    """A permanent failure is retried ``max_restarts`` times, then raised."""
    sup = tfault.Supervisor(
        TManager(str(tmp_path), async_write=False),
        tfault.FaultPolicy(max_restarts=2, checkpoint_every=100),
        fault_injector=lambda step: (_ for _ in ()).throw(tfault.InjectedFault("permanent failure")),
    )
    with pytest.raises(tfault.InjectedFault, match="permanent"):
        sup.run({"x": torch.zeros(())}, lambda s, k: tfault.StepResult(state=s, metrics={}), num_steps=3)
    assert sup.restarts == 3
    assert sum(e.startswith("fault@0") for e in sup.history) == 3


def test_fault_supervisor_treats_a_runtime_error_as_a_fault_and_names_it(tmp_path):
    """Like the reference, any ``RuntimeError`` (in PyTorch a CUDA error or
    an out-of-memory error is one) restarts the step; the history names its
    type, so a caller can tell it from an injected drill."""
    seen = {"n": 0}

    def step_fn(st, step):
        if step == 1 and seen["n"] == 0:
            seen["n"] += 1
            raise torch.OutOfMemoryError("device out of memory")
        return tfault.StepResult(state=st, metrics={})

    sup = tfault.Supervisor(TManager(str(tmp_path), async_write=False), tfault.FaultPolicy(checkpoint_every=1))
    _, last = sup.run({"x": torch.zeros(())}, step_fn, num_steps=3)
    assert last == 3 and "fault@1:OutOfMemoryError" in sup.history


def test_fault_policy_not_shared_between_supervisors(tmp_path):
    a = tfault.Supervisor(TManager(str(tmp_path / "a")))
    b = tfault.Supervisor(TManager(str(tmp_path / "b")))
    assert a.policy is not b.policy
    a.policy.max_restarts = 0
    assert b.policy.max_restarts == tfault.FaultPolicy().max_restarts


@pytest.mark.parametrize("samples", [
    [0.1] * 5 + [0.5, 0.1],
    [0.1, 1.0] + [0.1] * 6 + [10.0, 0.1],
])
def test_straggler_detector_matches_the_reference(samples):
    """Warm-up, flags, EWMA (stragglers excluded) and the policy callback:
    the same as the reference's detector on the same step times."""
    dets = [RDetector(threshold=2.0, warmup=3), TDetector(threshold=2.0, warmup=3)]
    hits = [[], []]
    for det, h in zip(dets, hits):
        det.on_straggler(lambda ev, h=h: h.append(ev.step))
    flags = [[det.observe(i, s) for i, s in enumerate(samples)] for det in dets]
    assert flags[1] == flags[0] and any(flags[1])
    assert hits[1] == hits[0] == [i for i, f in enumerate(flags[1]) if f]
    assert dets[1].ewma == dets[0].ewma and dets[1].seen == dets[0].seen
    assert [(e.step, e.ewma_s) for e in dets[1].events] == [(e.step, e.ewma_s) for e in dets[0].events]


def test_step_timer_feeds_the_detector():
    det = TDetector(threshold=2.0, warmup=0)
    with StepTimer(det) as t:
        pass
    assert t.finish(0) is False and det.seen == 1


V = 16
EDGES = [(i, (i + 1) % V, 1.0) for i in range(V)]
LOG = [u for u in (((3 * k) % V, (5 * k + 1) % V, 0, 1.0, +1) for k in range(8)) if u[0] != u[1]]
CHUNKS = [LOG[i : i + 2] for i in range(0, len(LOG), 2)]


def _recovery_run(session_cls, graph_cls, plan_mod, recovery_cls, detector_cls, fault_mod, tmp_path,
                  *, engine, fail_at, every, **kw):
    def fresh():
        s = session_cls(graph_cls(V, EDGES, capacity=128), engine=engine, **kw)
        s.register(plan_mod.sssp(0, max_iters=16))
        return s

    fired = {"done": False}

    def injector(k):
        if k == fail_at and not fired["done"]:
            fired["done"] = True
            raise fault_mod.InjectedFault("drill")

    def restore_fn(directory):
        if directory is None:
            return fresh(), 0
        s = session_cls.restore(directory, **kw)
        return s, int(s.restore_info["extra"]["next_chunk"])

    det = detector_cls()
    sup = recovery_cls(str(tmp_path), fault_mod.FaultPolicy(checkpoint_every=every, max_restarts=2),
                       restore_fn=restore_fn, fault_injector=injector, straggler=det)
    session = fresh()
    session.attach_runtime(straggler=det, supervisor=sup)
    session = sup.run(session, CHUNKS, lambda s, k, chunk: s.apply_updates(chunk))
    session.attach_runtime(straggler=det, supervisor=sup)
    return session, sup


@pytest.mark.parametrize("engine,every,fail_at", [("host", 1, 2), ("dense", 2, 3), ("dense", 0, 2)])
def test_recovery_supervisor_matches_the_reference(engine, every, fail_at, tmp_path):
    """``RecoverySupervisor`` over real sessions: a fault mid-stream restores
    the latest checkpoint (or rebuilds from genesis when none landed) and
    replays; the answers equal the reference's uninterrupted run, and the
    restarts, history, replayed chunks and checkpoint count equal the
    reference supervisor's on the same drill.  The port's metrics add each
    checkpoint's wall split (state_dict, the wait on the previous write, the
    write itself); ``stats()["runtime"]`` surfaces both observers."""
    ref = RSession(RGraph(V, EDGES, capacity=128), engine=engine)
    h_ref = ref.register(rplan.sssp(0, max_iters=16))
    for c in CHUNKS:
        ref.apply_updates(c)
    r_sess, r_sup = _recovery_run(RSession, RGraph, rplan, RRecovery, RDetector, rfault, tmp_path / "ref",
                                  engine=engine, fail_at=fail_at, every=every)
    t_sess, t_sup = _recovery_run(TSession, TGraph, tplan, TRecovery, TDetector, tfault, tmp_path / "port",
                                  engine=engine, fail_at=fail_at, every=every, device=CPU)
    (h,) = t_sess.handles()
    np.testing.assert_array_equal(t_sess.answers(h), ref.answers(h_ref))
    np.testing.assert_array_equal(t_sess.answers(h), r_sess.answers(r_sess.handles()[0]))
    rm, tm = r_sup.metrics(), t_sup.metrics()
    for key in ("restarts", "checkpoints", "checkpoint_bytes", "replayed_chunks", "history"):
        assert tm[key] == rm[key], key
    assert [(r["resumed_chunk"], r["replayed_chunks"]) for r in tm["restores"]] == \
        [(r["resumed_chunk"], r["replayed_chunks"]) for r in rm["restores"]]
    n = tm["checkpoints"]
    assert len(tm["checkpoint_state_s"]) == len(tm["checkpoint_wait_s"]) == len(tm["checkpoint_write_s"]) == n
    rt = t_sess.stats()["runtime"]
    assert rt["fault"]["restarts"] == 1
    # every applied chunk is observed, replays included
    assert rt["straggler"]["observed"] == len(CHUNKS) + tm["replayed_chunks"]
    assert rt["straggler"]["observed"] == r_sess.stats()["runtime"]["straggler"]["observed"]


def test_durability_and_serving_modules_import_neither_jax_nor_the_reference():
    """The slice's modules are among those the port's import check walks."""
    src = Path(__file__).resolve().parents[1] / "src"
    mods = ["repro_torch.checkpoint.store", "repro_torch.runtime.fault", "repro_torch.runtime.recovery",
            "repro_torch.runtime.straggler", "repro_torch.serving.server", "repro_torch.serving.loadgen",
            "repro_torch.launch.cqp_serve"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith(('jax.', 'jaxlib'))"
            " or n == 'repro' or n.startswith('repro.'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(src)), timeout=120)
    assert out.returncode == 0, out.stderr
