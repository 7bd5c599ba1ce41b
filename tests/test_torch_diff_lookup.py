"""Port parity: the store lookup kernel (K4) and K2's ``new=`` variant.

On the CPU ``diff_lookup`` runs its plain version, held against the
reference's Pallas kernel in interpret mode and its ``diff_lookup_ref`` on
the shapes of ``tests/test_kernels.py`` (plus S=1); ``fused_sweep(new=)``
runs its plain version, held against the reference kernel's new= variant.
The CUDA kernels are held against the plain versions on the card (``gpu``
marker: skips without a CUDA device).  The reference is imported inside the
tests that use it, so ``pytest -m gpu`` runs this file where JAX is not
installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import diffstore as ds
from repro_torch.kernels import diff_lookup as K4
from repro_torch.kernels import fused_sweep as K2
from test_torch_fused_sweep import MODES, _inputs, _port_call

IMAX = 2**31 - 1
SHAPES = [(8, 4), (100, 8), (513, 16), (1024, 32), (300, 1)]  # (N, S)


def _rows(n, s, seed):
    """The reference test's rows: sorted iterations with repeats, ragged
    IMAX padding, values in [0, 1), per-row query iterations in [0, 70)."""
    rng = np.random.default_rng(seed)
    iters = np.sort(rng.integers(0, 60, size=(n, s)), axis=1).astype(np.int32)
    counts = rng.integers(0, s + 1, size=n)
    for r in range(n):
        iters[r, counts[r]:] = IMAX
    vals = rng.random((n, s)).astype(np.float32)
    qi = rng.integers(0, 70, size=n).astype(np.int32)
    return iters, vals, qi


@pytest.mark.parametrize("n,s", SHAPES)
def test_diff_lookup_matches_reference_kernel(n, s):
    import jax.numpy as jnp

    from repro.kernels import ops, ref

    iters, vals, qi = _rows(n, s, n * 1000 + s)
    before = K4.LAUNCHES
    got = K4.diff_lookup(torch.from_numpy(iters), torch.from_numpy(vals), torch.from_numpy(qi))
    assert K4.LAUNCHES == before  # the CPU path launches no kernel
    want_kernel = ops.lookup(jnp.asarray(iters), jnp.asarray(vals), jnp.asarray(qi), block_n=128, interpret=True)
    want_ref = ref.diff_lookup_ref(jnp.asarray(iters), jnp.asarray(vals), jnp.asarray(qi))
    for want in (want_kernel, want_ref):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert g.numpy().dtype == np.asarray(w).dtype
    # the engine's lookup is the same function on a store
    val, it, found = ds.lookup_le(ds.DiffStore(torch.from_numpy(iters), torch.from_numpy(vals), None),
                                  torch.from_numpy(qi))
    assert torch.equal(found, got[2]) and torch.equal(it, got[1])
    assert torch.equal(torch.where(found, val, 0.0), got[0])


def test_diff_lookup_scalar_iteration_and_signed_zero():
    """A Python int asks every row for one iteration, as a tensor of it
    would; a stored -0.0 comes back as -0.0 (the gather keeps it, where the
    TPU body's one-hot sum would return +0.0), and a repeated iteration
    resolves to its last repeat."""
    iters = torch.tensor([[1, 3, 3, IMAX], [2, 2, 2, 5], [IMAX] * 4], dtype=torch.int32)
    vals = torch.tensor([[1.0, -0.0, 7.0, 0.0], [4.0, 5.0, -0.0, 6.0], [0.0] * 4])
    for i in (-1, 0, 2, 3, 4, 5, IMAX):
        scalar = K4.diff_lookup(iters, vals, i)
        per_row = K4.diff_lookup(iters, vals, torch.full((3,), i, dtype=torch.int32))
        for a, b in zip(scalar, per_row):
            assert torch.equal(a, b)
    val, it, found = K4.diff_lookup(iters, vals, 3)
    assert it.tolist() == [3, 2, -1] and found.tolist() == [True, True, False]
    assert val.tolist() == [7.0, 0.0, 0.0] and torch.signbit(val[1]) and not torch.signbit(val[2])


def test_diff_lookup_checks_its_operands():
    iters = torch.full((4, 8), IMAX, dtype=torch.int32)
    vals = torch.zeros((4, 8))
    qi = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        K4.diff_lookup(iters.long(), vals, qi)
    with pytest.raises(TypeError):
        K4.diff_lookup(iters, vals, qi.long())
    with pytest.raises(TypeError):
        K4.diff_lookup(iters, vals, 2**31)
    with pytest.raises(ValueError):
        K4.diff_lookup(iters, vals[:, :4], qi)
    with pytest.raises(ValueError):
        K4.diff_lookup(iters, vals, qi[:3])
    with pytest.raises(ValueError, match="several devices"):
        K4.diff_lookup(iters, vals, qi.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        K4.diff_lookup(iters.to("meta"), vals.to("meta"), 0)


def _new_call(x, mode, device="cpu"):
    """The port's ``fused_sweep(new=)`` operands: the expand's replaced by
    a candidate ``new`` of small integers (ties with stored points)."""
    args, kw = _port_call(x, "min_plus", mode, device)
    for k in ("states", "nbr", "w", "kcarry"):
        del kw[k]
    kw["new"] = torch.from_numpy(x["new"]).to(device)
    return args, kw


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("q,v,s", [(1, 16, 4), (3, 100, 16), (2, 37, 8)])
def test_fused_sweep_new_variant_matches_reference_kernel(q, v, s, mode):
    """K2's new= variant (VDC): every output equal to the reference
    kernel's new= variant."""
    import jax.numpy as jnp

    from repro.core import diffstore as rds
    from repro.core import dropping as rdr
    from repro.kernels.fused_sweep import fused_sweep

    rng = np.random.default_rng(hash((q, v, s, mode, "new")) % 2**31)
    x = _inputs(rng, q, v, 4, s, "min_plus", mode)
    x["new"] = rng.integers(0, 7, size=(q, v)).astype(np.float32)
    args, kw = _new_call(x, mode)
    before = K2.LAUNCHES
    got = K2.fused_sweep(*args, **kw)
    assert K2.LAUNCHES == before
    j = jnp.asarray
    rkw = dict(new=j(x["new"]), block_v=8, drop_mode=mode, interpret=True)
    if mode != "none":
        rkw["degree"] = j(x["degree"])[None, :]
        rkw["params"] = rdr.DropParams(*(j(x[f]) for f in rdr.DropParams._fields))
    if mode == "det":
        rkw["det"] = rds.DiffStore(*map(j, x["det"]))
    if mode == "prob":
        rkw.update(bloom_bits=j(x["bloom_bits"]), bloom_hashes=3)
    want = fused_sweep(x["i"], 0, j(x["sched"]), j(x["active"]), j(x["cur"]), j(x["cur_old"]),
                       j(x["stale_old"]), rds.DiffStore(*map(j, x["dstore"])),
                       rds.DiffStore(*map(j, x["old"])), **rkw)
    for name in K2.FusedOut._fields:
        g, w = getattr(got, name), getattr(want, name)
        if name in ("det_overflow", "det_max_iter") and w is not None:
            w = np.asarray(w).sum(1, dtype=np.int32) if name == "det_overflow" else np.asarray(w).max(1)
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        assert g.numpy().dtype == np.asarray(w).dtype, name
    # and equal to the expand form fed the same candidate
    ref_args, ref_kw = _port_call(x, "min_plus", mode)
    same = K2.fused_sweep_ref(*ref_args, **ref_kw, expand=lambda *a, **k: kw["new"])
    for name, g, w in zip(K2.FusedOut._fields, got, same):
        assert (g is None) == (w is None) and (g is None or torch.equal(g, w)), name


def test_fused_sweep_takes_exactly_one_form():
    rng = np.random.default_rng(1)
    x = _inputs(rng, 2, 10, 3, 4, "min_plus", "none")
    x["new"] = rng.integers(0, 7, size=(2, 10)).astype(np.float32)
    args, kw = _new_call(x, "none")
    _, expand_kw = _port_call(x, "min_plus", "none")
    with pytest.raises(ValueError, match="exactly one"):
        K2.fused_sweep(*args, **{**expand_kw, "new": kw["new"]})
    with pytest.raises(ValueError, match="exactly one"):
        K2.fused_sweep(*args, **{k: v for k, v in kw.items() if k != "new"})
    with pytest.raises(ValueError):
        K2.fused_sweep(*args, **{**kw, "new": kw["new"][:, :5]})
    with pytest.raises(TypeError):
        K2.fused_sweep(*args, **{**kw, "new": kw["new"].double()})


# ---------------------------------------------------------------- on the card
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("n,s", SHAPES + [(100_003, 8), (4097, 6), (70_001, 32)])
def test_diff_lookup_cuda_kernel_matches_plain(n, s):
    """Bit for bit (values as bit patterns), per-row and scalar iterations,
    at ragged N and S with and without the 16-byte row loads."""
    _need_cuda()
    iters, vals, qi = _rows(n, s, n + s)
    vals[np.random.default_rng(n).random(vals.shape) < 0.1] = -0.0
    iters, vals, qi = (torch.from_numpy(x).cuda() for x in (iters, vals, qi))
    for q_arg in (qi, 0, 30, IMAX, -1):
        n0 = K4.LAUNCHES
        got = K4.diff_lookup(iters, vals, q_arg)
        torch.cuda.synchronize()
        assert K4.LAUNCHES == n0 + 1
        want = K4.diff_lookup_ref(iters, vals, q_arg)
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("q,v,s", [(1, 16, 4), (3, 100, 16), (9, 3000, 16), (2, 300, 32)])
def test_fused_sweep_new_cuda_kernel_matches_plain(q, v, s, mode):
    _need_cuda()
    rng = np.random.default_rng(hash((q, v, s, mode, "new-cuda")) % 2**31)
    x = _inputs(rng, q, v, 4, s, "min_plus", mode)
    x["new"] = rng.integers(0, 7, size=(q, v)).astype(np.float32)
    args, kw = _new_call(x, mode, "cuda")
    n = K2.LAUNCHES
    got = K2.fused_sweep(*args, **kw)
    torch.cuda.synchronize()
    assert K2.LAUNCHES == n + 1
    want = K2.fused_sweep_ref(*args, **kw)
    for name, g, w in zip(K2.FusedOut._fields, got, want):
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.dtype == w.dtype and torch.equal(g, w), name
