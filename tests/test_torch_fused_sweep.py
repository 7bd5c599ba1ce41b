"""Port parity: the fused sweep kernel (K2) and the Bloom query kernel (K3).

On the CPU the wrappers run their plain PyTorch versions, held against the
reference Pallas kernels in interpret mode, as ``tests/test_kernels.py`` and
``tests/test_fused_sweep.py`` run them.  The CUDA kernels are held against
the plain versions on the card (``gpu`` marker: skips without a CUDA
device).  The reference is imported inside the tests that use it, so
``pytest -m gpu`` runs this file where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import diffstore as ds
from repro_torch.core import dropping as dr
from repro_torch.kernels import bloom as K3
from repro_torch.kernels import ell_spmv as K1
from repro_torch.kernels import fused_sweep as K2
from test_torch_ell_spmv import _misaligned

IMAX = 2**31 - 1
SEMIRINGS = ["min_plus", "min_hop", "min_label", "pr_sum"]
MODES = ["none", "det", "prob"]
SHAPES = [(1, 16, 4, 4), (3, 100, 8, 16), (2, 37, 5, 8)]  # (Q, V, D, S)


def _store(rng, q, v, s, max_iter=20):
    """Sorted IMAX-padded rows, ~30% full, a few with a repeated iteration;
    small integer values, so candidates tie with stored points."""
    count = np.where(rng.random((q, v)) < 0.3, s, rng.integers(0, s + 1, size=(q, v)))
    pts = np.sort(rng.random((q, v, max(max_iter, s))).argsort(-1)[..., :s] + 1, axis=-1)
    dup = rng.random((q, v)) < 0.05
    pts[dup, 1:] = pts[dup, :-1]
    live = np.arange(s)[None, None, :] < count[..., None]
    iters = np.where(live, pts, IMAX).astype(np.int32)
    vals = np.where(live, rng.integers(0, 7, size=(q, v, s)), 0).astype(np.float32)
    return iters, vals, count.astype(np.int32)


def _inputs(rng, q, v, d, s, semiring, mode):
    """numpy operands of one fused sweep call (name → array)."""
    x = dict(i=5, nbr=rng.integers(0, v + 1, size=(v, d)).astype(np.int32),
             w=rng.integers(1, 4, size=(v, d)).astype(np.float32))
    if semiring == "pr_sum":
        x["states"] = np.concatenate([rng.random((q, v), np.float32), np.zeros((q, 1), np.float32)], 1)
        x["cur"] = rng.random((q, v)).astype(np.float32)
        x["kcarry"] = np.full((q, v), 0.15, np.float32)
    else:
        x["states"] = np.concatenate(
            [rng.integers(0, 6, size=(q, v)).astype(np.float32), np.full((q, 1), np.inf, np.float32)], 1)
        x["cur"] = rng.integers(0, 7, size=(q, v)).astype(np.float32)
        x["kcarry"] = x["cur"]
    x.update(sched=rng.random((q, v)) < 0.5, active=np.r_[True, rng.random(q - 1) < 0.7],
             cur_old=rng.integers(0, 7, size=(q, v)).astype(np.float32), stale_old=rng.random((q, v)) < 0.2,
             dstore=_store(rng, q, v, s), old=_store(rng, q, v, s))
    if mode != "none":
        seed = rng.integers(0, 2**32, size=q)
        seed[0] = 2**32 - 1
        x.update(degree=rng.integers(0, 30, size=v).astype(np.float32),
                 p=rng.uniform(0.2, 0.8, size=q).astype(np.float32),
                 tau_min=rng.integers(2, 6, size=q).astype(np.float32),
                 tau_max=np.where(rng.random(q) < 0.5, np.inf, rng.integers(10, 26, size=q)).astype(np.float32),
                 degree_sel=rng.random(q) < 0.5, seed=seed.astype(np.uint32))
    if mode == "det":
        x["det"] = _store(rng, q, v, min(2 * s, K2.MAX_STORE_CAPACITY))
        x["det"][1][:] = 0.0  # Det rows carry no values
    if mode == "prob":
        x["bloom_bits"] = rng.random((q, 1 << 10)) < 0.5
    return x


def _port_call(x, semiring, mode, device="cpu"):
    """(args, kwargs) of the port's ``fused_sweep`` from numpy operands."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    args = (x["i"], t(x["sched"]), t(x["active"]), t(x["cur"]), t(x["cur_old"]), t(x["stale_old"]),
            ds.DiffStore(*map(t, x["dstore"])), ds.DiffStore(*map(t, x["old"])))
    kw = dict(states=t(x["states"]), nbr=t(x["nbr"]), w=t(x["w"]), kcarry=t(x["kcarry"]),
              semiring=semiring, hop_cap=4.0 if semiring == "min_hop" else float("inf"), drop_mode=mode)
    if mode != "none":
        kw["degree"] = t(x["degree"])
        kw["params"] = dr.DropParams(t(x["p"]), t(x["tau_min"]), t(x["tau_max"]), t(x["degree_sel"]),
                                     t(x["seed"].astype(np.int64)))
    if mode == "det":
        kw["det"] = ds.DiffStore(*map(t, x["det"]))
    if mode == "prob":
        kw.update(bloom_bits=t(x["bloom_bits"]), bloom_hashes=3)
    return args, kw


def _reference(x, semiring, mode, off=0):
    import jax.numpy as jnp

    from repro.core import diffstore as rds
    from repro.core import dropping as rdr
    from repro.kernels.fused_sweep import fused_sweep

    j = jnp.asarray
    kw = dict(states=j(x["states"]), nbr=j(x["nbr"]), w=j(x["w"]), kcarry=j(x["kcarry"]), semiring=semiring,
              hop_cap=4.0 if semiring == "min_hop" else float("inf"), block_v=8, drop_mode=mode,
              interpret=True)
    if mode != "none":
        kw["degree"] = j(x["degree"])[None, :]
        kw["params"] = rdr.DropParams(*(j(x[f]) for f in rdr.DropParams._fields))
    if mode == "det":
        kw["det"] = rds.DiffStore(*map(j, x["det"]))
    if mode == "prob":
        kw.update(bloom_bits=j(x["bloom_bits"]), bloom_hashes=3)
    return fused_sweep(x["i"], off, j(x["sched"]), j(x["active"]), j(x["cur"]), j(x["cur_old"]),
                       j(x["stale_old"]), rds.DiffStore(*map(j, x["dstore"])),
                       rds.DiffStore(*map(j, x["old"])), **kw)


FLOAT_OUTS = ("d_vals", "cur", "old")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("q,v,d,s", SHAPES)
def test_fused_sweep_matches_reference_kernel(q, v, d, s, semiring, mode):
    rng = np.random.default_rng(hash((q, v, d, s, semiring, mode)) % 2**31)
    x = _inputs(rng, q, v, d, s, semiring, mode)
    args, kw = _port_call(x, semiring, mode)
    before = K2.LAUNCHES
    got = K2.fused_sweep(*args, **kw)
    assert K2.LAUNCHES == before  # the CPU path launches no kernel
    want = _reference(x, semiring, mode)
    for name in K2.FusedOut._fields:
        g, w = getattr(got, name), getattr(want, name)
        if name in ("det_overflow", "det_max_iter") and w is not None:
            w = np.asarray(w).sum(1, dtype=np.int32) if name == "det_overflow" else np.asarray(w).max(1)
        if w is None:
            assert g is None, name
            continue
        w = np.asarray(w)
        if semiring == "pr_sum" and name in FLOAT_OUTS:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        assert g.numpy().dtype == w.dtype, name


def test_fused_sweep_checks_its_operands():
    rng = np.random.default_rng(0)
    args, kw = _port_call(_inputs(rng, 2, 10, 3, 4, "min_plus", "det"), "min_plus", "det")
    with pytest.raises(ValueError, match="semiring"):
        K2.fused_sweep(*args, **{**kw, "semiring": "max_times"})
    with pytest.raises(ValueError, match="drop mode"):
        K2.fused_sweep(*args, **{**kw, "drop_mode": "maybe"})
    with pytest.raises(ValueError, match="needs det"):
        K2.fused_sweep(*args, **{**kw, "det": None})
    with pytest.raises(TypeError):
        K2.fused_sweep(*args, **{**kw, "nbr": kw["nbr"].long()})
    with pytest.raises(ValueError):
        K2.fused_sweep(*args, **{**kw, "states": kw["states"][:, :10]})  # no sentinel column
    with pytest.raises(ValueError, match="exactly one"):  # new= and the expand's operands
        K2.fused_sweep(*args, **kw, new=args[3])
    meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a for a in args[:6])
    with pytest.raises(ValueError, match="several devices"):
        K2.fused_sweep(*meta, *args[6:], **kw)


def _clone(store):
    return None if store is None else ds.DiffStore(*(t.clone() for t in store))


def _new_form(kw, rng, q, v):
    """The ``new=`` form's kwargs from the expand form's."""
    kw = {k: x for k, x in kw.items() if k not in ("states", "nbr", "w", "kcarry")}
    kw["new"] = torch.from_numpy(rng.integers(0, 7, size=(q, v)).astype(np.float32))
    return kw


@pytest.mark.parametrize("form", ["expand", "new"])
@pytest.mark.parametrize("mode", MODES)
def test_fused_sweep_inplace_equals_out_of_place(mode, form):
    """``inplace=True`` computes what ``inplace=False`` computes, leaf for
    leaf, and writes the stores into ``dstore`` (and ``det``), which come
    back as the outputs; ``inplace=False`` leaves its inputs as they were."""
    q, v, d, s = 3, 40, 5, 8
    rng = np.random.default_rng(hash((mode, form, "inplace")) % 2**31)
    args, kw = _port_call(_inputs(rng, q, v, d, s, "min_plus", mode), "min_plus", mode)
    if form == "new":
        kw = _new_form(kw, rng, q, v)
    frozen = (_clone(args[6]), _clone(kw.get("det")))
    want = K2.fused_sweep(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(args[6], frozen[0]))
    work, det = _clone(args[6]), _clone(kw.get("det"))
    got = K2.fused_sweep(*args[:6], work, args[7], **{**kw, "det": det}, inplace=True)
    for name, g, w in zip(K2.FusedOut._fields, got, want):
        assert (g is None) == (w is None), name
        assert g is None or (g.dtype == w.dtype and torch.equal(g, w)), name
    assert (got.d_iters, got.d_vals, got.d_count) == tuple(work)
    if mode == "det":
        assert got.det_iters is det.iters and got.det_count is det.count
        assert torch.equal(det.vals, frozen[1].vals)  # Det rows carry no values: untouched
    # the plain version, called directly, does the same
    work2, det2 = _clone(frozen[0]), _clone(frozen[1])
    ref = K2.fused_sweep_ref(*args[:6], work2, args[7], **{**kw, "det": det2}, inplace=True)
    assert all(torch.equal(a, b) for a, b in zip(work2, work))
    assert ref.d_iters is work2.iters


def test_fused_sweep_inplace_refuses_to_write_the_old_store():
    """In place, ``dstore`` may not share storage with ``old_dstore``: the
    frozen pre-update store would change under the sweep."""
    rng = np.random.default_rng(3)
    args, kw = _port_call(_inputs(rng, 2, 10, 3, 4, "min_plus", "none"), "min_plus", "none")
    old = args[7]
    with pytest.raises(ValueError, match="old_dstore"):
        K2.fused_sweep(*args[:6], old, old, **kw, inplace=True)
    view = ds.DiffStore(old.iters[:, :], args[6].vals, args[6].count)  # one tensor a view of old's
    with pytest.raises(ValueError, match="old_dstore"):
        K2.fused_sweep(*args[:6], view, old, **kw, inplace=True)
    K2.fused_sweep(*args[:6], old, old, **kw)  # out of place it may: the engine's first iteration


@pytest.mark.parametrize("q,n,mbits,k", [(1, 64, 1 << 10, 2), (3, 500, 1 << 12, 4), (2, 1024, 1 << 14, 6)])
def test_bloom_query_matches_reference_kernel(q, n, mbits, k):
    import jax.numpy as jnp

    from repro.core import bloom as rb
    from repro.kernels import ops, ref
    from repro.kernels.bloom import pack_bits

    rng = np.random.default_rng(q * n)
    v = rng.integers(0, 5000, size=(q, n)).astype(np.int32)
    i = rng.integers(0, 64, size=(q, n)).astype(np.int32)
    mask = rng.random((q, n)) < 0.5
    salt = np.arange(q, dtype=np.int32)
    flt = rb.insert(rb.make((q,), mbits, num_hashes=k), jnp.asarray(v), jnp.asarray(i), jnp.asarray(mask),
                    salt=jnp.asarray(salt)[:, None])
    words = K3.pack_bits(torch.from_numpy(np.array(flt.bits)))
    np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(pack_bits(flt.bits)))
    before = K3.LAUNCHES
    got = K3.bloom_query(words, torch.from_numpy(v), torch.from_numpy(i), torch.from_numpy(salt), num_hashes=k)
    assert K3.LAUNCHES == before
    want = ops.bloom(pack_bits(flt.bits), jnp.asarray(v), jnp.asarray(i), jnp.asarray(salt), num_hashes=k,
                     block_n=256, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.bloom_query_ref(
        pack_bits(flt.bits), jnp.asarray(v), jnp.asarray(i), jnp.asarray(salt), num_hashes=k)))
    assert got.numpy()[mask].all()  # no false negatives


def test_bloom_query_checks_its_operands():
    words = torch.zeros((2, 4), dtype=torch.int32)
    v = torch.zeros((2, 5), dtype=torch.int32)
    salt = torch.arange(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        K3.bloom_query(words, v.long(), v, salt)
    with pytest.raises(ValueError):
        K3.bloom_query(words[:1], v, v, salt)
    with pytest.raises(ValueError, match="multiple of 32"):
        K3.pack_bits(torch.zeros((2, 40), dtype=torch.bool))


# ---------------------------------------------------------------- on the card
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("q,v,d,s", SHAPES + [(9, 3000, 24, 16), (2, 300, 6, 32)])
def test_fused_sweep_cuda_kernel_matches_plain(q, v, d, s, semiring, mode):
    """Every output bit-equal; pr_sum's plain version takes the ELL kernel's
    expand, which is the same device code as K2's."""
    _need_cuda()
    rng = np.random.default_rng(hash((q, v, d, s, semiring, mode, "cuda")) % 2**31)
    args, kw = _port_call(_inputs(rng, q, v, d, s, semiring, mode), semiring, mode, "cuda")
    before = [x.clone() for x in (*args[1:6], *args[6], *args[7])]
    n = K2.LAUNCHES
    got = K2.fused_sweep(*args, **kw)
    torch.cuda.synchronize()
    assert K2.LAUNCHES == n + 1
    expand = K1.ell_spmv if semiring == "pr_sum" else K1.ell_spmv_ref
    want = K2.fused_sweep_ref(*args, **kw, expand=expand)
    for name, g, w in zip(K2.FusedOut._fields, got, want):
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.dtype == w.dtype and torch.equal(g, w), name
    for b, a in zip(before, (*args[1:6], *args[6], *args[7])):
        assert torch.equal(b, a)  # the kernel writes out of place: the frozen store stays


@pytest.mark.gpu
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("q,v,d,s", [(1, 65, 24, 4), (3, 130, 7, 6), (8, 1000, 24, 16), (9, 333, 6, 32)])
def test_fused_sweep_cuda_kernel_in_place_ragged_and_views(q, v, d, s, semiring, mode, inplace,
                                                           misaligned):
    """Both forms of writing, every output bit-equal to the plain version:
    Q in {1, 3, 8, 9}, V no multiple of the block, odd D, S in {4, 6, 16,
    32}; ``misaligned``: every store, the states and the adjacency as views
    that do not start on 16 bytes (the kernel's word paths).  In place the
    outputs are the stores passed in; the old store never changes."""
    _need_cuda()
    rng = np.random.default_rng(hash((q, v, d, s, semiring, mode, inplace, misaligned)) % 2**31)
    args, kw = _port_call(_inputs(rng, q, v, d, s, semiring, mode), semiring, mode, "cuda")
    expand = K1.ell_spmv if semiring == "pr_sum" else K1.ell_spmv_ref
    want = K2.fused_sweep_ref(*args, **kw, expand=expand)
    move = _misaligned if misaligned else (lambda t: t.clone())
    work, old = (ds.DiffStore(*map(move, st)) for st in args[6:8])
    old_before = _clone(old)
    kw = {**kw, "states": move(kw["states"].t().contiguous()), "transposed": True,
          "nbr": move(kw["nbr"]), "w": move(kw["w"])}
    if mode == "det":
        kw["det"] = ds.DiffStore(*map(move, kw["det"]))
    n = K2.LAUNCHES
    got = K2.fused_sweep(*args[:6], work, old, **kw, inplace=inplace)
    torch.cuda.synchronize()
    assert K2.LAUNCHES == n + 1
    for name, g, w in zip(K2.FusedOut._fields, got, want):
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.dtype == w.dtype and torch.equal(g, w), name
    assert all(torch.equal(a, b) for a, b in zip(old, old_before))
    if inplace:
        assert got.d_iters is work.iters and got.d_vals is work.vals and got.d_count is work.count
        if mode == "det":
            assert got.det_iters is kw["det"].iters


@pytest.mark.gpu
@pytest.mark.parametrize("q,n,mbits,k", [(1, 64, 1 << 10, 2), (3, 500, 1 << 12, 4), (8, 100000, 1 << 20, 4)])
def test_bloom_query_cuda_kernel_matches_plain(q, n, mbits, k):
    _need_cuda()
    rng = np.random.default_rng(q * n + 1)
    words = K3.pack_bits(torch.from_numpy(rng.random((q, mbits)) < 0.4).cuda())
    v = torch.from_numpy(rng.integers(0, 2**31 - 1, size=(q, n)).astype(np.int32)).cuda()
    i = torch.from_numpy(rng.integers(0, 64, size=(q, n)).astype(np.int32)).cuda()
    salt = torch.arange(q, dtype=torch.int32, device="cuda")
    n0 = K3.LAUNCHES
    got = K3.bloom_query(words, v, i, salt, num_hashes=k)
    torch.cuda.synchronize()
    assert K3.LAUNCHES == n0 + 1
    assert torch.equal(got, K3.bloom_query_ref(words, v, i, salt, num_hashes=k))


def test_library_path_follows_the_shared_headers(tmp_path):
    """The cached library is keyed by the source, every ``csrc/*.cuh`` and
    the flags: an edit to a header the kernels include rebuilds them."""
    import shutil

    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    sources = sorted(p.name for p in csrc.glob("*.cu"))
    assert {"ell_spmv.cu", "fused_sweep.cu", "bloom.cu", "diff_lookup.cu"} <= set(sources)
    before = {s: _build.library_path(s, csrc) for s in sources}
    assert before == {s: _build.library_path(s) for s in sources}  # same text, same key
    header = csrc / "ell_row.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {s: _build.library_path(s, csrc) for s in sources}
    assert all(after[s] != before[s] and after[s].parent == before[s].parent for s in sources)
