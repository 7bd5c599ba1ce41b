"""Port parity: semiring messages and every difference-store function.

The same numpy-seeded inputs go through the JAX reference and the port (on
the CPU); results must be equal, not merely close.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import diffstore as rds
from repro.core import dropping as rdr
from repro.core import semiring as rsr
from repro_torch.core import diffstore as tds
from repro_torch.core import dropping as tdr
from repro_torch.core import semiring as tsr

IMAX = np.iinfo(np.int32).max

SEMIRINGS = [
    ("min_plus", rsr.min_plus, tsr.min_plus, ()),
    ("min_hop", rsr.min_hop, tsr.min_hop, ()),
    ("min_hop_cap3", rsr.min_hop, tsr.min_hop, (3.0,)),
    ("min_label", rsr.min_label, tsr.min_label, ()),
    ("pagerank", rsr.pagerank, tsr.pagerank, (0.85,)),
]


@pytest.mark.parametrize("name,ref_ctor,port_ctor,args", SEMIRINGS)
def test_semiring_messages_match(name, ref_ctor, port_ctor, args):
    rng = np.random.default_rng(len(name))
    s = (rng.random((3, 40)) * 8).astype(np.float32)
    s[rng.random((3, 40)) < 0.2] = np.inf
    w = rng.integers(1, 10, size=(3, 40)).astype(np.float32)
    ref, port = ref_ctor(*args), port_ctor(*args)
    want = np.asarray(ref.msg(jnp.asarray(s), jnp.asarray(w)))
    got = port.msg(torch.from_numpy(s), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32
    for field in ("name", "reduce", "identity", "carry_prev", "base", "hop_cap", "kernel_name"):
        assert getattr(port, field) == getattr(ref, field), field
    a, b = s, np.flip(s, axis=1).copy()
    np.testing.assert_array_equal(
        tsr.reduce_pair(port, torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(rsr.reduce_pair(ref, jnp.asarray(a), jnp.asarray(b))),
    )


def _random_store(rng, shape, s, *, full_frac=0.3, max_iter=12):
    """Sorted, IMAX-padded rows; about ``full_frac`` of them at capacity."""
    n = int(np.prod(shape))
    iters = np.full((n, s), IMAX, np.int32)
    vals = np.zeros((n, s), np.float32)
    count = np.zeros(n, np.int32)
    for r in range(n):
        c = s if rng.random() < full_frac else int(rng.integers(0, s + 1))
        pts = np.sort(rng.choice(np.arange(1, max_iter + 1), size=c, replace=False))
        iters[r, :c] = pts
        vals[r, :c] = rng.integers(0, 50, size=c).astype(np.float32)
        count[r] = c
    return (
        iters.reshape(*shape, s),
        vals.reshape(*shape, s),
        count.reshape(shape),
    )


def _stores(arrs):
    it, va, co = arrs
    ref = rds.DiffStore(jnp.asarray(it), jnp.asarray(va), jnp.asarray(co))
    port = tds.DiffStore(torch.from_numpy(it.copy()), torch.from_numpy(va.copy()), torch.from_numpy(co.copy()))
    return ref, port


def _eq(got, want):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    want = np.asarray(want)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)


def _eq_store(got: tds.DiffStore, want: rds.DiffStore):
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.fixture(params=[0, 1, 2])
def store_case(request):
    rng = np.random.default_rng(100 + request.param)
    arrs = _random_store(rng, (3, 17), 4)
    i_rows = rng.integers(0, 14, size=(3, 17)).astype(np.int32)
    mask = rng.random((3, 17)) < 0.6
    new_vals = rng.integers(0, 50, size=(3, 17)).astype(np.float32)
    return arrs, i_rows, mask, new_vals


def test_make_and_nbytes(store_case):
    arrs, *_ = store_case
    _eq_store(tds.make((3, 17), 4), rds.make((3, 17), 4))
    ref, port = _stores(arrs)
    assert int(tds.nbytes_used(port)) == int(rds.nbytes_used(ref))


@pytest.mark.parametrize("scalar", [True, False])
def test_lookups(store_case, scalar):
    arrs, i_rows, _, _ = store_case
    ref, port = _stores(arrs)
    for i in ([0, 1, 5, 12, 13] if scalar else [i_rows]):
        ri = i if scalar else jnp.asarray(i)
        pi = i if scalar else torch.from_numpy(i)
        for g, w in zip(tds.lookup_le(port, pi), rds.lookup_le(ref, ri)):
            _eq(g, w)
        for g, w in zip(tds.value_at(port, pi), rds.value_at(ref, ri)):
            _eq(g, w)
        _eq(tds.has_at(port, pi), rds.has_at(ref, ri))


@pytest.mark.parametrize("scalar", [True, False])
def test_upsert_with_eviction_and_overwrite(store_case, scalar):
    arrs, i_rows, mask, new_vals = store_case
    ref, port = _stores(arrs)
    i = 7 if scalar else i_rows
    got = tds.upsert(port, i if scalar else torch.from_numpy(i), torch.from_numpy(mask), torch.from_numpy(new_vals))
    want = rds.upsert(ref, i if scalar else jnp.asarray(i), jnp.asarray(mask), jnp.asarray(new_vals))
    _eq_store(got[0], want[0])
    _eq(got[1], want[1])
    _eq(got[2], want[2])
    # the fixture holds full rows that receive a new iteration: evictions happen
    assert bool(np.asarray(want[1]).any()) or not scalar


def test_upsert_full_row_evicts_oldest():
    """A full row receiving a new iteration sheds its oldest point; an
    existing iteration is overwritten in place (ties: the first match)."""
    it = np.array([[[2, 4, 6]], [[2, 4, 6]], [[1, 3, IMAX]]], np.int32)
    va = np.array([[[1, 2, 3]], [[1, 2, 3]], [[5, 6, 0]]], np.float32)
    co = np.array([[3], [3], [2]], np.int32)
    ref, port = _stores((it, va, co))
    i = np.array([[5], [4], [0]], np.int32)
    m = np.ones((3, 1), bool)
    nv = np.full((3, 1), 9.0, np.float32)
    got = tds.upsert(port, torch.from_numpy(i), torch.from_numpy(m), torch.from_numpy(nv))
    want = rds.upsert(ref, jnp.asarray(i), jnp.asarray(m), jnp.asarray(nv))
    _eq_store(got[0], want[0])
    _eq(got[1], want[1])
    _eq(got[2], want[2])
    assert got[0].iters[0, 0].tolist() == [4, 5, 6] and bool(got[1][0, 0])
    assert got[0].vals[1, 0].tolist() == [1.0, 9.0, 3.0] and not bool(got[1][1, 0])


@pytest.mark.parametrize("scalar", [True, False])
def test_remove_at(store_case, scalar):
    arrs, i_rows, mask, _ = store_case
    ref, port = _stores(arrs)
    for i in ([1, 3, 12] if scalar else [i_rows]):
        pi = i if scalar else torch.from_numpy(i)
        ri = i if scalar else jnp.asarray(i)
        _eq_store(tds.remove_at(port, pi, torch.from_numpy(mask)), rds.remove_at(ref, ri, jnp.asarray(mask)))


def test_gather_rows(store_case):
    arrs, *_ = store_case
    ref, port = _stores(arrs)
    idx = np.array([4, -1, 0, 16, 16, -3, 2], np.int32)
    _eq_store(tds.gather_rows(port, torch.from_numpy(idx)), rds.gather_rows(ref, jnp.asarray(idx)))


def test_store_ops_are_pure(store_case):
    """The sweep holds the pre-update store frozen: no store op may write
    into its input."""
    arrs, i_rows, mask, new_vals = store_case
    _, port = _stores(arrs)
    before = [x.clone() for x in port]
    tds.upsert(port, torch.from_numpy(i_rows), torch.from_numpy(mask), torch.from_numpy(new_vals))
    tds.remove_at(port, 3, torch.from_numpy(mask))
    for b, a in zip(before, port):
        assert torch.equal(b, a)


def test_drop_config_and_disabled_state():
    cfgs = [tdr.DropConfig(), tdr.DropConfig(mode="det", p=0.5, seed=7),
            tdr.DropConfig(mode="prob", selection="degree", p=1.0, tau_max=3.0)]
    rcfgs = [rdr.DropConfig(), rdr.DropConfig(mode="det", p=0.5, seed=7),
             rdr.DropConfig(mode="prob", selection="degree", p=1.0, tau_max=3.0)]
    for c, r in zip(cfgs, rcfgs):
        assert tdr.params_row(c) == rdr.params_row(r)
        assert (c.enabled(), c.drops_all()) == (r.enabled(), r.drops_all())
    got, want = tdr.make_params(cfgs), rdr.make_params(rcfgs)
    for f in rdr.DropParams._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    st, rst = tdr.make_state(tdr.DropConfig(), 3, 5), rdr.make_state(rdr.DropConfig(), 3, 5)
    _eq(st.det_overflow, rst.det_overflow)
    _eq(st.max_iter, rst.max_iter)
    assert st.det is None and st.flt is None and st.params is None
    # an enabled config builds its DroppedVT (Det store here), as the reference's
    det, rdet = tdr.make_state(cfgs[1], 3, 5), rdr.make_state(rcfgs[1], 3, 5)
    _eq_store(det.det, rdet.det)
    assert det.flt is None and rdet.flt is None


def test_plan_json_is_byte_identical():
    """One ``plans.json`` drives both packages: the plan IR's JSON and family
    keys are the reference's, byte for byte."""
    import json

    from repro.core import plan as rplan
    from repro_torch.core import plan as tplan

    def plans(mod, drmod):
        nfa = mod.NFA.concat_star(1, 2)
        return [
            mod.sssp(3, max_iters=12, drop=drmod.DropConfig(mode="det", p=0.25, seed=4)),
            mod.spsp(1, 7),
            mod.khop(2, k=4),
            mod.wcc(max_iters=9),
            mod.pagerank(iters=6, alpha=0.8),
            mod.rpq(0, nfa, join_store="drop").with_aggregate("histogram", bins=4),
        ]

    for r, t in zip(plans(rplan, rdr), plans(tplan, tdr)):
        rj = json.dumps(r.to_json(), sort_keys=False)
        assert json.dumps(t.to_json(), sort_keys=False) == rj
        assert repr(tplan.QueryPlan.from_json(rj).family_key()) == repr(r.family_key())
        np.testing.assert_array_equal(t.build_init(10), r.build_init(10))
