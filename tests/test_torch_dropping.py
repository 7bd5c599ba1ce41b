"""Port parity: the Bloom filter and partial dropping (Det-Drop, Prob-Drop).

The same numpy-seeded inputs go through ``repro.core.{bloom,dropping}`` and
their ports on the CPU; results must be equal, not merely close.  The hashes
are uint32 arithmetic, which the port emulates in int64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bloom as rb
from repro.core import diffstore as rds
from repro.core import dropping as rdr
from repro_torch.core import bloom as tb
from repro_torch.core import diffstore as tds
from repro_torch.core import dropping as tdr

IMAX = np.iinfo(np.int32).max


def _keys(rng, shape):
    """int32 keys near 0, near 2**31 - 1 and negative (uint32 near 2**32)."""
    lo = rng.integers(0, 1000, size=shape)
    hi = rng.integers(2**31 - 1000, 2**31, size=shape)
    neg = rng.integers(-1000, 0, size=shape)
    pick = rng.integers(0, 3, size=shape)
    return np.choose(pick, [lo, hi, neg]).astype(np.int32)


def _u32(x):
    return np.asarray(x).astype(np.int64)


def test_mix_matches_reference_across_the_uint32_range():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.integers(0, 1000, 200), rng.integers(2**32 - 1000, 2**32, 200),
        [0, 1, 2**31, 2**32 - 1, 0x85EBCA6B, 0xC2B2AE35],
    ]).astype(np.uint32)
    got = tb._mix(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), _u32(rb._mix(jnp.asarray(x))))
    assert int(got.min()) >= 0 and int(got.max()) <= 0xFFFFFFFF


def test_int64_product_wraps_to_the_uint32_product():
    """A product of two 32-bit values can pass 2**63: torch wraps it and
    the low 32 bits are still the uint32 product."""
    a = torch.tensor([0xFFFFFFFF, 0xFFFFFFFF, 0x80000001], dtype=torch.int64)
    b = torch.tensor([0x85EBCA6B, 0xFFFFFFFF, 0xC2B2AE35], dtype=torch.int64)
    want = (np.array([0xFFFFFFFF, 0xFFFFFFFF, 0x80000001], np.uint32)
            * np.array([0x85EBCA6B, 0xFFFFFFFF, 0xC2B2AE35], np.uint32))
    prod = a * b
    assert int(prod[1]) < 0  # 0xFFFFFFFF**2 passes 2**63
    np.testing.assert_array_equal((prod & 0xFFFFFFFF).numpy(), want.astype(np.int64))


@pytest.mark.parametrize("salt_kind", ["scalar", "per_query"])
def test_hash_key_and_probes_match(salt_kind):
    rng = np.random.default_rng(1)
    v, i = _keys(rng, (3, 64)), _keys(rng, (3, 64))
    salt = 7 if salt_kind == "scalar" else np.array([[0], [1], [2**31 - 1]], np.int32)
    ts = salt if salt_kind == "scalar" else torch.from_numpy(salt)
    rs = salt if salt_kind == "scalar" else jnp.asarray(salt)
    for g, w in zip(tb.hash_key(torch.from_numpy(v), torch.from_numpy(i), ts),
                    rb.hash_key(jnp.asarray(v), jnp.asarray(i), rs)):
        np.testing.assert_array_equal(g.numpy(), _u32(w))
    for bits in (1 << 10, 1000):
        got = tb._probes(tb.make((3,), bits, 5), torch.from_numpy(v), torch.from_numpy(i), ts)
        want = rb._probes(rb.make((3,), bits, 5), jnp.asarray(v), jnp.asarray(i), rs)
        np.testing.assert_array_equal(got.numpy(), _u32(want))
    # a filter row near 2**31 bits: h1 + j*h2 wraps at 2**32 before the modulo
    big = tb.BloomFilter(torch.zeros(1, dtype=torch.bool).expand(3, 2**31 - 1), 5)
    h1, h2 = (_u32(h).astype(np.uint64) for h in rb.hash_key(jnp.asarray(v), jnp.asarray(i), rs))
    want = ((h1[..., None] + np.arange(5, dtype=np.uint64) * h2[..., None]) % 2**32) % (2**31 - 1)
    got = tb._probes(big, torch.from_numpy(v), torch.from_numpy(i), ts)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("q,n,mbits,k", [(1, 64, 1 << 10, 2), (3, 500, 1 << 12, 4), (2, 300, 1000, 6)])
def test_bloom_insert_query_fill_match(q, n, mbits, k):
    rng = np.random.default_rng(q * n)
    v, i = _keys(rng, (q, n)), rng.integers(0, 64, size=(q, n)).astype(np.int32)
    mask = rng.random((q, n)) < 0.5
    salt = np.arange(q, dtype=np.int32)[:, None]
    rf = rb.insert(rb.make((q,), mbits, k), jnp.asarray(v), jnp.asarray(i), jnp.asarray(mask), salt=jnp.asarray(salt))
    tf = tb.insert(tb.make((q,), mbits, k), torch.from_numpy(v), torch.from_numpy(i), torch.from_numpy(mask),
                   salt=torch.from_numpy(salt))
    np.testing.assert_array_equal(tf.bits.numpy(), np.asarray(rf.bits))
    assert tf.num_hashes == rf.num_hashes and tf.num_bits == rf.num_bits
    assert tf.nbytes_accounted == rf.nbytes_accounted
    probe_v = np.where(rng.random((q, n)) < 0.5, v, _keys(rng, (q, n)))
    np.testing.assert_array_equal(
        tb.query(tf, torch.from_numpy(probe_v), torch.from_numpy(i), torch.from_numpy(salt)).numpy(),
        np.asarray(rb.query(rf, jnp.asarray(probe_v), jnp.asarray(i), salt=jnp.asarray(salt))),
    )
    # no false negatives
    hit = tb.query(tf, torch.from_numpy(v), torch.from_numpy(i), torch.from_numpy(salt)).numpy()
    assert hit[mask].all()
    np.testing.assert_array_equal(tb.fill_fraction(tf).numpy(), np.asarray(rb.fill_fraction(rf)))


def test_bloom_key_is_global_vertex_salted_by_query_slot():
    """``register``/``dropped_at`` hash the vertex id with the query slot
    index as the salt: a drop of (v=5, i=3) in slot 1 sets exactly the
    probes of ``hash_key(5, 3, salt=1)`` in row 1, as in the reference."""
    cfg = tdr.DropConfig(mode="prob", p=0.5, bloom_bits=1 << 10, bloom_hashes=3)
    st = tdr.make_state(cfg, 2, 8)
    mask = torch.zeros((2, 8), dtype=torch.bool)
    mask[1, 5] = True
    st = tdr.register(st, 3, mask)
    probes = tb._probes(st.flt, torch.tensor(5), torch.tensor(3), 1)
    assert st.flt.bits[1, probes].all() and int(st.flt.bits[1].sum()) == len(set(probes.tolist()))
    assert not st.flt.bits[0].any()
    assert bool(tdr.dropped_at(st, 3, 8)[1, 5])
    rst = rdr.register(rdr.make_state(rdr.DropConfig(mode="prob", p=0.5, bloom_bits=1 << 10, bloom_hashes=3), 2, 8),
                       3, jnp.asarray(mask.numpy()))
    np.testing.assert_array_equal(st.flt.bits.numpy(), np.asarray(rst.flt.bits))
    assert int(st.max_iter) == int(rst.max_iter) == 3


def test_uniform01_rounds_like_the_reference():
    """uint32 → float32 rounds to nearest (0xFFFFFFFF reads 1.0)."""
    edge = np.array([0xFFFFFFFF, 0xFFFFFF7F, 16777217, 0], np.uint32)
    np.testing.assert_array_equal(
        torch.from_numpy(edge.astype(np.int64)).to(torch.float32).numpy(),
        np.asarray(jnp.asarray(edge).astype(jnp.float32)),
    )
    rng = np.random.default_rng(3)
    seeds = np.array([0, 7, 2**32 - 1], np.uint32)
    q = np.arange(3)[:, None]
    v = rng.integers(0, 2**31 - 1, size=(1, 400))
    i = rng.integers(0, 100, size=(3, 400))
    got = tdr._uniform01(torch.from_numpy(seeds.astype(np.int64))[:, None], torch.from_numpy(q),
                         torch.from_numpy(v), torch.from_numpy(i))
    want = rdr._uniform01(jnp.asarray(seeds)[:, None], jnp.asarray(q, jnp.int32),
                          jnp.asarray(v, jnp.int32), jnp.asarray(i, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.float32


def _params(selection):
    cfgs = [tdr.DropConfig(mode="det", selection=selection, p=p, tau_min=3.0, tau_max=tmax, seed=s)
            for p, tmax, s in ((0.3, 10.0, 1), (0.7, float("inf"), 2**32 - 1), (0.0, 5.0, 0))]
    rcfgs = [rdr.DropConfig(**{f: getattr(c, f) for f in ("mode", "selection", "p", "tau_min", "tau_max", "seed")})
             for c in cfgs]
    return tdr.make_params(cfgs), rdr.make_params(rcfgs)


@pytest.mark.parametrize("selection", ["random", "degree"])
def test_select_to_drop_matches(selection):
    rng = np.random.default_rng(4)
    tp, rp = _params(selection)
    degree = rng.integers(0, 14, size=(1, 50)).astype(np.float32)
    q = np.arange(3, dtype=np.int32)[:, None]
    v = np.arange(50, dtype=np.int32)[None, :]
    for i in (1, 7, 23):
        got = tdr.select_to_drop(tp, torch.from_numpy(degree), torch.from_numpy(q), torch.from_numpy(v), i)
        want = rdr.select_to_drop(rp, jnp.asarray(degree), jnp.asarray(q), jnp.asarray(v), i)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()


def test_set_params_row_matches():
    tp, rp = _params("degree")
    new = dict(mode="det", selection="random", p=0.9, seed=2**32 - 5)
    got = tdr.set_params_row(tp, 1, tdr.DropConfig(**new))
    want = rdr.set_params_row(rp, 1, rdr.DropConfig(**new))
    for f in rdr.DropParams._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)).astype(
            np.int64 if f == "seed" else np.asarray(getattr(want, f)).dtype))
    assert torch.equal(tp.p, _params("degree")[0].p)  # the input rows are untouched


def _det_states(rng, s_d=4):
    """Port and reference Det states holding the same random rows."""
    cfg = dict(mode="det", p=0.5, det_capacity=s_d)
    t, r = tdr.make_state(tdr.DropConfig(**cfg), 3, 9), rdr.make_state(rdr.DropConfig(**cfg), 3, 9)
    iters = np.full((3, 9, s_d), IMAX, np.int32)
    count = rng.integers(0, s_d + 1, size=(3, 9)).astype(np.int32)
    count[0, :3] = s_d  # full rows: a register there evicts
    for qq in range(3):
        for vv in range(9):
            iters[qq, vv, : count[qq, vv]] = np.sort(rng.choice(np.arange(1, 12), count[qq, vv], replace=False))
    vals = np.zeros((3, 9, s_d), np.float32)
    t = t._replace(det=tds.DiffStore(*map(torch.from_numpy, (iters.copy(), vals.copy(), count.copy()))))
    r = r._replace(det=rds.DiffStore(*map(jnp.asarray, (iters, vals, count))))
    return t, r


def _same_drop_state(t, r):
    np.testing.assert_array_equal(t.det_overflow.numpy(), np.asarray(r.det_overflow))
    np.testing.assert_array_equal(t.max_iter.numpy(), np.asarray(r.max_iter))
    assert t.det_overflow.dtype == t.max_iter.dtype == torch.int32
    if r.det is not None:
        for g, w in zip(t.det, r.det):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if r.flt is not None:
        np.testing.assert_array_equal(t.flt.bits.numpy(), np.asarray(r.flt.bits))


@pytest.mark.parametrize("scalar_i", [True, False])
def test_det_register_unregister_dropped_at(scalar_i):
    rng = np.random.default_rng(5)
    t, r = _det_states(rng)
    mask = rng.random((3, 9)) < 0.6
    i = 6 if scalar_i else rng.integers(1, 14, size=(3, 9)).astype(np.int32)
    ti = i if scalar_i else torch.from_numpy(i)
    ri = i if scalar_i else jnp.asarray(i)
    t = tdr.register(t, ti, torch.from_numpy(mask))
    r = rdr.register(r, ri, jnp.asarray(mask))
    _same_drop_state(t, r)
    assert int(t.det_overflow) > 0  # full rows received a new iteration
    for j in (1, 6, 13):
        np.testing.assert_array_equal(tdr.dropped_at(t, j, 9).numpy(), np.asarray(rdr.dropped_at(r, j, 9)))
    un = rng.random((3, 9)) < 0.5
    _same_drop_state(tdr.unregister(t, 6, torch.from_numpy(un)), rdr.unregister(r, 6, jnp.asarray(un)))


def test_prob_register_per_row_iterations_and_unregister_noop():
    rng = np.random.default_rng(6)
    cfg = dict(mode="prob", p=0.5, bloom_bits=1 << 9, bloom_hashes=4)
    t, r = tdr.make_state(tdr.DropConfig(**cfg), 3, 20), rdr.make_state(rdr.DropConfig(**cfg), 3, 20)
    for _ in range(3):
        mask = rng.random((3, 20)) < 0.3
        it = rng.integers(1, 30, size=(3, 20)).astype(np.int32)
        t = tdr.register(t, torch.from_numpy(it), torch.from_numpy(mask))
        r = rdr.register(r, jnp.asarray(it), jnp.asarray(mask))
        _same_drop_state(t, r)
    for j in (1, 5, 29):
        np.testing.assert_array_equal(tdr.dropped_at(t, j, 20).numpy(), np.asarray(rdr.dropped_at(r, j, 20)))
    assert tdr.unregister(t, 3, torch.ones((3, 20), dtype=torch.bool)) is t


@pytest.mark.parametrize("mode", ["det", "prob"])
@pytest.mark.parametrize("active", [None, [True, False, True]])
def test_make_state_and_nbytes_accounted(mode, active):
    rng = np.random.default_rng(7)
    rows = [tdr.DropConfig(mode=mode, p=0.2 * k, seed=k, bloom_bits=1000) for k in range(3)]
    rrows = [rdr.DropConfig(mode=mode, p=0.2 * k, seed=k, bloom_bits=1000) for k in range(3)]
    t = tdr.make_state(rows[0], 3, 9, per_query=rows)
    r = rdr.make_state(rrows[0], 3, 9, per_query=rrows)
    _same_drop_state(t, r)
    for f in rdr.DropParams._fields:
        np.testing.assert_array_equal(getattr(t.params, f).numpy(), np.asarray(getattr(r.params, f)))
    if mode == "det":
        t, r = _det_states(rng)
    ta = None if active is None else torch.tensor(active)
    ra = None if active is None else jnp.asarray(active)
    assert t.nbytes_accounted(ta) == int(r.nbytes_accounted(ra)) > 0
    assert isinstance(t.nbytes_accounted(ta), int)
