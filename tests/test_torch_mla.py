"""Port parity: multi-head latent attention (minicpm3-4b's MLA).

One layer of the reference's smoke config (``repro/models/transformer.py``
``_attention``, MLA branch; weights from its ``init_params``, carried
across) against the port's on the same numpy-seeded inputs: the prefill
(causal, queries from position 0) and a decode step against a latent
cache, each output and cache entry at rtol/atol 1e-5 (float32, the same
operations in another order).  The port's decode expands only the cache's
valid prefix where the reference expands all of it and masks the rest: the
tail is filled with large values, which the reference's masked keys add as
exact zeros, and the two agree.  The whole model's forward, decode and
greedy serving parity is in ``tests/test_torch_transformer.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.convert import transformer_params_from_reference
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf

ARCH = get_arch("minicpm3-4b")
RTOL = ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def _layer(seed=0):
    """The reference's smoke config, its layer-0 weights, and the port's."""
    import jax

    from repro.configs import get_arch as ref_get_arch
    from repro.models import transformer as rtf

    ref_cfg = ref_get_arch("minicpm3-4b").smoke()
    params = jax.tree.map(np.asarray, rtf.init_params(ref_cfg, jax.random.PRNGKey(seed)))
    rw = {k: v[0] for k, v in params["layers"].items()}
    return ref_cfg, rw, transformer_params_from_reference(rw, device="cpu")


def test_init_cache_holds_the_latents():
    from repro.configs import get_arch as ref_get_arch
    from repro.models import transformer as rtf

    for port_cfg, ref_cfg in ((ARCH.smoke(), ref_get_arch("minicpm3-4b").smoke()),
                              (ARCH.full(), ref_get_arch("minicpm3-4b").full())):
        if port_cfg.num_layers > 2:  # full widths: shapes only
            want = [tuple(x.shape) for x in rtf.init_cache(ref_cfg, 1, 8)]
            got = [tuple(x.shape) for x in tf.init_cache(port_cfg, 1, 8, device="meta")]
        else:
            want = [tuple(x.shape) for x in rtf.init_cache(ref_cfg, 3, 40)]
            got = [tuple(x.shape) for x in tf.init_cache(port_cfg, 3, 40, device="cpu")]
        assert got == want
    assert got == [(62, 1, 8, 256), (62, 1, 8, 32)]
    assert tf.cache_seq_axis(ARCH.smoke()) == 2
    assert tf.cache_seq_axis(get_arch("llama3.2-1b").smoke()) == 3


@pytest.mark.parametrize("sq", [5, 33])
def test_mla_prefill_matches_the_reference(sq):
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as rtf

    ref_cfg, rw, w = _layer()
    rng = np.random.default_rng(sq)
    x = rng.standard_normal((2, sq, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(sq)[None], (2, sq))
    want, (wc, wr) = jax.jit(lambda *a: rtf._attention(ref_cfg, *a))(rw, jnp.asarray(x), jnp.asarray(pos))
    got, (gc, gr) = tf._attention(ARCH.smoke(), w, torch.from_numpy(x), torch.from_numpy(pos.copy()))
    for g, r in ((got, want), (gc, wc), (gr, wr)):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)
    assert tuple(gc.shape) == (2, sq, 16) and tuple(gr.shape) == (2, sq, 8)


@pytest.mark.parametrize("pos,smax", [(0, 40), (17, 40), (39, 40), (25, 64)])
def test_mla_decode_expands_only_the_valid_prefix(pos, smax):
    """A decode step at ``pos`` against a latent cache whose tail past
    ``pos`` holds large values (a stale or garbage tail): the port (which
    expands ``[:pos + 1]``) equals the reference (which expands all of it
    and masks the tail) in output and updated cache, and equals the port's
    own attention over the whole expanded cache with the tail masked."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as rtf

    ref_cfg, rw, w = _layer(seed=1)
    cfg = ARCH.smoke()
    rng = np.random.default_rng(pos + smax)
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    ckv = rng.standard_normal((3, smax, 16)).astype(np.float32)
    krope = rng.standard_normal((3, smax, 8)).astype(np.float32)
    ckv[:, pos + 1:] *= 1e3
    krope[:, pos + 1:] *= 1e3
    positions = np.full((3, 1), pos)
    want, (wc, wr) = jax.jit(lambda *a: rtf._attention(ref_cfg, *a))(
        rw, jnp.asarray(x), jnp.asarray(positions), (jnp.asarray(ckv), jnp.asarray(krope)))
    cache = (torch.from_numpy(ckv.copy()), torch.from_numpy(krope.copy()))
    got, (gc, gr) = tf._attention(cfg, w, torch.from_numpy(x), torch.from_numpy(positions), cache,
                                  kv_len=pos + 1)
    assert gc is cache[0] and gr is cache[1]  # written in place
    for g, r in ((got, want), (gc, wc), (gr, wr)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)

    # the whole cache expanded, its tail masked by kv_valid_len: the same
    # function (the masked keys add exactly zero)
    orig = cm.chunked_attention
    seen = []

    def whole(q, k, v, **kw):
        seen.append(k.shape[2])
        return orig(q, k, v, **kw)

    def expand_all(q, k, v, **kw):
        b, hq = q.shape[:2]
        k_nope = (gc @ w["wuk"]).reshape(b, smax, hq, 16).transpose(1, 2)
        vv = (gc @ w["wuv"]).reshape(b, smax, hq, 16).transpose(1, 2)
        kk = torch.cat([k_nope, gr[:, None].expand(b, hq, smax, 8)], dim=-1)
        return orig(q, kk, vv, **{**kw, "kv_valid_len": pos + 1})

    try:
        tf.cm.chunked_attention = whole
        again, _ = tf._attention(cfg, w, torch.from_numpy(x), torch.from_numpy(positions),
                                 (gc.clone(), gr.clone()), kv_len=pos + 1)
        tf.cm.chunked_attention = expand_all
        full, _ = tf._attention(cfg, w, torch.from_numpy(x), torch.from_numpy(positions),
                                (gc.clone(), gr.clone()), kv_len=pos + 1)
    finally:
        tf.cm.chunked_attention = orig
    assert seen == [pos + 1]  # only the valid prefix was expanded
    torch.testing.assert_close(again, got, rtol=0, atol=0)
    torch.testing.assert_close(full, got, rtol=1e-6, atol=1e-6)


def test_mla_config_fields_follow_the_reference():
    cfg = ARCH.full()
    assert (cfg.qk_dim, cfg.v_dim) == (96, 64)
    smoke = dataclasses.replace(ARCH.smoke(), attention="gqa")
    assert (smoke.qk_dim, smoke.v_dim) == (smoke.head_dim, smoke.head_dim)
