"""Port parity: the sequence-sharded decode attentions (``models/common.
dlse_*``), the transformer's decode under a mesh with a ``model`` axis, and
the production mesh's data extent.

- ``tests/test_dlse_attention.py``'s case (B 4, 8/2 heads, S 64, D 16, 37
  valid keys) on the port's (2, 4) ``("data", "model")`` mesh emulated on
  the CPU, and at model extents 1 and 2, against the reference's
  ``chunked_attention``: within 1e-5.
- MLA: ``dlse_mla_decode_attention`` against the reference's single-device
  MLA decode (the latents expanded through ``wuk``/``wuv``, then
  ``chunked_attention`` with the valid length): within 1e-5.
- ``decode_step`` under ``activation_mesh`` of a model mesh against the
  reference's ``decode_step`` for the qwen2-72b, arctic-480b and
  minicpm3-4b smoke configs (weights carried across): every step's logits
  and the final cache within rtol = atol = 1e-5.  The cache's blocks under
  ``cache_specs`` are views of it, so the in-place insert writes them.
- ``make_production_mesh``: the reference's (16, 16) and (2, 16, 16)
  meshes, emulated on the CPU, give the engine 16 shards over ``data``
  alone; over distinct cards it raises without 256 (512) visible, and with
  256 faked, since a ``torch.device`` names at most 128 cards a process.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs import lm_harness as H
from repro_torch.core.convert import transformer_params_from_reference
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf
from repro_torch.runtime import mesh_rules as mr

CPU = "cpu"
TOL = 1e-5


def _mesh(data, model):
    return mesh_lib.make_mesh((data, model), ("data", "model"), device=CPU, emulate=True)


@pytest.mark.parametrize("data,model", [(2, 4), (2, 2), (2, 1), (1, 4)])
@pytest.mark.parametrize("valid", [37, 1, 64])
def test_dlse_decode_attention_matches_the_references_chunked_attention(data, model, valid):
    import jax.numpy as jnp

    from repro.models import common as rcm

    rng = np.random.default_rng(0)
    b, hq, hkv, s, d = 4, 8, 2, 64, 16
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    ck = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    cv = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    want = rcm.chunked_attention(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), causal=False,
                                 q_offset=valid - 1, kv_valid_len=jnp.int32(valid), block_q=8, block_k=16)
    with cm.activation_mesh(_mesh(data, model)):
        got = cm.dlse_decode_attention(torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
                                       valid)
    assert got.shape == (b, hq, 1, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("data,model", [(2, 4), (1, 2)])
def test_dlse_mla_decode_attention_matches_the_references_single_device_decode(data, model):
    import jax.numpy as jnp

    from repro.models import common as rcm

    rng = np.random.default_rng(1)
    b, h, s, kvr, nd, rd, vd, valid = 2, 4, 32, 24, 16, 8, 16, 21
    q = rng.standard_normal((b, h, 1, nd + rd)).astype(np.float32)
    ckv = rng.standard_normal((b, s, kvr)).astype(np.float32)
    krope = rng.standard_normal((b, s, rd)).astype(np.float32)
    wuk = (rng.standard_normal((kvr, h * nd)) / np.sqrt(kvr)).astype(np.float32)
    wuv = (rng.standard_normal((kvr, h * vd)) / np.sqrt(kvr)).astype(np.float32)
    # the reference's single-device MLA decode (repro/models/transformer.py)
    k_nope = (jnp.asarray(ckv) @ wuk).reshape(b, s, h, nd).transpose(0, 2, 1, 3)
    v = (jnp.asarray(ckv) @ wuv).reshape(b, s, h, vd).transpose(0, 2, 1, 3)
    k = jnp.concatenate([k_nope, jnp.broadcast_to(jnp.asarray(krope)[:, None], (b, h, s, rd))], axis=-1)
    want = rcm.chunked_attention(jnp.asarray(q), k, v, causal=False, q_offset=valid - 1,
                                 kv_valid_len=jnp.int32(valid), block_q=16, block_k=16)
    t = [torch.from_numpy(x) for x in (q, ckv, krope, wuk, wuv)]
    with cm.activation_mesh(_mesh(data, model)):
        got = cm.dlse_mla_decode_attention(*t, valid, nope_dim=nd, v_dim=vd)
    assert got.shape == (b, h, 1, vd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def _carried(name, seed=1):
    import jax

    from repro.configs import get_arch as ref_get_arch
    from repro.models import transformer as rtf

    rcfg = ref_get_arch(name).smoke()
    params = rtf.init_params(rcfg, jax.random.PRNGKey(seed))
    port = transformer_params_from_reference(jax.tree.map(np.asarray, params), device=CPU)
    return rcfg, params, get_arch(name).smoke(), port


@pytest.mark.parametrize("name", ["qwen2-72b", "arctic-480b", "minicpm3-4b"])
@pytest.mark.parametrize("data,model", [(1, 4), (2, 2)])
def test_decode_step_under_a_model_mesh_matches_the_reference(name, data, model):
    """Eight decode steps from an empty 16-position cache, batch 2, under a
    model mesh: the dlse attentions (no chunked_attention, the cache's
    blocks views of it) against the reference's single-device decode."""
    import jax
    import jax.numpy as jnp

    from repro.configs import lm_harness as RH
    from repro.models import transformer as rtf

    rcfg, rparams, cfg, params = _carried(name)
    batch, smax = 2, 16
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, size=(8, batch))
    rstep = jax.jit(RH.make_decode(rcfg))
    step = H.make_decode(cfg)
    rcache = rtf.init_cache(rcfg, batch, smax)
    cache = tf.init_cache(cfg, batch, smax, device=CPU)
    mesh = _mesh(data, model)
    placed = [s.place(c) for s, c in zip(mr.shardings_for(tf.cache_specs(cfg), mesh), cache)]
    called = []
    plain = cm.chunked_attention

    def no_plain(*a, **k):
        called.append(1)
        return plain(*a, **k)

    cm.chunked_attention = no_plain
    try:
        with cm.activation_mesh(mesh):
            for t in range(8):
                pos = np.full((batch,), t)
                want, rcache = rstep(rparams, rcache, jnp.asarray(tokens[t], jnp.int32),
                                     jnp.asarray(pos, jnp.int32))
                got, cache2 = step(params, cache, torch.from_numpy(tokens[t]), torch.from_numpy(pos))
                assert cache2 is cache
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    finally:
        cm.chunked_attention = plain
    assert not called  # every decode attention went through dlse
    for got, want, p in zip(cache, rcache, placed):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
        assert torch.equal(p.gather(), got)  # the blocks are views: they hold the inserts
    with pytest.raises(ValueError, match="does not split"):
        with cm.activation_mesh(_mesh(1, 3)):
            step(params, tf.init_cache(cfg, batch, smax, device=CPU), torch.from_numpy(tokens[0]),
                 torch.zeros(batch, dtype=torch.long))


def test_without_a_model_axis_the_decode_is_unchanged():
    """No mesh, or a mesh without a ``model`` axis: the single-device decode
    (``chunked_attention`` on the CPU), bit for bit."""
    _, _, cfg, params = _carried("qwen2-72b")
    tok, pos = torch.tensor([3, 5]), torch.tensor([0, 0])
    base, _ = tf.decode_step(cfg, params, tf.init_cache(cfg, 2, 8, device=CPU), tok, pos)
    data_only = mesh_lib.make_mesh((2,), ("data",), device=CPU, emulate=True)
    with cm.activation_mesh(data_only):
        assert cm.model_mesh() is None
        got, _ = tf.decode_step(cfg, params, tf.init_cache(cfg, 2, 8, device=CPU), tok, pos)
    assert torch.equal(got, base) and cm.model_mesh() is None
    with cm.activation_mesh(_mesh(1, 2)):
        assert cm.model_mesh() is not None
    assert cm._ACTIVATION_MESH[0] is None


def test_production_mesh_shards_the_engine_sixteen_ways(monkeypatch):
    """The reference's (16, 16) and (2, 16, 16) production meshes, over
    which its engine shards vertices ``mesh.shape["data"]`` = 16 ways: the
    port's shape and axes, emulated on the CPU, give the engine 16 shards;
    over distinct cards ``make_production_mesh`` raises unless 256 (512)
    are visible, and even then, since a ``torch.device`` names at most 128
    cards in one process."""
    from repro.launch import mesh as rmesh
    from repro_torch.launch import cqp_serve

    with pytest.raises(ValueError, match="visible"):
        mesh_lib.make_production_mesh()
    with pytest.raises(SystemExit, match="visible"):
        cqp_serve.make_mesh("production", None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 256)
    with pytest.raises(ValueError, match="at most 128"):
        mesh_lib.make_production_mesh()
    with pytest.raises(ValueError, match="visible"):
        mesh_lib.make_production_mesh(multi_pod=True)
    monkeypatch.undo()
    want = {}
    for multi_pod in (False, True):
        prod = mesh_lib.make_mesh(mesh_lib.PRODUCTION_SHAPE[multi_pod], mesh_lib.PRODUCTION_AXES[multi_pod],
                                  device=CPU, emulate=True)
        want[multi_pod] = prod.shape
        engine_mesh = mesh_lib.as_data_mesh(prod)
        assert engine_mesh.size == 16  # the engine's num_shards: the reference's mesh.shape["data"]
        assert mesh_lib.mesh_device(prod) == torch.device(CPU)
    assert want[False] == {"data": 16, "model": 16}
    assert want[True] == {"pod": 2, "data": 16, "model": 16}
    # the reference's function builds the same shapes (it needs 256 devices to run)
    src = Path(rmesh.__file__).read_text()
    assert "shape = (2, 16, 16) if multi_pod else (16, 16)" in src
    assert mr.logical_to_spec(("batch", "kv_seq"), mesh_lib.make_mesh(
        mesh_lib.PRODUCTION_SHAPE[True], mesh_lib.PRODUCTION_AXES[True], device=CPU, emulate=True)) == (
        ("pod", "data"), "model")
