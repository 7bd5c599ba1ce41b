"""Port parity: the llama3.2-1b serving slice (dense GQA transformer).

The smoke config (2 layers, d=64, 4 query / 2 KV heads of 16, float32) runs
through the reference (``repro/models/transformer.py``, its own jit on the
CPU) and the port (``repro_torch.models.transformer``, ``device="cpu"``,
where attention is the plain ``chunked_attention``) on the same inputs:
tokens from a numpy seed, weights drawn by the reference's ``init_params``
and carried across by ``core.convert.transformer_params_from_reference``.

Tolerances: the primitives and ``chunked_attention`` at 1e-6 (float32, the
same operations in another summation order); ``forward`` logits, caches
and ``decode_step`` over 8 steps at rtol 1e-5, atol 1e-5 (two layers of
such differences); greedy tokens and the bf16 carry-across exactly.  The
card's tests (``gpu`` marker) hold the CUDA path, where attention is K5,
against the CPU's plain path at head dims 16 (the smoke config), 64 and 128.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs import lm_harness as H
from repro_torch.core.convert import transformer_params_from_reference
from repro_torch.kernels import flash_attn as K5
from repro_torch.launch import model_serve as MS
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf

ARCH = get_arch("llama3.2-1b")
RTOL = ATOL = 1e-5


def _ref_cfg(dtype="float32"):
    """The reference's smoke config (the port's numbers, by construction)."""
    import jax.numpy as jnp

    from repro.configs import get_arch as ref_get_arch

    cfg = ref_get_arch("llama3.2-1b").smoke()
    return dataclasses.replace(cfg, dtype=getattr(jnp, dtype))


def _carried(ref_cfg, seed=0):
    """Reference params from PRNGKey(seed), and the port's copy of them."""
    import jax

    from repro.models import transformer as rtf

    params = rtf.init_params(ref_cfg, jax.random.PRNGKey(seed))
    host = jax.tree.map(np.asarray, params)
    return params, transformer_params_from_reference(host, device="cpu")


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


# ------------------------------------------------------------------ configs
def test_configs_match_the_reference():
    from repro.configs import get_arch as ref_get_arch

    ref = ref_get_arch("llama3.2-1b")
    for port_cfg, ref_cfg in ((ARCH.full(), ref.full()), (ARCH.smoke(), ref.smoke())):
        fields = {f.name for f in dataclasses.fields(ref_cfg)}
        assert fields == {f.name for f in dataclasses.fields(port_cfg)}
        for name in fields - {"dtype"}:
            assert getattr(port_cfg, name) == getattr(ref_cfg, name), name
        assert str(port_cfg.dtype).split(".")[-1] == np.dtype(ref_cfg.dtype).name
    assert ARCH.full().num_params() == ref.full().num_params() == 1_498_482_688
    assert {k: (s.kind, s.meta) for k, s in ARCH.shapes.items()} == \
        {k: (s.kind, s.meta) for k, s in ref.shapes.items()}
    with pytest.raises(KeyError, match="not ported"):
        get_arch("qwen2-72b")
    with pytest.raises(KeyError, match="unknown"):
        get_arch("gpt-17")


def test_init_params_has_the_references_tree_and_distributions():
    import jax

    from repro.models import transformer as rtf

    ref_cfg = _ref_cfg()
    ref = jax.tree.map(np.asarray, rtf.init_params(ref_cfg, jax.random.PRNGKey(0)))
    cfg = dataclasses.replace(ARCH.smoke(), qkv_bias=True)
    got = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref_b = jax.tree.map(np.asarray, rtf.init_params(dataclasses.replace(ref_cfg, qkv_bias=True),
                                                     jax.random.PRNGKey(0)))

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in tree.items()}

    assert shapes(got) == shapes(ref_b)
    assert set(ref["layers"]) < set(got["layers"])  # the biases come with qkv_bias only
    assert not got["layers"]["bq"].any()
    # norm weights are N(0, 1) draws, matrices N(0, 1/fan_in), as the reference's
    big = dataclasses.replace(ARCH.smoke(), d_model=256, d_ff=512, num_layers=4)
    p = tf.init_params(big, torch.Generator().manual_seed(1), device="cpu")
    assert abs(float(p["layers"]["attn_norm"].std()) - 1.0) < 0.1
    assert abs(float(p["embed"].std()) - 1.0) < 0.05
    assert abs(float(p["layers"]["wg"].std()) * 256**0.5 - 1.0) < 0.05
    assert abs(float(p["layers"]["wo_mlp"].std()) * 512**0.5 - 1.0) < 0.05
    with pytest.raises(NotImplementedError):
        tf.init_params(dataclasses.replace(cfg, attention="mla"), None, device="cpu")
    with pytest.raises(NotImplementedError):
        tf.init_params(dataclasses.replace(cfg, moe=True), None, device="cpu")


def test_bf16_carry_across_is_bit_exact():
    _, port = _carried(_ref_cfg("bfloat16"), seed=3)
    import jax

    from repro.models import transformer as rtf

    ref = rtf.init_params(_ref_cfg("bfloat16"), jax.random.PRNGKey(3))
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    assert len(flat_ref) == len(list(tf._leaves(port)))
    for path, leaf in flat_ref:
        x = port
        for key in path:
            x = x[key.key]
        assert x.dtype == torch.bfloat16
        np.testing.assert_array_equal(x.view(torch.int16).numpy().view(np.uint16),
                                      np.asarray(leaf).view(np.uint16))


# --------------------------------------------------------------- primitives
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_primitives_match_the_reference(dtype):
    """rms_norm, apply_rope and swiglu with the reference's promotions: in
    bfloat16 the float32 intermediates are cast back where the reference
    casts them, so rms_norm and apply_rope land on the reference's bf16
    values exactly.  swiglu's silu is ``x * sigmoid(x)`` in both, but XLA's
    bf16 logistic on the CPU and torch's sigmoid differ by a bf16 step in
    places, which the product and the matmul carry: 4e-2 there (three
    bf16 steps at the outputs' magnitude of 1 to 6)."""
    import jax.numpy as jnp

    from repro.models import common as rcm

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    g = rng.standard_normal((16,)).astype(np.float32)
    w = [rng.standard_normal(s).astype(np.float32) * 0.3 for s in ((16, 24), (16, 24), (24, 16))]
    pos = rng.integers(0, 500, size=(2, 1, 5))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    exact = dtype == "bfloat16"
    tol = 1e-6 if dtype == "float32" else 0.0
    J = lambda a: jnp.asarray(a, jdt)  # noqa: E731
    T = lambda a: torch.from_numpy(a).to(tdt)  # noqa: E731
    got = cm.rms_norm(T(x), T(g))
    assert got.dtype == tdt
    _close(got, rcm.rms_norm(J(x), J(g)).astype(jnp.float32), rtol=tol, atol=tol)
    got = cm.apply_rope(T(x), torch.from_numpy(pos), 5e5)
    assert got.dtype == tdt
    _close(got, rcm.apply_rope(J(x), jnp.asarray(pos), 5e5).astype(jnp.float32), rtol=tol, atol=tol)
    got = cm.swiglu(T(x), *map(T, w))
    tol = 4e-2 if exact else tol
    _close(got, rcm.swiglu(J(x), *map(J, w)).astype(jnp.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("sq,sk,causal,q_offset,valid", [
    (20, 20, True, 0, None),  # prefill, ragged against 16-blocks
    (33, 33, True, 0, None),
    (1, 40, False, 25, 26),  # decode against a cache, valid prefix
    (3, 40, True, 7, 30),
])
def test_chunked_attention_matches_the_reference(sq, sk, causal, q_offset, valid):
    import jax.numpy as jnp

    from repro.models import common as rcm

    rng = np.random.default_rng(sq * 100 + sk)
    q = rng.standard_normal((2, 4, sq, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, sk, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, sk, 16)).astype(np.float32)
    kw = dict(causal=causal, q_offset=q_offset, block_q=16, block_k=16)
    got = cm.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw,
                               kv_valid_len=None if valid is None else torch.tensor(valid))
    want = rcm.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)), **kw,
                                 kv_valid_len=None if valid is None else jnp.asarray(valid))
    _close(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ the model
def test_forward_matches_the_reference():
    """Prefill: logits and the stacked cache, and make_prefill's last row."""
    import jax.numpy as jnp

    from repro.configs import lm_harness as RH
    from repro.models import transformer as rtf

    ref_cfg = _ref_cfg()
    rparams, params = _carried(ref_cfg)
    tokens = np.random.default_rng(5).integers(0, 256, size=(2, 20))
    want_logits, want_cache, _ = rtf.forward(ref_cfg, rparams, jnp.asarray(tokens, jnp.int32))
    logits, cache, aux = tf.forward(ARCH.smoke(), params, torch.from_numpy(tokens))
    _close(logits, want_logits)
    for got, want in zip(cache, want_cache):
        assert tuple(got.shape) == want.shape == (2, 2, 2, 20, 16)
        _close(got, want)
    assert float(aux) == 0.0
    last, _ = H.make_prefill(ARCH.smoke())(params, torch.from_numpy(tokens))
    want_last, _ = RH.make_prefill(ref_cfg)(rparams, jnp.asarray(tokens, jnp.int32))
    _close(last, want_last)


def test_decode_steps_match_the_reference():
    """Eight decode steps from an empty cache: logits of every step and the
    final cache (the port's, updated in place)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import lm_harness as RH
    from repro.models import transformer as rtf

    ref_cfg = _ref_cfg()
    rparams, params = _carried(ref_cfg, seed=1)
    cfg = ARCH.smoke()
    tokens = np.random.default_rng(6).integers(0, 256, size=(8, 3))
    rstep = jax.jit(RH.make_decode(ref_cfg))
    step = H.make_decode(cfg)
    rcache = rtf.init_cache(ref_cfg, 3, 10)
    cache = tf.init_cache(cfg, 3, 10, device="cpu")
    for t in range(8):
        pos = np.full((3,), t)
        want, rcache = rstep(rparams, rcache, jnp.asarray(tokens[t], jnp.int32), jnp.asarray(pos, jnp.int32))
        got, cache2 = step(params, cache, torch.from_numpy(tokens[t]), torch.from_numpy(pos))
        assert cache2 is cache
        _close(got, want)
    for got, want in zip(cache, rcache):
        _close(got, want)


def test_decode_uses_one_valid_length_for_the_batch():
    """Rows at different positions: both packages mask every row's cache at
    pos[0] + 1 (ROADMAP Queue 3), and agree."""
    import jax.numpy as jnp

    from repro.models import transformer as rtf

    ref_cfg = _ref_cfg()
    rparams, params = _carried(ref_cfg, seed=2)
    rng = np.random.default_rng(7)
    cache_np = [rng.standard_normal((2, 2, 2, 12, 16)).astype(np.float32) for _ in range(2)]
    tokens, pos = np.array([5, 9]), np.array([3, 8])
    want, _ = rtf.decode_step(ref_cfg, rparams, tuple(jnp.asarray(c) for c in cache_np),
                              jnp.asarray(tokens, jnp.int32), jnp.asarray(pos, jnp.int32))
    got, _ = tf.decode_step(ARCH.smoke(), params, tuple(torch.from_numpy(c.copy()) for c in cache_np),
                            torch.from_numpy(tokens), torch.from_numpy(pos))
    _close(got, want)


def test_attention_takes_only_its_two_forms():
    cfg = ARCH.smoke()
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    cache = tf.init_cache(cfg, 2, 6, device="cpu")
    with pytest.raises(ValueError):  # two tokens against a cache
        tf.forward(cfg, params, torch.zeros((2, 2), dtype=torch.long), cache=cache,
                   positions=torch.zeros((2, 2), dtype=torch.long))
    with pytest.raises(ValueError):  # a position past the cache
        tf.decode_step(cfg, params, cache, torch.zeros(2, dtype=torch.long), torch.full((2,), 6))
    with pytest.raises(ValueError):
        tf._attention(cfg, {k: v[0] for k, v in params["layers"].items()}, torch.zeros(2, 1, 64),
                      torch.zeros((2, 1), dtype=torch.long), cache=(cache[0][0], cache[1][0]))


# ------------------------------------------------------------------ serving
def test_serve_loop_gives_the_references_greedy_tokens():
    """The reference's loop (``model_serve.py`` ``lm_serve``, prompt fed
    through decode steps, then greedy argmax) on the same weights and
    prompts: the same tokens."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as rtf

    ref_cfg = _ref_cfg()
    rparams, params = _carried(ref_cfg)
    batch, prompt_len, gen = 4, 16, 8
    prompts = np.random.default_rng(0).integers(0, 256, (batch, prompt_len))
    decode = jax.jit(lambda p, c, t, pos: rtf.decode_step(ref_cfg, p, c, t, pos))
    cache = rtf.init_cache(ref_cfg, batch, prompt_len + gen)
    tok, want = jnp.asarray(prompts[:, 0], jnp.int32), []
    for t in range(prompt_len + gen - 1):
        logits, cache = decode(rparams, cache, tok, jnp.full((batch,), t, jnp.int32))
        if t + 1 < prompt_len:
            tok = jnp.asarray(prompts[:, t + 1], jnp.int32)
        else:
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            want.append(np.asarray(tok))
    got = MS.decode_loop(ARCH.smoke(), params, torch.from_numpy(prompts), gen)
    np.testing.assert_array_equal(got.numpy(), np.stack(want, axis=1))


def test_lm_serve_runs_the_cli_defaults_on_the_cpu(capsys):
    out = MS.lm_serve(ARCH, 4, 16, 8, device="cpu")
    assert out["tokens"].shape == (4, 8) and out["tokens_per_s"] > 0
    assert "served 4 seqs" in capsys.readouterr().out
    MS.main(["--arch", "llama3.2-1b", "--batch", "2", "--prompt-len", "3", "--gen", "2",
             "--device", "cpu"])


# ---------------------------------------------------------------- on the card
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K5 has no CPU mode")


def _cuda_cfg(name, dtype):
    """The configs K5 runs on the card in this test: the smoke config itself
    (head dim 16), and variants at head dims 64 and 128."""
    smoke = dataclasses.replace(ARCH.smoke(), dtype=dtype)
    if name == "smoke":
        return smoke
    if name == "d64":
        return dataclasses.replace(smoke, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512)
    return dataclasses.replace(smoke, d_model=256, num_heads=4, num_kv_heads=2, head_dim=128, d_ff=512)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg_name", ["smoke", "d64", "d128"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_forward_and_decode_match_the_plain_path(dtype, cfg_name):
    """The card's path (K5 for prefill and decode) against the CPU's
    (chunked_attention) on the same weights, at head dims 16 (the smoke
    config), 64 and 128: logits at 2e-5 relative in float32 (TF32 off) and
    at 5e-2 in bfloat16.  At D = 128 the scale 128**-0.5 is no power of two:
    chunked_attention rounds q * scale to bfloat16 where K5 scales the
    float32 scores, so in bfloat16 the two paths also differ by that
    rounding of q, which the bfloat16 limit holds (in float32 both scale in
    float32)."""
    _need_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _cuda_cfg(cfg_name, dtype)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    dparams = {k: ({n: a.cuda() for n, a in v.items()} if isinstance(v, dict) else v.cuda())
               for k, v in params.items()}
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, 256, size=(2, 70)))
    tol = 2e-5 if dtype == torch.float32 else 5e-2
    n = K5.LAUNCHES
    got, gcache, _ = tf.forward(cfg, dparams, tokens.cuda())
    assert K5.LAUNCHES == n + cfg.num_layers
    want, wcache, _ = tf.forward(cfg, params, tokens)
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float().cpu() / scale, want.float() / scale, atol=tol, rtol=0)
    cache = tuple(torch.zeros((cfg.num_layers, 2, cfg.num_kv_heads, 80, cfg.head_dim), dtype=dtype)
                  for _ in range(2))
    for c, w in zip(cache, wcache):
        c[:, :, :, :70] = w
    dcache = tuple(c.cuda() for c in cache)
    for t in range(70, 74):
        tok = torch.full((2,), t % 256)
        pos = torch.full((2,), t)
        n = K5.LAUNCHES
        got, _ = tf.decode_step(cfg, dparams, dcache, tok.cuda(), pos.cuda())
        assert K5.LAUNCHES == n + cfg.num_layers
        want, _ = tf.decode_step(cfg, params, cache, tok, pos)
        torch.testing.assert_close(got.float().cpu() / scale, want.float() / scale, atol=tol, rtol=0)
