"""Decoder-only transformer family: GQA (with optional QKV bias), MLA, and
the MoE FFN with shared experts or a dense residual.

The port of ``repro/models/transformer.py``.  Parameters are
a dict of tensors with the reference's nesting and names, layers stacked
``[L, ...]``; :func:`forward` walks the layers in a Python loop, which
computes what the reference's ``lax.scan`` computes.  The config keeps
every field of the reference's so configs read the same.

Training: :func:`loss_fn` is the reference's (token cross-entropy plus 0.01
x the MoE aux loss) over ``forward(..., keep_cache=False)``, which keeps no
per-layer keys and values and, with ``cfg.remat`` under grad mode, runs
each layer under ``torch.utils.checkpoint`` (non-reentrant), the
reference's ``jax.checkpoint``: the backward pass recomputes the layer
from its input.  ``configs/lm_harness.make_train_step`` takes the
gradients and the AdamW step.

Under a mesh with a ``model`` axis (``common.activation_mesh``), a decode
step's attention is the reference's distributed log-sum-exp one, exactly
where the reference branches: ``common.dlse_decode_attention`` for GQA,
``common.dlse_mla_decode_attention`` for MLA, the cache split over
``model`` along its sequence as :func:`cache_specs` lays it out (on an
emulated mesh the blocks are views of the one cache, so the in-place
insert below writes them).  :func:`param_specs` and :func:`cache_specs`
give the reference's logical axes by the tree's names, for
``runtime/mesh_rules``.

Attention (:func:`_attention`) takes one of two forms, as the reference's
single-device path does: a causal prefill with no cache (Sq == Sk, queries
from position 0) and a one-token decode against the cache prefix
``[:pos[0] + 1]``, one valid length for the whole batch.  GQA on a CUDA
device runs the hand-written kernel K5 (``kernels/flash_attn.py``), the
decode on a strided view of the cache, on q scaled by ``D**-0.5`` in q's
dtype first, as the reference's attention scales it; under grad mode the
prefill's call goes through ``flash_attention.FlashAttention``, K5 forward
with a plain PyTorch backward (the reference's kernel has none), so a
recomputed layer launches K5 once more; on the CPU it runs
:func:`common.chunked_attention` with the reference's arguments.  MLA
(keys of nope + rope dims, values of another) runs ``chunked_attention`` on
either device, as the reference does; its decode expands only the valid
prefix of the latent cache, since keys past the valid length add exactly
zero.  A decode writes the new key and value (MLA: the new latents) into
the cache in place (the reference builds a new cache each step; at a 32k
context a second copy would not fit).

:func:`forward` runs each layer's attention and MLP under profiler ranges
(``attention``, ``mlp``; :func:`common.profile_range`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.engine import resolve_device
from repro_torch.kernels import flash_attn as fa
from repro_torch.models import common as cm
from repro_torch.models.moe import moe_ffn

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    attention: str = "gqa"  # gqa | mla
    qkv_bias: bool = False
    # MLA dims (minicpm3)
    q_rank: int = 0
    kv_rank: int = 0
    nope_dim: int = 0
    rope_dim: int = 0
    v_head_dim: int = 0
    # MoE
    moe: bool = False
    num_experts: int = 0
    num_experts_padded: int = 0  # padded expert arrays; the router masks the pad
    top_k: int = 0
    d_ff_expert: int = 0
    d_ff_shared: int = 0  # qwen2-moe's shared experts (0 = none)
    dense_residual: bool = False  # arctic: dense FFN ∥ MoE
    capacity_factor: float = 1.25
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16
    # remat: each layer checkpointed in training (forward(keep_cache=False));
    # scan_layers is the reference's XLA compile knob: a Python loop over
    # the layers computes the same function either way
    remat: bool = True
    scan_layers: bool = True
    # chunked_attention's blocks (GQA on the CPU; MLA everywhere)
    attn_block_q: int = 512
    attn_block_k: int = 1024

    @property
    def qk_dim(self) -> int:
        return self.nope_dim + self.rope_dim if self.attention == "mla" else self.head_dim

    @property
    def v_dim(self) -> int:
        return self.v_head_dim if self.attention == "mla" else self.head_dim

    def num_params(self) -> int:
        params = init_params(self, None, device="meta")
        return sum(x.numel() for x in _leaves(params))

    def num_active_params(self) -> int:
        """Parameters a token activates (MoE: its top-k routed experts only)."""
        n = self.num_params()
        if not self.moe:
            return n
        per_expert = 3 * self.d_model * self.d_ff_expert
        return n - (self.num_experts - self.top_k) * per_expert * self.num_layers


def _leaves(tree):
    if isinstance(tree, dict):
        for x in tree.values():
            yield from _leaves(x)
    else:
        yield tree


# ------------------------------------------------------------------- params
def init_params(cfg: TransformerConfig, generator: torch.Generator | None, device=None) -> dict:
    """The reference's parameter tree (same names, shapes and
    distributions: norm weights ``N(0, 1)``, matrices ``N(0, 1/fan_in)``,
    QKV biases and the shared-expert gate zero) drawn from ``generator``
    on ``device`` (default: the CUDA device)."""
    f = cm.ParamFactory(generator, dtype=cfg.dtype, device=device)
    p: dict = {}
    L, d = cfg.num_layers, cfg.d_model
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lay: dict = {}
    f.param(lay, "attn_norm", (L, d), scale=1.0)
    if cfg.attention == "gqa":
        f.param(lay, "wq", (L, d, hq * dh))
        f.param(lay, "wk", (L, d, hkv * dh))
        f.param(lay, "wv", (L, d, hkv * dh))
        f.param(lay, "wo", (L, hq * dh, d))
        if cfg.qkv_bias:
            f.param(lay, "bq", (L, hq * dh), zeros=True)
            f.param(lay, "bk", (L, hkv * dh), zeros=True)
            f.param(lay, "bv", (L, hkv * dh), zeros=True)
    else:  # mla
        qk, vd = cfg.nope_dim + cfg.rope_dim, cfg.v_head_dim
        f.param(lay, "wdq", (L, d, cfg.q_rank))
        f.param(lay, "q_norm", (L, cfg.q_rank), scale=1.0)
        f.param(lay, "wuq", (L, cfg.q_rank, hq * qk))
        f.param(lay, "wdkv", (L, d, cfg.kv_rank + cfg.rope_dim))
        f.param(lay, "kv_norm", (L, cfg.kv_rank), scale=1.0)
        f.param(lay, "wuk", (L, cfg.kv_rank, hq * cfg.nope_dim))
        f.param(lay, "wuv", (L, cfg.kv_rank, hq * vd))
        f.param(lay, "wo", (L, hq * vd, d))
    f.param(lay, "mlp_norm", (L, d), scale=1.0)
    if cfg.moe:
        e, fe = cfg.num_experts_padded or cfg.num_experts, cfg.d_ff_expert
        f.param(lay, "router", (L, d, e))
        f.param(lay, "we_g", (L, e, d, fe))
        f.param(lay, "we_i", (L, e, d, fe))
        f.param(lay, "we_o", (L, e, fe, d))
        if cfg.d_ff_shared:
            f.param(lay, "ws_g", (L, d, cfg.d_ff_shared))
            f.param(lay, "ws_i", (L, d, cfg.d_ff_shared))
            f.param(lay, "ws_o", (L, cfg.d_ff_shared, d))
            f.param(lay, "shared_gate", (L, d), zeros=True)
    if (not cfg.moe) or cfg.dense_residual:
        f.param(lay, "wg", (L, d, cfg.d_ff))
        f.param(lay, "wi", (L, d, cfg.d_ff))
        f.param(lay, "wo_mlp", (L, cfg.d_ff, d))
    p["layers"] = lay
    f.param(p, "embed", (cfg.vocab_size, d), scale=1.0)
    f.param(p, "final_norm", (d,), scale=1.0)
    f.param(p, "lm_head", (d, cfg.vocab_size))
    return p


# the reference's logical axes of each parameter, by its name in the tree
_PARAM_AXES = {
    "attn_norm": ("layers", "embed"), "mlp_norm": ("layers", "embed"),
    "wq": ("layers", "embed", "heads"), "wk": ("layers", "embed", "heads"),
    "wv": ("layers", "embed", "heads"), "wo": ("layers", "heads", "embed"),
    "bq": ("layers", "heads"), "bk": ("layers", "heads"), "bv": ("layers", "heads"),
    "wdq": ("layers", "embed", "mlp"), "q_norm": ("layers", "mlp"), "wuq": ("layers", "mlp", "heads"),
    "wdkv": ("layers", "embed", "mlp"), "kv_norm": ("layers", "mlp"),
    "wuk": ("layers", "mlp", "heads"), "wuv": ("layers", "mlp", "heads"),
    "router": ("layers", "embed", "experts"),
    "we_g": ("layers", "experts", "embed", "mlp"), "we_i": ("layers", "experts", "embed", "mlp"),
    "we_o": ("layers", "experts", "mlp", "embed"),
    "ws_g": ("layers", "embed", "mlp"), "ws_i": ("layers", "embed", "mlp"),
    "ws_o": ("layers", "mlp", "embed"), "shared_gate": ("layers", "embed"),
    "wg": ("layers", "embed", "mlp"), "wi": ("layers", "embed", "mlp"), "wo_mlp": ("layers", "mlp", "embed"),
    "embed": ("vocab", "embed"), "final_norm": ("embed",), "lm_head": ("embed", "vocab"),
}


def param_specs(cfg: TransformerConfig) -> dict:
    """Logical-axis tree matching :func:`init_params`' structure (no
    allocation): the reference's ``param_specs``."""
    shaped = init_params(cfg, None, device="meta")
    return {"layers": {k: _PARAM_AXES[k] for k in shaped["layers"]},
            **{k: _PARAM_AXES[k] for k in shaped if k != "layers"}}


# ------------------------------------------------------------------ attention
def _attention(cfg: TransformerConfig, w: dict, x: Tensor, positions: Tensor, cache=None,
               kv_len: int | None = None):
    """Returns (attn_out [B, S, d], new_cache_entry).  ``cache`` is this
    layer's entry for a decode step, whose ``kv_len`` is ``pos[0] + 1``:
    ``(ck, cv)`` [B, Hkv, Smax, dh] for GQA, the latents ``(ckv, krope)``
    [B, Smax, kv_rank], [B, Smax, rope_dim] for MLA."""
    b, sq, d = x.shape
    dev = x.device.type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"the transformer runs on cuda or cpu, not {x.device}")
    if cache is not None and (sq != 1 or kv_len is None):
        raise ValueError(f"a decode step takes one token per row and its kv_len; got S={sq}, "
                         f"kv_len={kv_len}")
    if cfg.attention == "mla":
        return _mla_attention(cfg, w, x, positions, cache, kv_len)
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ w["wq"]
    k = x @ w["wk"]
    v = x @ w["wv"]
    if cfg.qkv_bias:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q = q.reshape(b, sq, hq, dh).transpose(1, 2)
    k = k.reshape(b, sq, hkv, dh).transpose(1, 2)
    v = v.reshape(b, sq, hkv, dh).transpose(1, 2)
    q = cm.apply_rope(q, positions[:, None, :], cfg.rope_theta)
    k = cm.apply_rope(k, positions[:, None, :], cfg.rope_theta)
    if dev == "cuda":
        # q scaled in its own dtype, as the reference's chunked_attention
        # does (repro/models/common.py), and K5 told not to scale again
        qs = q * dh**-0.5
    if cache is None:
        if dev == "cuda":
            out = fa.flash_attention(qs, k, v, causal=True, scale=1.0)
        else:
            out = cm.chunked_attention(q, k, v, causal=True,
                                       block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
        new_cache = (k, v)
    else:
        ck, cv = cache  # [B, Hkv, Smax, dh]
        pos = positions[:, 0]  # decode: one token per row
        _cache_insert_(ck, k, pos)
        _cache_insert_(cv, v, pos)
        if cm.model_mesh() is not None:
            # the cache split over the model axis along its sequence; only
            # [B, Hq, D] softmax statistics cross between shards
            out = cm.dlse_decode_attention(q, ck, cv, kv_len)
        elif dev == "cuda":
            # K5 over the valid prefix (a strided view): the reference's
            # kv_valid_len = pos[0] + 1, one length for every row
            out = fa.flash_attention(qs, ck[:, :, :kv_len], cv[:, :, :kv_len], causal=False,
                                     scale=1.0)
        else:
            out = cm.chunked_attention(q, ck, cv, causal=False, q_offset=pos,
                                       kv_valid_len=pos[0] + 1,
                                       block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
        new_cache = (ck, cv)
    out = out.transpose(1, 2).reshape(b, sq, hq * dh)
    return out @ w["wo"], new_cache


def _mla_attention(cfg: TransformerConfig, w: dict, x: Tensor, positions: Tensor, cache,
                   kv_len: int | None):
    """MLA (minicpm3): queries through the q latent, keys and values
    expanded from the compressed KV latent, one rope key shared across
    heads.  A decode expands the cache's valid prefix ``[:kv_len]`` only;
    the reference expands all of it and masks the rest, whose keys add
    exactly zero to every row's softmax."""
    b, sq, _ = x.shape
    hq = cfg.num_heads
    qk, vd, nd, kvr = cfg.qk_dim, cfg.v_head_dim, cfg.nope_dim, cfg.kv_rank
    cq = cm.rms_norm(x @ w["wdq"], w["q_norm"])
    q = (cq @ w["wuq"]).reshape(b, sq, hq, qk).transpose(1, 2)
    q_rope = cm.apply_rope(q[..., nd:], positions[:, None, :], cfg.rope_theta)
    q = torch.cat([q[..., :nd], q_rope], dim=-1)

    kv_low = x @ w["wdkv"]  # [B, S, kvr + rd]
    ckv_new = cm.rms_norm(kv_low[..., :kvr], w["kv_norm"])
    krope_new = cm.apply_rope(kv_low[..., None, kvr:].transpose(1, 2), positions[:, None, :],
                              cfg.rope_theta)[:, 0]  # [B, S, rd], shared across heads
    if cache is None:
        ckv, krope = ckv_new, krope_new
        new_cache = (ckv_new, krope_new)
    else:
        ckv_c, krope_c = cache  # [B, Smax, kvr], [B, Smax, rd]
        pos = positions[:, 0]
        _cache_insert_seq_(ckv_c, ckv_new, pos)
        _cache_insert_seq_(krope_c, krope_new, pos)
        new_cache = (ckv_c, krope_c)
        if cm.model_mesh() is not None:
            # each model shard expands only its own block of the latents
            out = cm.dlse_mla_decode_attention(q, ckv_c, krope_c, w["wuk"], w["wuv"], kv_len,
                                               nope_dim=nd, v_dim=vd)
            return out.transpose(1, 2).reshape(b, sq, hq * vd) @ w["wo"], new_cache
        ckv, krope = ckv_c[:, :kv_len], krope_c[:, :kv_len]
    sk = ckv.shape[1]
    k_nope = (ckv @ w["wuk"]).reshape(b, sk, hq, nd).transpose(1, 2)
    v = (ckv @ w["wuv"]).reshape(b, sk, hq, vd).transpose(1, 2)
    k = torch.cat([k_nope, krope[:, None].expand(b, hq, sk, cfg.rope_dim)], dim=-1)
    out = cm.chunked_attention(
        q, k, v, causal=cache is None,
        q_offset=positions[:, 0] if cache is not None else 0,
        kv_valid_len=kv_len,
        block_q=cfg.attn_block_q, block_k=cfg.attn_block_k,
    )
    out = out.transpose(1, 2).reshape(b, sq, hq * vd)
    return out @ w["wo"], new_cache


def _cache_insert_(cache: Tensor, new: Tensor, pos: Tensor) -> None:
    """cache [B, H, Smax, D] ← new [B, H, 1, D] at per-row position pos,
    in place."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, :, pos] = new[:, :, 0].to(cache.dtype)


def _cache_insert_seq_(cache: Tensor, new: Tensor, pos: Tensor) -> None:
    """cache [B, Smax, D] ← new [B, 1, D] at per-row position pos, in
    place."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, pos] = new[:, 0].to(cache.dtype)


# ---------------------------------------------------------------------- MLP
def _mlp(cfg: TransformerConfig, w: dict, x: Tensor) -> tuple[Tensor, Tensor]:
    """Returns (out, aux): the MoE FFN (plus the shared expert under its
    sigmoid gate) and/or the dense SwiGLU, and the MoE's aux loss (zero
    for a dense layer)."""
    b, s, d = x.shape
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    out = None
    if cfg.moe:
        moe_out, aux = moe_ffn(
            x.reshape(b * s, d), w["router"], w["we_g"], w["we_i"], w["we_o"],
            top_k=cfg.top_k, capacity_factor=cfg.capacity_factor, num_experts=cfg.num_experts,
        )
        out = moe_out.reshape(b, s, d)
        if cfg.d_ff_shared:
            shared = cm.swiglu(x, w["ws_g"], w["ws_i"], w["ws_o"])
            gate = torch.sigmoid((x * w["shared_gate"]).sum(dim=-1, keepdim=True))
            out = out + gate.to(x.dtype) * shared
    if (not cfg.moe) or cfg.dense_residual:
        dense = cm.swiglu(x, w["wg"], w["wi"], w["wo_mlp"])
        out = dense if out is None else out + dense
    return out, aux


# ------------------------------------------------------------------- forward
def cache_seq_axis(cfg: TransformerConfig) -> int:
    """The position axis of :func:`init_cache`'s stacked tensors: 3 for
    GQA's [L, B, Hkv, Smax, dh], 2 for MLA's latents [L, B, Smax, r]."""
    return 3 if cfg.attention == "gqa" else 2


def forward(
    cfg: TransformerConfig,
    params: dict,
    tokens: Tensor,  # int [B, S]
    *,
    cache: Any = None,  # stacked per-layer cache (decode) or None
    positions: Tensor | None = None,  # [B, S] absolute positions
    keep_cache: bool = True,
):
    """Returns (logits [B, S, vocab], new_cache, aux_loss): the MoE layers'
    aux losses summed (zero for a dense config).  A decode call (``cache``
    given) updates ``cache`` in place and returns it.

    ``keep_cache=False`` (training's :func:`loss_fn`) keeps no per-layer
    keys and values and returns ``None`` for the cache; then, with
    ``cfg.remat`` under grad mode, each layer runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``): its
    activations are recomputed in the backward pass, only its input kept."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    kv_len = None
    if cache is not None:
        smax = cache[0].shape[cache_seq_axis(cfg)]
        pos = positions[:, 0].cpu()
        if s != 1 or bool(((pos < 0) | (pos >= smax)).any()):
            raise ValueError(f"decode takes one token per row at positions in [0, {smax}); "
                             f"got S={s}, positions {pos.tolist()}")
        kv_len = int(pos[0]) + 1
    remat = cache is None and not keep_cache and cfg.remat and torch.is_grad_enabled()
    x = params["embed"][tokens].to(cfg.dtype)
    lay = params["layers"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    firsts, seconds = [], []
    for i in range(cfg.num_layers):
        w = {name: a[i] for name, a in lay.items()}
        if remat:
            # non-reentrant: the layer's parameters are read from ``w``
            x, aux_l = checkpoint(_layer_without_cache, cfg, w, x, positions, use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            cache_l = None if cache is None else (cache[0][i], cache[1][i])
            x, aux_l, (c0, c1) = _layer(cfg, w, x, positions, cache_l, kv_len)
            if cache is None and keep_cache:
                firsts.append(c0)
                seconds.append(c1)
        aux = aux + aux_l
    if cache is not None:
        new_cache = cache
    else:
        new_cache = (torch.stack(firsts), torch.stack(seconds)) if keep_cache else None
    x = cm.rms_norm(x, params["final_norm"])
    logits = x @ params["lm_head"]
    return logits, new_cache, aux


def _layer(cfg: TransformerConfig, w: dict, x: Tensor, positions: Tensor, cache_l=None,
           kv_len: int | None = None):
    """One layer: ``(x + attention + MLP, the layer's aux, its cache entry)``."""
    with cm.profile_range("attention"):
        attn_out, new_cache_l = _attention(cfg, w, cm.rms_norm(x, w["attn_norm"]), positions,
                                           cache_l, kv_len)
    x = x + attn_out
    with cm.profile_range("mlp"):
        mlp_out, aux = _mlp(cfg, w, cm.rms_norm(x, w["mlp_norm"]))
    return x + mlp_out, aux, new_cache_l


def _layer_without_cache(cfg: TransformerConfig, w: dict, x: Tensor, positions: Tensor):
    """:func:`_layer` returning only ``(x, aux)``: under remat no per-layer
    key or value outlives the layer."""
    x, aux, _ = _layer(cfg, w, x, positions)
    return x, aux


def cache_specs(cfg: TransformerConfig):
    """Logical axes of :func:`init_cache`'s two tensors (the reference's):
    the sequence (``kv_seq``) over ``model`` and the batch over ``data``,
    so a decode's attention reads only its own block of the cache."""
    if cfg.attention == "gqa":
        ax = ("layers", "batch", None, "kv_seq", None)
        return (ax, ax)
    return (("layers", "batch", "kv_seq", None), ("layers", "batch", "kv_seq", None))


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int, device=None):
    """Stacked decode cache (zeros) on ``device`` (default: the CUDA
    device): keys and values [L, B, Hkv, max_seq, dh] for GQA, the latents
    [L, B, max_seq, kv_rank] and [L, B, max_seq, rope_dim] for MLA."""
    device = resolve_device(device)
    L = cfg.num_layers
    if cfg.attention == "gqa":
        shape = (L, batch, cfg.num_kv_heads, max_seq, cfg.head_dim)
        return (torch.zeros(shape, dtype=cfg.dtype, device=device),
                torch.zeros(shape, dtype=cfg.dtype, device=device))
    return (torch.zeros((L, batch, max_seq, cfg.kv_rank), dtype=cfg.dtype, device=device),
            torch.zeros((L, batch, max_seq, cfg.rope_dim), dtype=cfg.dtype, device=device))


def decode_step(cfg: TransformerConfig, params: dict, cache, tokens: Tensor, pos: Tensor):
    """One-token decode: tokens [B], pos [B] → (logits [B, vocab], cache),
    the cache updated in place."""
    logits, new_cache, _ = forward(cfg, params, tokens[:, None], cache=cache,
                                   positions=pos[:, None])
    return logits[:, 0], new_cache


def loss_fn(cfg: TransformerConfig, params: dict, tokens: Tensor, labels: Tensor) -> Tensor:
    """Training loss: mean token cross-entropy of the logits against
    ``labels`` plus 0.01 x the MoE aux loss, the reference's."""
    logits, _, aux = forward(cfg, params, tokens, keep_cache=False)
    return cm.cross_entropy_loss(logits, labels) + 0.01 * aux
