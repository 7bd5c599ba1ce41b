"""Decoder-only transformer: the dense GQA architectures (llama3.2-1b).

The port of ``repro/models/transformer.py`` for one device.  Parameters are
a dict of tensors with the reference's nesting and names, layers stacked
``[L, ...]``; :func:`forward` walks the layers in a Python loop, which
computes what the reference's ``lax.scan`` (and its ``remat``) computes.
The config keeps every field of the reference's so configs read the same;
MLA and MoE raise ``NotImplementedError`` until their slices are ported.

Attention (:func:`_attention`) takes one of two forms, as the reference's
single-device path does: a causal prefill with no cache (Sq == Sk, queries
from position 0) and a one-token decode against the cache prefix
``[:pos[0] + 1]``, one valid length for the whole batch.  On a CUDA device
both run the hand-written kernel K5 (``kernels/flash_attn.py``), the decode
on a strided view of the cache; on the CPU they run
:func:`common.chunked_attention` with the reference's arguments.  The decode
writes the new key and value into the cache in place (the reference builds
a new cache each step; at a 32k context a second copy would not fit).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.engine import resolve_device
from repro_torch.kernels import flash_attn as fa
from repro_torch.models import common as cm

Tensor = torch.Tensor

NOT_PORTED = "not ported yet (ROADMAP Queue 1 item 9)"


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
    num_experts_padded: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    d_ff_shared: int = 0
    dense_residual: bool = False
    capacity_factor: float = 1.25
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16
    # the reference's XLA compile knobs: a Python loop over the layers
    # computes the same function either way
    remat: bool = True
    scan_layers: bool = True
    # chunked_attention's blocks (the CPU path)
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


def _leaves(tree):
    if isinstance(tree, dict):
        for x in tree.values():
            yield from _leaves(x)
    else:
        yield tree


def _check_supported(cfg: TransformerConfig) -> None:
    if cfg.attention != "gqa":
        raise NotImplementedError(f"{cfg.name}: attention={cfg.attention!r} is {NOT_PORTED}")
    if cfg.moe:
        raise NotImplementedError(f"{cfg.name}: the MoE FFN is {NOT_PORTED}")


# ------------------------------------------------------------------- params
def init_params(cfg: TransformerConfig, generator: torch.Generator | None, device=None) -> dict:
    """The reference's parameter tree (same names, shapes and
    distributions: norm weights ``N(0, 1)``, matrices ``N(0, 1/fan_in)``,
    QKV biases zero) drawn from ``generator`` on ``device`` (default: the
    CUDA device)."""
    _check_supported(cfg)
    f = cm.ParamFactory(generator, dtype=cfg.dtype, device=device)
    p: dict = {}
    L, d = cfg.num_layers, cfg.d_model
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lay: dict = {}
    f.param(lay, "attn_norm", (L, d), scale=1.0)
    f.param(lay, "wq", (L, d, hq * dh))
    f.param(lay, "wk", (L, d, hkv * dh))
    f.param(lay, "wv", (L, d, hkv * dh))
    f.param(lay, "wo", (L, hq * dh, d))
    if cfg.qkv_bias:
        f.param(lay, "bq", (L, hq * dh), zeros=True)
        f.param(lay, "bk", (L, hkv * dh), zeros=True)
        f.param(lay, "bv", (L, hkv * dh), zeros=True)
    f.param(lay, "mlp_norm", (L, d), scale=1.0)
    f.param(lay, "wg", (L, d, cfg.d_ff))
    f.param(lay, "wi", (L, d, cfg.d_ff))
    f.param(lay, "wo_mlp", (L, cfg.d_ff, d))
    p["layers"] = lay
    f.param(p, "embed", (cfg.vocab_size, d), scale=1.0)
    f.param(p, "final_norm", (d,), scale=1.0)
    f.param(p, "lm_head", (d, cfg.vocab_size))
    return p


# ------------------------------------------------------------------ attention
def _attention(cfg: TransformerConfig, w: dict, x: Tensor, positions: Tensor, cache=None,
               kv_len: int | None = None):
    """Returns (attn_out [B, S, d], new_cache_entry).  ``cache`` is this
    layer's ``(ck, cv)`` [B, Hkv, Smax, dh] for a decode step, whose
    ``kv_len`` is ``pos[0] + 1``."""
    b, sq, d = x.shape
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
    dev = x.device.type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"the transformer runs on cuda or cpu, not {x.device}")
    if cache is None:
        if dev == "cuda":
            out = fa.flash_attention(q, k, v, causal=True)
        else:
            out = cm.chunked_attention(q, k, v, causal=True,
                                       block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
        new_cache = (k, v)
    else:
        if sq != 1 or kv_len is None:
            raise ValueError(f"a decode step takes one token per row and its kv_len; got S={sq}, "
                             f"kv_len={kv_len}")
        ck, cv = cache  # [B, Hkv, Smax, dh]
        pos = positions[:, 0]  # decode: one token per row
        _cache_insert_(ck, k, pos)
        _cache_insert_(cv, v, pos)
        if dev == "cuda":
            # K5 over the valid prefix (a strided view): the reference's
            # kv_valid_len = pos[0] + 1, one length for every row
            out = fa.flash_attention(q, ck[:, :, :kv_len], cv[:, :, :kv_len], causal=False)
        else:
            out = cm.chunked_attention(q, ck, cv, causal=False, q_offset=pos,
                                       kv_valid_len=pos[0] + 1,
                                       block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
        new_cache = (ck, cv)
    out = out.transpose(1, 2).reshape(b, sq, hq * dh)
    return out @ w["wo"], new_cache


def _cache_insert_(cache: Tensor, new: Tensor, pos: Tensor) -> None:
    """cache [B, H, Smax, D] ← new [B, H, 1, D] at per-row position pos,
    in place."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, :, pos] = new[:, :, 0].to(cache.dtype)


# ---------------------------------------------------------------------- MLP
def _mlp(cfg: TransformerConfig, w: dict, x: Tensor) -> Tensor:
    return cm.swiglu(x, w["wg"], w["wi"], w["wo_mlp"])


# ------------------------------------------------------------------- forward
def forward(
    cfg: TransformerConfig,
    params: dict,
    tokens: Tensor,  # int [B, S]
    *,
    cache: Any = None,  # stacked per-layer cache (decode) or None
    positions: Tensor | None = None,  # [B, S] absolute positions
):
    """Returns (logits [B, S, vocab], new_cache, aux_loss).  A decode call
    (``cache`` given) updates ``cache`` in place and returns it.  The dense
    FFN has no load-balancing loss: ``aux_loss`` is zero, as the
    reference's is for a dense config."""
    _check_supported(cfg)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    kv_len = None
    if cache is not None:
        smax = cache[0].shape[3]
        pos = positions[:, 0].cpu()
        if s != 1 or bool(((pos < 0) | (pos >= smax)).any()):
            raise ValueError(f"decode takes one token per row at positions in [0, {smax}); "
                             f"got S={s}, positions {pos.tolist()}")
        kv_len = int(pos[0]) + 1
    x = params["embed"][tokens].to(cfg.dtype)
    lay = params["layers"]
    keys, values = [], []
    for i in range(cfg.num_layers):
        w = {name: a[i] for name, a in lay.items()}
        cache_l = None if cache is None else (cache[0][i], cache[1][i])
        attn_out, (k_l, v_l) = _attention(cfg, w, cm.rms_norm(x, w["attn_norm"]), positions,
                                          cache_l, kv_len)
        x = x + attn_out
        x = x + _mlp(cfg, w, cm.rms_norm(x, w["mlp_norm"]))
        if cache is None:
            keys.append(k_l)
            values.append(v_l)
    new_cache = cache if cache is not None else (torch.stack(keys), torch.stack(values))
    x = cm.rms_norm(x, params["final_norm"])
    logits = x @ params["lm_head"]
    return logits, new_cache, torch.zeros((), dtype=torch.float32, device=x.device)


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int, device=None):
    """Stacked decode cache (zeros) [L, B, Hkv, max_seq, dh] for keys and
    values on ``device`` (default: the CUDA device)."""
    _check_supported(cfg)
    device = resolve_device(device)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_seq, cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


def decode_step(cfg: TransformerConfig, params: dict, cache, tokens: Tensor, pos: Tensor):
    """One-token decode: tokens [B], pos [B] → (logits [B, vocab], cache),
    the cache updated in place."""
    logits, new_cache, _ = forward(cfg, params, tokens[:, None], cache=cache,
                                   positions=pos[:, None])
    return logits[:, 0], new_cache
