"""Shared model primitives: norms, RoPE, activations, parameter creation and
chunked (flash-style) attention in plain PyTorch.

The port of ``repro/models/common.py``: parameters are plain dicts of
tensors, created through :class:`ParamFactory` on a ``torch.Generator``;
their logical-axis specs are written out by ``models/transformer.
param_specs``.  :func:`activation_mesh` installs a mesh around model code,
as the reference's does; under a mesh with a ``model`` axis the decode
attentions are the distributed log-sum-exp ones (:func:`dlse_decode_attention`,
:func:`dlse_mla_decode_attention`): the cache split over ``model`` along its
sequence, each shard's softmax statistics combined by the mesh's plain
collectives (``launch/mesh.pmax``/``psum``).  The reference's ``constrain``
(an XLA sharding hint) has no counterpart: the port's products are not
split over cards (ROADMAP Queue 1).  :func:`cross_entropy_loss` is the LM
training loss.

Each function promotes types as the reference does: a bfloat16 tensor times
a float32 one computes in float32, and the reference's casts back to the
input dtype stand where it puts them.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.core.engine import resolve_device

Tensor = torch.Tensor

# ------------------------------------------------------------ the active mesh
# Model code is mesh-agnostic; a caller installs the mesh around it
# (activation_mesh) and the decode attentions read it.
_ACTIVATION_MESH: list = [None]


@contextlib.contextmanager
def activation_mesh(mesh):
    """Install ``mesh`` (a ``launch/mesh.Mesh`` or ``DataMesh``) for model
    code run inside; ``None`` clears it."""
    prev = _ACTIVATION_MESH[0]
    _ACTIVATION_MESH[0] = mesh
    try:
        yield
    finally:
        _ACTIVATION_MESH[0] = prev


def model_mesh():
    """The installed mesh when it has a ``model`` axis (the decode
    attentions then split the cache over it), else ``None``."""
    mesh = _ACTIVATION_MESH[0]
    return mesh if mesh is not None and "model" in mesh.axis_names else None


class ParamFactory:
    """Creates parameters from a ``torch.Generator``: ``N(0, 1) * scale``
    drawn in float32 (``scale`` defaults to ``fan_in ** -0.5``, fan-in being
    the second-to-last axis), then cast to ``dtype``; or zeros.  ``device``
    defaults to the CUDA device; on ``meta`` the factory only shapes the
    parameters (no generator needed).

    A leaf is drawn in slices of its leading axis (a layer of a stacked
    leaf, at most :data:`DRAW_ELEMENTS` values unless one layer holds
    more), each scaled in place and written into the leaf, so the draw
    adds one slice's float32 to the finished weights, not two whole
    float32 copies of the leaf."""

    DRAW_ELEMENTS = 1 << 27  # float32 values drawn at once (512 MiB)

    def __init__(self, generator: torch.Generator | None, dtype=torch.float32, device=None) -> None:
        self.generator = generator
        self.dtype = dtype
        self.device = resolve_device(device)

    def param(self, tree: dict, name: str, shape, *, scale=None, zeros=False) -> Tensor:
        if zeros or self.device.type == "meta":
            tree[name] = torch.zeros(shape, dtype=self.dtype, device=self.device)
            return tree[name]
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        s = scale if scale is not None else fan_in**-0.5
        leaf = torch.empty(shape, dtype=self.dtype, device=self.device)
        row = leaf[0].numel() if len(shape) > 1 else 1
        step = max(1, self.DRAW_ELEMENTS // max(1, row))
        for r0 in range(0, shape[0], step):
            piece = leaf[r0 : r0 + step]
            x = torch.randn(piece.shape, generator=self.generator, dtype=torch.float32,
                            device=self.device)
            piece.copy_(x.mul_(s))
            del x  # before the next draw: one slice alive at a time
        tree[name] = leaf
        return leaf


def profile_range(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler records, else nothing (a decode step opens a few per layer,
    and the range costs host time even with no profiler on)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def rms_norm(x: Tensor, gamma: Tensor, eps: float = 1e-6) -> Tensor:
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    # x * rsqrt(var) is float32 (the reference's promotion), cast back to
    # x's dtype before the product with gamma
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def swiglu(x: Tensor, wg: Tensor, wi: Tensor, wo: Tensor) -> Tensor:
    g = x @ wg
    # jax.nn.silu is x * sigmoid(x), each rounded to x's dtype
    return (g * torch.sigmoid(g) * (x @ wi)) @ wo


# ---------------------------------------------------------------------- RoPE
def rope_freqs(dim: int, theta: float = 10000.0, device=None) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))


def apply_rope(x: Tensor, positions: Tensor, theta: float = 10000.0) -> Tensor:
    """x [..., S, D] with D even; positions [..., S].  Computed in float32
    and cast back to x's dtype."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)  # [D/2]
    angles = positions[..., None].float() * freqs  # [..., S, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., : d // 2], x[..., d // 2 :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------- chunked attention
def chunked_attention(
    q: Tensor,  # [B, Hq, Sq, D]
    k: Tensor,  # [B, Hkv, Sk, D]
    v: Tensor,  # [B, Hkv, Sk, Dv]
    *,
    causal: bool = True,
    q_offset: Tensor | int = 0,  # absolute position of q[..., 0, :]
    block_q: int = 512,
    block_k: int = 1024,
    kv_valid_len: Tensor | int | None = None,  # mask KV positions >= this (decode cache)
    scale: float | None = None,  # default D**-0.5; 1.0 for a q scaled already
) -> Tensor:
    """Flash-style online-softmax attention over blocks of queries and keys,
    the reference's block loop step for step (its ``lax.map`` and
    ``lax.scan`` become Python loops).  GQA via head grouping.

    ``q`` is scaled by ``D**-0.5`` in its own dtype before the float32
    cast, as the reference does.  The transformer's card path does the
    same before it calls K5 with ``scale=1.0``, so the two paths round q
    alike (``tests/test_torch_flash_attn.py``, the q-scale test).
    """
    b, hq, sq, d = q.shape
    hkv, sk, dv = v.shape[1], v.shape[2], v.shape[3]
    group = hq // k.shape[1]
    bq, bk = min(block_q, sq), min(block_k, sk)
    nq, nk = -(-sq // bq), -(-sk // bk)
    qpad, kpad = nq * bq - sq, nk * bk - sk
    if qpad:
        q = torch.nn.functional.pad(q, (0, 0, 0, qpad))
    if kpad:
        k = torch.nn.functional.pad(k, (0, 0, 0, kpad))
        v = torch.nn.functional.pad(v, (0, 0, 0, kpad))
    scale = d**-0.5 if scale is None else scale
    valid = kv_valid_len if kv_valid_len is not None else sk
    valid = torch.as_tensor(valid, device=q.device)
    outs = []
    for iq in range(nq):
        qb32 = (q[:, :, iq * bq : (iq + 1) * bq] * scale).float()
        qh = qb32.reshape(b, hkv, group, bq, d)  # query heads grouped onto their KV head
        m = torch.full((b, hkv, group, bq), -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, hkv, group, bq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, hkv, group, bq, dv), dtype=torch.float32, device=q.device)
        for ik in range(nk):
            kb = k[:, :, ik * bk : (ik + 1) * bk].float()  # [B, Hkv, Bk, D]
            vb = v[:, :, ik * bk : (ik + 1) * bk].float()
            s = torch.einsum("bngqd,bnkd->bngqk", qh, kb)  # [B, Hkv, G, Bq, Bk]
            cols = ik * bk + torch.arange(bk, device=q.device)
            if causal:
                rows = q_offset + iq * bq + torch.arange(bq, device=q.device)
                mask = cols[None, :] <= rows[:, None]
            else:
                mask = torch.ones((bq, bk), dtype=torch.bool, device=q.device)
            mask = mask & (cols < valid)[None, :]
            s = torch.where(mask[None, None, None], s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bngqk,bnkd->bngqd", p, vb)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.reshape(b, hq, bq, dv).to(q.dtype))
    return torch.cat(outs, dim=2)[:, :, :sq]


def _dlse_blocks(mesh, q: Tensor, cache: tuple, seq_axis: int, valid: int):
    """Per ``(pod, data)`` coordinate of ``mesh``: ``[(its q block, [(model
    coordinate's device, its cache blocks trimmed to their valid keys), ...])]``.

    ``q`` splits by batch over ``("pod", "data")`` (or ``"data"``), each
    tensor of ``cache`` by batch and over ``"model"`` along ``seq_axis``, the
    specs the reference's ``shard_map`` takes (``runtime/mesh_rules``); on an
    emulated mesh the blocks are views.  Model shard ``k``'s block holds the
    global keys ``k * S/tp ..``; keys at or past ``valid`` are cut off (a
    masked key adds exactly zero to every sum), a block with none left is
    dropped.  The cache is placed here on every call: on an emulated mesh
    that costs views, over distinct cards it would copy the cache each
    step (placing it once is ROADMAP Queue 1 work)."""
    from repro_torch.runtime import mesh_rules as mr

    batch = ("pod", "data") if "pod" in mesh.axis_names else "data"
    q_spec = [None] * q.dim()
    q_spec[0] = batch
    c_spec = [None] * cache[0].dim()
    c_spec[0], c_spec[seq_axis] = batch, "model"
    qs = mr.NamedSharding(mesh, mr.P(*q_spec)).place(q)
    cs = [mr.NamedSharding(mesh, mr.P(*c_spec)).place(c) for c in cache]
    devs = mr.grid(mesh)
    names = mesh.axis_names
    m_axis = names.index("model")
    out = []
    for coord in np.ndindex(devs.shape):
        if coord[m_axis]:
            continue
        shards = []
        for k in range(devs.shape[m_axis]):
            at = coord[:m_axis] + (k,) + coord[m_axis + 1 :]
            blocks = [c.blocks[at] for c in cs]
            s_loc = blocks[0].shape[seq_axis]
            n = max(0, min(s_loc, valid - k * s_loc))
            if n:
                shards.append((devs[at], [b.narrow(seq_axis, 0, n) for b in blocks]))
        out.append((qs.blocks[coord], shards))
    return out


def _dlse_combine(parts: list, devices, dtype, pv: str) -> Tensor:
    """``parts``: each model shard's (scores [..., s], values) in float32
    on its device, ``pv`` the einsum of probabilities and values.  One max
    and two sums over the shards (the mesh's collectives), then ``acc / l``
    in ``dtype`` on the first shard's device."""
    from repro_torch.launch import mesh as mesh_lib

    m = mesh_lib.pmax([s.amax(dim=-1) for s, _ in parts], devices)
    p = [torch.exp(s - mk[..., None]) for (s, _), mk in zip(parts, m)]
    l = mesh_lib.psum([pk.sum(dim=-1) for pk in p], devices)
    acc = mesh_lib.psum([torch.einsum(pv, pk, v) for pk, (_, v) in zip(p, parts)], devices)
    return (acc[0] / torch.clamp(l[0], min=1e-30)[..., None]).to(dtype)


def dlse_decode_attention(q: Tensor, ck: Tensor, cv: Tensor, kv_valid_len) -> Tensor:
    """Distributed log-sum-exp decode attention under the installed mesh
    (:func:`activation_mesh`; the reference's ``dlse_decode_attention``).

    ``q`` [B, Hq, 1, D] (unscaled), ``ck``/``cv`` [B, Hkv, S, D] the
    cache, split over ``model`` along S (and by batch over ``data``): each
    model shard computes its scores ``q·k * D**-0.5`` in float32 on its own
    block, at global key offset ``k * S/tp``, with keys at or past
    ``kv_valid_len`` left out; one max and two sums over ``model`` combine
    them.  Returns [B, Hq, 1, D] in q's dtype on q's device."""
    mesh = model_mesh()
    b, hq, _, d = q.shape
    hkv = ck.shape[1]
    group = hq // hkv
    valid = int(kv_valid_len)
    outs = []
    for q_l, shards in _dlse_blocks(mesh, q, (ck, cv), 2, valid):
        parts, devices = [], []
        for dev, (k_l, v_l) in shards:
            qh = q_l.to(dev).reshape(q_l.shape[0], hkv, group, d).float()
            scores = torch.einsum("bngd,bnsd->bngs", qh, k_l.float()) * (d**-0.5)
            parts.append((scores, v_l.float()))
            devices.append(dev)
        out = _dlse_combine(parts, devices, q.dtype, "bngs,bnsd->bngd")
        outs.append(out.reshape(q_l.shape[0], hq, 1, d).to(q.device))
    return torch.cat(outs, dim=0)


def dlse_mla_decode_attention(q: Tensor, ckv: Tensor, krope: Tensor, wuk: Tensor, wuv: Tensor,
                              kv_valid_len, *, nope_dim: int, v_dim: int) -> Tensor:
    """MLA's distributed log-sum-exp decode (the reference's
    ``dlse_mla_decode_attention``): each model shard expands only its own
    block of the latent cache ``ckv`` [B, S, kv_rank] (and ``krope`` [B,
    S, rope_dim]) through ``wuk``/``wuv``, and only the block's keys below
    ``kv_valid_len`` (the reference expands them all and masks the rest,
    which add exactly zero).  ``q`` [B, H, 1, nope + rope]; returns [B, H,
    1, v_dim] in q's dtype on q's device."""
    mesh = model_mesh()
    b, h, _, qk = q.shape
    rd = qk - nope_dim
    valid = int(kv_valid_len)
    outs = []
    for q_l, shards in _dlse_blocks(mesh, q, (ckv, krope), 1, valid):
        parts, devices = [], []
        for dev, (c_l, r_l) in shards:
            bl, s_loc = c_l.shape[0], c_l.shape[1]
            k_nope = (c_l @ wuk.to(dev)).reshape(bl, s_loc, h, nope_dim)
            v = (c_l @ wuv.to(dev)).reshape(bl, s_loc, h, v_dim).float()
            k = torch.cat([k_nope, r_l[:, :, None].expand(bl, s_loc, h, rd)], dim=-1).float()
            qf = q_l.to(dev)[:, :, 0].float()  # [B, H, qk]
            scores = torch.einsum("bhd,bshd->bhs", qf, k) * (qk**-0.5)
            parts.append((scores, v))
            devices.append(dev)
        out = _dlse_combine(parts, devices, q.dtype, "bhs,bshd->bhd")
        outs.append(out[:, :, None, :].to(q.device))
    return torch.cat(outs, dim=0)


def cross_entropy_loss(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean token cross-entropy: logits ``[..., vocab]`` (cast to float32),
    labels ``[...]`` of integer ids; ``logsumexp`` minus the gold logit."""
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()
