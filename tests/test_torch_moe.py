"""Port parity: the MoE FFN (``repro_torch.models.moe``) and qwen2-moe-a2.7b.

The same inputs, drawn from numpy seeds, go through the reference's
``repro/models/moe.py`` (its own jit on the CPU) and the port
(``device="cpu"``).  Routing is held bit for bit: ``topk_routing``'s
indices (gates at 1e-7: the same float32 softmax), ``dispatch_indices``'
slots, on float32 logits, on bfloat16 logits with deliberate ties at the
top-k boundary (which ``torch.topk`` would order otherwise) and with
experts past their capacity.  ``moe_ffn``'s output at 1e-5 and its aux loss
at 1e-6 in float32 (the same products summed in another order).  The
whole model's forward and decode parity is in
``tests/test_torch_transformer.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch import model_serve as MS
from repro_torch.models import moe
from repro_torch.models import transformer as tf

ARCH = get_arch("qwen2-moe-a2.7b")


def _ref_routing(logits: np.ndarray, k: int, num_experts: int, capacity: int):
    import jax.numpy as jnp

    from repro.models import moe as rmoe

    gates, idx = rmoe.topk_routing(jnp.asarray(logits), k)
    slot = rmoe.dispatch_indices(idx, num_experts, capacity)
    return np.asarray(gates), np.asarray(idx), np.asarray(slot)


def _port_routing(logits: torch.Tensor, k: int, num_experts: int, capacity: int):
    gates, idx = moe.topk_routing(logits, k)
    return gates.numpy(), idx.numpy(), moe.dispatch_indices(idx, num_experts, capacity).numpy()


def _tied_bf16_logits(t: int, e: int, seed: int) -> np.ndarray:
    """bfloat16 router logits (cast to float32, as the reference's) on a
    coarse grid, so values tie often, with the row [1, 3, 3, 2, 3, 0, ...]
    first: three equal values straddle a top-2 boundary."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal((t, e)) * 4) / 4
    x[0, :6] = [1, 3, 3, 2, 3, 0]
    x[0, 6:] = -1
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("case", ["float32", "bf16_ties", "overflow", "capacity_1"])
def test_routing_and_dispatch_are_the_references_bit_for_bit(case):
    rng = np.random.default_rng(11)
    t, e, k, capacity = 64, 8, 2, 20
    if case == "float32":
        logits = rng.standard_normal((t, e)).astype(np.float32)
    elif case == "bf16_ties":
        logits = _tied_bf16_logits(t, e, seed=12)
    elif case == "overflow":  # expert 3 favoured: far more choices than its capacity
        logits = rng.standard_normal((t, e)).astype(np.float32)
        logits[:, 3] += 3.0
        capacity = 6
    else:  # a decode step's capacity: every expert chosen twice drops a choice
        logits = _tied_bf16_logits(5, e, seed=13)
        t, capacity = 5, 1
    want_g, want_i, want_s = _ref_routing(logits, k, e, capacity)
    got_g, got_i, got_s = _port_routing(torch.from_numpy(logits), k, e, capacity)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-7, atol=1e-7)
    np.testing.assert_array_equal(np.bincount(got_s[got_s >= 0] // capacity, minlength=e),
                                  np.bincount(want_s[want_s >= 0] // capacity, minlength=e))
    if case in ("overflow", "capacity_1"):
        assert (got_s < 0).any()  # choices were dropped
    if case == "bf16_ties":
        # the case tells the tie orders apart: torch.topk's would fail it
        assert not np.array_equal(torch.topk(torch.from_numpy(logits), k).indices.numpy(), want_i)
        np.testing.assert_array_equal(got_i[0], [1, 2])


def test_bf16_router_logits_at_qwen2_moes_width_route_as_the_reference():
    """Router logits as the model makes them at qwen2-moe's widths (a bf16
    product cast to float32, padded experts 60..63 masked to -1e30) on 512
    tokens: the port's top-4 and slots equal the reference's, where top-4
    boundary ties occur."""
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.standard_normal((512, 2048)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((2048, 64)) * 2048**-0.5).astype(np.float32)).to(torch.bfloat16)
    logits = (x @ w).float()
    logits = torch.where(torch.arange(64) < 60, logits, -1e30).numpy()
    srt = -np.sort(-logits, axis=1)
    assert (srt[:, 3] == srt[:, 4]).sum() > 0  # ties at the top-4 boundary
    capacity = max(1, int(1.25 * 512 * 4 / 60))
    want = _ref_routing(logits, 4, 64, capacity)
    got = _port_routing(torch.from_numpy(logits), 4, 64, capacity)
    for g, w_ in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w_)
    assert (got[1] < 60).all()  # the pad never receives a token


@pytest.mark.parametrize("t,e_pad,e_logical,cf", [(24, 8, 6, 1.0), (3, 8, 6, 1.25), (40, 8, 8, 1.25)])
def test_moe_ffn_matches_the_reference(t, e_pad, e_logical, cf):
    """Output at 1e-5 and aux loss at 1e-6 (float32), with padded experts,
    overflowing experts (capacity 8 for 48 choices over 6) and a decode's
    capacity of 1."""
    import jax.numpy as jnp

    from repro.models import moe as rmoe

    rng = np.random.default_rng(t + e_logical)
    d, f, k = 16, 32, 2
    x = rng.standard_normal((t, d)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.3
          for s in ((d, e_pad), (e_pad, d, f), (e_pad, d, f), (e_pad, f, d))]
    kw = dict(top_k=k, capacity_factor=cf, num_experts=e_logical)
    want, want_aux = rmoe.moe_ffn(jnp.asarray(x), *map(jnp.asarray, ws), **kw)
    got, aux = moe.moe_ffn(torch.from_numpy(x), *map(torch.from_numpy, ws), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6, atol=1e-6)
    assert aux.dtype == torch.float32


def test_num_params_and_active_params_are_the_references():
    from repro.configs import get_arch as ref_get_arch

    ref = ref_get_arch("qwen2-moe-a2.7b").full()
    cfg = ARCH.full()
    assert cfg.num_params() == ref.num_params() == 15_146_452_992
    assert cfg.num_active_params() == ref.num_active_params() == 3_519_842_304
    assert get_arch("minicpm3-4b").full().num_params() == 4_263_336_448


def test_model_serve_cli_serves_qwen2_moe_on_the_cpu(capsys):
    MS.main(["--arch", "qwen2-moe-a2.7b", "--device", "cpu"])
    assert "served 4 seqs × 8 new tokens" in capsys.readouterr().out
    out = MS.lm_serve(ARCH, 4, 16, 8, device="cpu")
    assert out["tokens"].shape == (4, 8)
    # the padded config routes over its logical experts only
    cfg = dataclasses.replace(ARCH.smoke(), num_experts_padded=12)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert params["layers"]["router"].shape == (2, 64, 12)
