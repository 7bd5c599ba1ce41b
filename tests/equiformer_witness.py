"""CPU readings of the reference EquiformerV2 (JAX) beside the port at
``full()`` widths, on ``gnn_card_vs_cpu``'s batch (8 graphs of
``molecule``'s layout: 240 nodes, 512 edges), float32:

- the gradients' sensitivity to a relative 1e-7 nudge of the weights
  (seeded), as the largest change over a leaf's largest |value|, at 1, 3
  and 12 layers, for the reference (jitted) and the port;
- 9 steps (as a ``main_gnn`` cell: 1 + 8) of the reference's jitted
  ``make_gnn_train_step`` (AdamW at lr 1e-3) at 12 layers from its
  ``init_params``, the same from the nudged weights, and the port's
  ``make_gnn_train_step`` from the reference's weights carried across.

One JSON line each.  Run from the repository's root (a few minutes):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/equiformer_witness.py
"""

import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs.gnn_harness import make_gnn_train_step as ref_train_step
from repro.models.gnn import common as rg
from repro.models.gnn import equiformer_v2 as ref
from repro.optim import adamw_init as ref_adamw_init
from repro_torch.configs import get_arch
from repro_torch.configs import gnn_harness as H
from repro_torch.core.convert import transformer_params_from_reference
from repro_torch.models.gnn import equiformer_v2 as port
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_leaves, tree_map

NUDGE = 1e-7
STEPS = 9


def batches():
    pb = H.molecule_batch(dict(n_nodes=240, n_edges=512, d_feat=16), num_species=16,
                          generator=torch.Generator().manual_seed(40), device="cpu")
    rb = rg.GraphBatch(*(jnp.asarray(np.asarray(x.numpy(), np.int32) if x.dtype == torch.int64 else x.numpy())
                         for x in pb))
    return rb, pb


def _rel(got, want) -> float:
    return max(float(np.abs(np.asarray(a) - np.asarray(b)).max()) / max(float(np.abs(np.asarray(b)).max()), 1e-30)
               for a, b in zip(got, want))


def ref_params(layers: int):
    cfg = dataclasses.replace(ref_get_arch("equiformer-v2").full(), num_layers=layers)
    params = jax.tree.map(np.asarray, ref.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    nudged = jax.tree.map(lambda x: (x * (1 + NUDGE * rng.standard_normal(x.shape))).astype(x.dtype), params)
    return cfg, params, nudged


def sensitivity(layers: int, rb, pb) -> dict:
    cfg, params, nudged = ref_params(layers)
    grad = jax.jit(jax.grad(lambda p: ref.loss_fn(cfg, p, rb)))
    out = {"layers": layers, "reference": _rel(jax.tree.leaves(grad(nudged)), jax.tree.leaves(grad(params)))}
    pcfg = dataclasses.replace(get_arch("equiformer-v2").full(), num_layers=layers)

    def port_grads(p):
        leaves = tree_leaves(p)
        for x in leaves:
            x.requires_grad_(True)
        return [g.numpy() for g in torch.autograd.grad(port.loss_fn(pcfg, p, pb), leaves)]

    pp = transformer_params_from_reference(params, "cpu")
    gen = torch.Generator().manual_seed(5)
    pn = tree_map(lambda x: x * (1 + NUDGE * torch.randn(x.shape, generator=gen)), pp)
    out["port"] = _rel(port_grads(pn), port_grads(pp))
    return out


def trajectories(rb, pb) -> dict:
    cfg, params, nudged = ref_params(12)
    step = jax.jit(ref_train_step(lambda p, b: ref.loss_fn(cfg, p, b)))
    out = {}
    for tag, p in (("reference", params), ("reference_nudged", nudged)):
        o, losses = ref_adamw_init(p), []
        for _ in range(STEPS):
            p, o, m = step(p, o, rb)
            losses.append(float(m["loss"]))
        out[tag] = losses
    pcfg = get_arch("equiformer-v2").full()
    pstep = H.make_gnn_train_step(lambda p, b: port.loss_fn(pcfg, p, b))
    p = transformer_params_from_reference(params, "cpu")
    o, losses = adamw_init(p), []
    for _ in range(STEPS):
        p, o, m = pstep(p, o, pb)
        losses.append(float(m["loss"]))
    out["port"] = losses
    return out


def main() -> None:
    t0 = time.perf_counter()
    rb, pb = batches()
    for layers in (1, 3, 12):
        print(json.dumps({"gradient_sensitivity_to_a_1e-7_nudge": sensitivity(layers, rb, pb),
                          "s": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"losses_over_9_steps": trajectories(rb, pb), "s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
