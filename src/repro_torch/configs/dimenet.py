"""dimenet [gnn]: 6 blocks, d=128, n_bilinear=8, n_spherical=7, n_radial=6.
Triplet (quadratic) kernel regime with per-shape caps
(``gnn_harness.triplet_cap``).  [arXiv:2003.03123; unverified]  The numbers
of ``repro/configs/dimenet.py``."""

import torch

from repro_torch.configs.common import ArchSpec, named
from repro_torch.configs.gnn_harness import GNN_SHAPES, build_gnn_cell, triplet_cap
from repro_torch.models.gnn import dimenet as model


def full() -> model.DimeNetConfig:
    return model.DimeNetConfig(num_blocks=6, d_hidden=128, n_bilinear=8, n_spherical=7, n_radial=6)


def smoke() -> model.DimeNetConfig:
    return model.DimeNetConfig(num_blocks=2, d_hidden=16, n_bilinear=4)


def _cfg_for_shape(cfg, shape_name, meta):
    return cfg  # every shape runs the config as it is; the shape sets the triplet cap


def build_cell(cfg, shape_name, mesh):
    cap = triplet_cap(shape_name)  # shard-divisible
    tri = tuple(torch.empty((cap,), dtype=dt, device="meta") for dt in (torch.int64, torch.int64, torch.bool))
    tsh = named(mesh, "graph_edges")
    return build_gnn_cell("dimenet", cfg, shape_name, mesh, init_params=model.init_params,
                          loss_fn=lambda c, p, b, t: model.loss_fn(c, p, b, t),
                          extra_args=(tri,), extra_shardings=((tsh, tsh, tsh),))


ARCH = ArchSpec(
    name="dimenet", family="gnn", full=full, smoke=smoke, shapes=GNN_SHAPES, build_cell=build_cell,
    notes="triplet lists capped per shape (quadratic regime bounded); "
    "non-geometric shapes get synthesized coordinates.",
)
