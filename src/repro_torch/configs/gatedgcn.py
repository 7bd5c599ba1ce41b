"""gatedgcn [gnn]: 16L, d=70, gated aggregator. [arXiv:2003.00982; paper]
The numbers of ``repro/configs/gatedgcn.py``."""

import dataclasses

from repro_torch.configs.common import ArchSpec
from repro_torch.configs.gnn_harness import build_gnn_cell, GNN_SHAPES
from repro_torch.models.gnn import gatedgcn as model


def full() -> model.GatedGCNConfig:
    return model.GatedGCNConfig(num_layers=16, d_hidden=70, d_in=128, num_classes=47)


def smoke() -> model.GatedGCNConfig:
    return model.GatedGCNConfig(num_layers=2, d_hidden=16, d_in=16, num_classes=4)


def _cfg_for_shape(cfg, shape_name, meta):
    return dataclasses.replace(cfg, d_in=min(cfg.d_in, meta["d_feat"]))


def build_cell(cfg, shape_name, mesh):
    return build_gnn_cell("gatedgcn", cfg, shape_name, mesh, init_params=model.init_params,
                          loss_fn=model.loss_fn, cfg_for_shape=_cfg_for_shape)


ARCH = ArchSpec(name="gatedgcn", family="gnn", full=full, smoke=smoke, shapes=GNN_SHAPES, build_cell=build_cell)
