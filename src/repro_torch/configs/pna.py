"""pna [gnn]: 4L, d=75, aggregators mean-max-min-std, scalers id-amp-atten.
[arXiv:2004.05718; paper]  The numbers of ``repro/configs/pna.py``."""

import dataclasses

from repro_torch.configs.common import ArchSpec
from repro_torch.configs.gnn_harness import build_gnn_cell, GNN_SHAPES
from repro_torch.models.gnn import pna as model


def full() -> model.PNAConfig:
    return model.PNAConfig(num_layers=4, d_hidden=75, d_in=128, num_classes=47)


def smoke() -> model.PNAConfig:
    return model.PNAConfig(num_layers=2, d_hidden=16, d_in=16, num_classes=4)


def _cfg_for_shape(cfg, shape_name, meta):
    return dataclasses.replace(cfg, d_in=min(cfg.d_in, meta["d_feat"]))


def build_cell(cfg, shape_name, mesh):
    return build_gnn_cell("pna", cfg, shape_name, mesh, init_params=model.init_params,
                          loss_fn=model.loss_fn, cfg_for_shape=_cfg_for_shape)


ARCH = ArchSpec(name="pna", family="gnn", full=full, smoke=smoke, shapes=GNN_SHAPES, build_cell=build_cell)
