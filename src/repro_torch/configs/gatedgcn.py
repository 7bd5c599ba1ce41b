"""gatedgcn [gnn]: 16L, d=70, gated aggregator. [arXiv:2003.00982; paper]
The numbers of ``repro/configs/gatedgcn.py``."""

import dataclasses

from repro_torch.configs.common import ArchSpec
from repro_torch.configs.gnn_harness import GNN_SHAPES
from repro_torch.models.gnn import gatedgcn as model


def full() -> model.GatedGCNConfig:
    return model.GatedGCNConfig(num_layers=16, d_hidden=70, d_in=128, num_classes=47)


def smoke() -> model.GatedGCNConfig:
    return model.GatedGCNConfig(num_layers=2, d_hidden=16, d_in=16, num_classes=4)


def _cfg_for_shape(cfg, shape_name, meta):
    return dataclasses.replace(cfg, d_in=min(cfg.d_in, meta["d_feat"]))


ARCH = ArchSpec(name="gatedgcn", family="gnn", full=full, smoke=smoke, shapes=GNN_SHAPES)
