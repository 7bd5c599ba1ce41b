"""pna [gnn]: 4L, d=75, aggregators mean-max-min-std, scalers id-amp-atten.
[arXiv:2004.05718; paper]  The numbers of ``repro/configs/pna.py``."""

import dataclasses

from repro_torch.configs.common import ArchSpec
from repro_torch.configs.gnn_harness import GNN_SHAPES
from repro_torch.models.gnn import pna as model


def full() -> model.PNAConfig:
    return model.PNAConfig(num_layers=4, d_hidden=75, d_in=128, num_classes=47)


def smoke() -> model.PNAConfig:
    return model.PNAConfig(num_layers=2, d_hidden=16, d_in=16, num_classes=4)


def _cfg_for_shape(cfg, shape_name, meta):
    return dataclasses.replace(cfg, d_in=min(cfg.d_in, meta["d_feat"]))


ARCH = ArchSpec(name="pna", family="gnn", full=full, smoke=smoke, shapes=GNN_SHAPES)
