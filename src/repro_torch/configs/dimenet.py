"""dimenet [gnn]: 6 blocks, d=128, n_bilinear=8, n_spherical=7, n_radial=6.
Triplet (quadratic) kernel regime with per-shape caps
(``gnn_harness.triplet_cap``).  [arXiv:2003.03123; unverified]  The numbers
of ``repro/configs/dimenet.py``."""

from repro_torch.configs.common import ArchSpec
from repro_torch.configs.gnn_harness import GNN_SHAPES
from repro_torch.models.gnn import dimenet as model


def full() -> model.DimeNetConfig:
    return model.DimeNetConfig(num_blocks=6, d_hidden=128, n_bilinear=8, n_spherical=7, n_radial=6)


def smoke() -> model.DimeNetConfig:
    return model.DimeNetConfig(num_blocks=2, d_hidden=16, n_bilinear=4)


def _cfg_for_shape(cfg, shape_name, meta):
    return cfg  # every shape runs the config as it is; the shape sets the triplet cap


ARCH = ArchSpec(
    name="dimenet", family="gnn", full=full, smoke=smoke, shapes=GNN_SHAPES,
    notes="triplet lists capped per shape (quadratic regime bounded); "
    "non-geometric shapes get synthesized coordinates.",
)
