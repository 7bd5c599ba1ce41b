"""equiformer-v2 [gnn]: 12L, d=128, l_max=6, m_max=2, 8 heads, SO(2)-eSCN
equivariant graph attention. [arXiv:2306.12059; unverified]  The numbers of
``repro/configs/equiformer_v2.py``."""

import dataclasses

from repro_torch.configs.common import ArchSpec
from repro_torch.configs.gnn_harness import build_gnn_cell, EQUIFORMER_CHUNKS, GNN_SHAPES
from repro_torch.models.gnn import equiformer_v2 as model


def full() -> model.EquiformerV2Config:
    return model.EquiformerV2Config(num_layers=12, d_hidden=128, l_max=6, m_max=2, num_heads=8)


def smoke() -> model.EquiformerV2Config:
    return model.EquiformerV2Config(num_layers=2, d_hidden=16, l_max=2, m_max=1, num_heads=2)


def _cfg_for_shape(cfg, shape_name, meta):
    return dataclasses.replace(cfg, edge_chunk=EQUIFORMER_CHUNKS[shape_name])


def build_cell(cfg, shape_name, mesh):
    return build_gnn_cell("equiformer-v2", cfg, shape_name, mesh, init_params=model.init_params,
                          loss_fn=model.loss_fn, cfg_for_shape=_cfg_for_shape)


ARCH = ArchSpec(
    name="equiformer-v2", family="gnn", full=full, smoke=smoke, shapes=GNN_SHAPES, build_cell=build_cell,
    notes="eSCN: per-edge Wigner alignment + SO(2) conv (m<=2); edge-chunked "
    "two-pass softmax on ogb_products bounds message memory.",
)
