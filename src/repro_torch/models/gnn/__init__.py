"""GNN architectures of the port: PNA, GatedGCN (SpMM/SDDMM regime), DimeNet
(triplet regime), EquiformerV2 (irrep/eSCN regime).  The port of
``repro/models/gnn``."""
