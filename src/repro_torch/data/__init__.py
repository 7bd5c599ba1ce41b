"""Synthetic workloads and GNN data (numpy only): dynamic graphs
(``graphgen``), seeded LM/MIND batches (``synthetic``) and the neighbour
sampler (``sampler``)."""
