"""Model definitions of the port: the transformer family (GQA, MLA, MoE),
MIND (``recsys``) and the GNNs (``gnn``)."""
