"""Launchers of the port: the continuous-query serving CLI
(``launch.cqp_serve``), the LM and MIND serving loops (``launch.model_serve``)
and GNN training (``launch.train``)."""
