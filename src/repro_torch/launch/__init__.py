"""Launchers of the port: the continuous-query serving CLI
(``launch.cqp_serve``) and the LM serving loop (``launch.model_serve``)."""
