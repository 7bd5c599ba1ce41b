"""Launchers of the port: the LM serving loop (``launch.model_serve``)."""
