"""PyTorch + CUDA port of the Diff-IFE continuous query processor.

Mirrors ``src/repro/`` module for module (``repro_torch/core/engine.py`` ↔
``repro/core/engine.py``).  The port imports ``torch`` and ``numpy`` only;
the JAX package is the reference its tests hold it against.  Entry points
run on the CUDA device unless the caller passes ``device="cpu"``.
"""
