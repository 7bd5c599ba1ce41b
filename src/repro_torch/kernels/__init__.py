"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Sources live in ``kernels/csrc/`` and are compiled by ``kernels/_build.py``
with ``nvcc`` at first use; nothing is built or imported from CUDA when a
module here is imported.
"""
