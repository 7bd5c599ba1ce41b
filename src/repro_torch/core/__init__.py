"""Core of the port: graph layer, difference store, the dense Diff-IFE
engine (JOD, ``coo``/``ell`` backends) and the SCRATCH oracle."""
