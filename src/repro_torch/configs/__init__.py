"""Architecture registry of the port: ``--arch <id>`` resolution.

Only the architectures whose model is ported resolve; the reference's other
ids raise a ``KeyError`` that says so.
"""

from __future__ import annotations

import importlib

_MODULES = {
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "pna": "repro_torch.configs.pna",
    "gatedgcn": "repro_torch.configs.gatedgcn",
    "dimenet": "repro_torch.configs.dimenet",
    "equiformer-v2": "repro_torch.configs.equiformer_v2",
    "mind": "repro_torch.configs.mind",
}
# the reference's other architectures (repro/configs/__init__.py)
NOT_PORTED = ("qwen2-72b", "arctic-480b", "diff-ife")

ARCH_NAMES = list(_MODULES)


def get_arch(name: str):
    key = name.replace("_", "-").lower()
    if key in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet (ROADMAP Queue 1 item 9(f): "
                       f"the mesh path and its configs); ported: {ARCH_NAMES}")
    if key not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; ported: {ARCH_NAMES}")
    return importlib.import_module(_MODULES[key]).ARCH
