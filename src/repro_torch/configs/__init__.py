"""Architecture registry of the port: ``--arch <id>`` resolution.

Every architecture of the reference resolves, under its name and in its
order: the five LMs, the four GNNs, ``mind`` and ``diff-ife`` (the DC
engine as an architecture).
"""

from __future__ import annotations

import importlib

_MODULES = {
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "pna": "repro_torch.configs.pna",
    "gatedgcn": "repro_torch.configs.gatedgcn",
    "dimenet": "repro_torch.configs.dimenet",
    "equiformer-v2": "repro_torch.configs.equiformer_v2",
    "mind": "repro_torch.configs.mind",
    "diff-ife": "repro_torch.configs.diff_ife",
}

ARCH_NAMES = list(_MODULES)


def get_arch(name: str):
    key = name.replace("_", "-").lower()
    if key not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return importlib.import_module(_MODULES[key]).ARCH
