"""Architecture registry of the port: ``--arch <id>`` resolution.

Every LM, recsys and GNN architecture of the reference resolves; ``diff-ife``
(the reference's DC-engine config) raises a ``KeyError`` that says it is
not ported yet.
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
}
# the reference's other architecture (repro/configs/__init__.py)
NOT_PORTED = ("diff-ife",)

ARCH_NAMES = list(_MODULES)


def get_arch(name: str):
    key = name.replace("_", "-").lower()
    if key in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet (ROADMAP Queue 1 item 9(f3): "
                       f"configs/diff_ife.py over the 2-D mesh); ported: {ARCH_NAMES}")
    if key not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; ported: {ARCH_NAMES}")
    return importlib.import_module(_MODULES[key]).ARCH
