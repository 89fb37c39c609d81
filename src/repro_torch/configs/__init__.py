"""Model and table configurations of the port.

``--arch <id>`` resolves here: the reference's ten LM architectures, each
a module exporting ``arch()``.  The paper's recommendation workload is
``configs.hkv_dlrm``.
"""

from __future__ import annotations

import importlib

_MODULES = {
    "gemma-2b": "gemma_2b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "qwen2-0.5b": "qwen2_0_5b",
    "yi-6b": "yi_6b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b",
    "zamba2-1.2b": "zamba2_1_2b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "musicgen-medium": "musicgen_medium",
    "xlstm-1.3b": "xlstm_1_3b",
}

ARCH_NAMES = tuple(_MODULES)
PORTED_ARCHS = ARCH_NAMES


def get_arch(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; one of {ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}").arch()


def all_archs():
    return [get_arch(n) for n in ARCH_NAMES]
