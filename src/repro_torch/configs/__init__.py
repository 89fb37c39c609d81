"""Model and table configurations of the port.

``--arch <id>`` resolves here.  The registry names the reference's ten LM
architectures; the four dense attention ones are ported, and the other six
(MoE, hybrid, vision, audio and xLSTM stacks) wait for ROADMAP item 15b.
The paper's recommendation workload is ``configs.hkv_dlrm``.
"""

from __future__ import annotations

import importlib

_MODULES = {
    "gemma-2b": "gemma_2b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "qwen2-0.5b": "qwen2_0_5b",
    "yi-6b": "yi_6b",
    "llama4-maverick-400b-a17b": None,
    "moonshot-v1-16b-a3b": None,
    "zamba2-1.2b": None,
    "qwen2-vl-2b": None,
    "musicgen-medium": None,
    "xlstm-1.3b": None,
}

ARCH_NAMES = tuple(_MODULES)
PORTED_ARCHS = tuple(n for n, m in _MODULES.items() if m is not None)


def get_arch(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; one of {ARCH_NAMES}")
    if _MODULES[name] is None:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ROADMAP item 15b); ported: {PORTED_ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}").arch()


def all_archs():
    """The ported archs (`PORTED_ARCHS`)."""
    return [get_arch(n) for n in PORTED_ARCHS]
