"""Architecture registry (port of ``repro.configs``).

``get_config(arch)`` returns the config module. A recsys module carries
``BUILD`` (the published widths), ``smoke_build()`` (a small build for
tests and the CPU) and ``SHAPES``; an LM module carries ``CONFIG`` (an
``LMConfig`` at the published widths), ``smoke_config()`` and ``SHAPES``.
The reference's GNN entry is not ported yet: asking for it raises a
``KeyError`` that says so.
"""
from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "mixtral-8x7b": "mixtral_8x7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "deepseek-67b": "deepseek_67b",
    "qwen3-14b": "qwen3_14b",
    "yi-9b": "yi_9b",
    "dlrm-mlperf": "dlrm_mlperf",
    "fm": "fm",
    "din": "din",
    "deepfm": "deepfm",
    "paper-ranking": "paper_ranking",
}

# the reference registry's other entries, which wait for their model ports
NOT_PORTED = ("schnet",)


def get_config(arch: str):
    if arch in NOT_PORTED:
        raise KeyError(f"arch {arch!r} is in the reference registry but not "
                       f"ported yet (the GNN model, SchNet, comes with the "
                       f"next slice of the port); ported: "
                       f"{sorted(_ARCH_MODULES)}")
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")
