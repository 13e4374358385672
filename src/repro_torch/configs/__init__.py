"""Architecture registry (port of ``repro.configs``, the recsys entries).

``get_config(arch)`` returns the config module, which carries ``BUILD``
(the published widths), ``smoke_build()`` (a small build for tests and
the CPU) and ``SHAPES``. The reference's LM and GNN entries are not ported
yet: asking for one raises a ``KeyError`` that says so.
"""
from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "dlrm-mlperf": "dlrm_mlperf",
    "fm": "fm",
    "din": "din",
    "deepfm": "deepfm",
    "paper-ranking": "paper_ranking",
}

# the reference registry's other entries, which wait for their model ports
NOT_PORTED = ("mixtral-8x7b", "granite-moe-3b-a800m", "deepseek-67b",
              "qwen3-14b", "yi-9b", "schnet")


def get_config(arch: str):
    if arch in NOT_PORTED:
        raise KeyError(f"arch {arch!r} is in the reference registry but not "
                       f"ported yet (the LM and GNN models come with a later "
                       f"slice); ported: {sorted(_ARCH_MODULES)}")
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")
