"""Architecture registry (port of ``repro.configs``): 10 assigned archs
(+ the paper's own ranking model), each paired with its input-shape set.

``get_config(arch)`` returns the config module. A recsys module carries
``BUILD`` (the published widths), ``smoke_build()`` (a small build for
tests and the CPU) and ``SHAPES``; an LM or GNN module carries ``CONFIG``
(an ``LMConfig`` or ``SchNetConfig`` at the published widths),
``smoke_config()`` and ``SHAPES``. ``all_cells()`` enumerates the
(arch × shape) matrix.
"""
from __future__ import annotations

import dataclasses
import importlib

_ARCH_MODULES = {
    "mixtral-8x7b": "mixtral_8x7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "deepseek-67b": "deepseek_67b",
    "qwen3-14b": "qwen3_14b",
    "yi-9b": "yi_9b",
    "schnet": "schnet",
    "dlrm-mlperf": "dlrm_mlperf",
    "fm": "fm",
    "din": "din",
    "deepfm": "deepfm",
    "paper-ranking": "paper_ranking",
}

ASSIGNED_ARCHS = [a for a in _ARCH_MODULES if a != "paper-ranking"]


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    kind: str                  # 'train' | 'prefill' | 'decode' | 'serve'
    skip_reason: str | None = None


def get_config(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def all_cells(include_paper: bool = False) -> list[Cell]:
    cells = []
    archs = list(ASSIGNED_ARCHS) + (["paper-ranking"] if include_paper else [])
    for arch in archs:
        mod = get_config(arch)
        for shape, spec in mod.SHAPES.items():
            cells.append(Cell(arch=arch, shape=shape, kind=spec["kind"],
                              skip_reason=spec.get("skip")))
    return cells
