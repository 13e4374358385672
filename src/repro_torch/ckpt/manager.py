"""Checkpointing: trees of tensors <-> disk with async writes, retention
and resume (port of ``repro.ckpt.manager``).

Format: one ``arrays.pt`` (``torch.save`` of the flattened leaves, keyed
by position) plus a JSON sidecar ``meta.json`` with each leaf's tree path
and the step metadata. Writes go to a temp directory that is published
with ``os.replace``, so a killed process never leaves a half-written
checkpoint: the restart path picks the newest COMPLETE step.
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import os
import re
import shutil
import time
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.common import tree_unflatten

PyTree = Any
_STEP_RE = re.compile(r"^step_(\d+)$")


def _flatten_with_paths(tree: PyTree, prefix: str = ""
                        ) -> list[tuple[str, Any]]:
    """(path, leaf) pairs in ``tree_leaves`` order; paths read like the
    reference's ``keystr``: ``['params']['mlp_0']['w']``, ``[0]``."""
    if isinstance(tree, Mapping):
        return [x for k, v in tree.items()
                for x in _flatten_with_paths(v, f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flatten_with_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _to_host(leaf) -> torch.Tensor:
    """A CPU copy of a leaf, taken now (a later step may overwrite the
    device tensor in place)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return torch.as_tensor(np.asarray(leaf)).clone()


def save_tree(tree: PyTree, path: str, meta: dict | None = None) -> None:
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    items = _flatten_with_paths(tree)
    torch.save({f"leaf_{i}": _to_host(leaf)
                for i, (_, leaf) in enumerate(items)},
               os.path.join(tmp, "arrays.pt"))
    sidecar = {"paths": [p for p, _ in items], "meta": meta or {},
               "time": time.time()}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(sidecar, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)  # atomic publish


def restore_tree(template: PyTree, path: str) -> PyTree:
    """Restore into the structure, devices and dtypes of ``template``."""
    with open(os.path.join(path, "meta.json")) as f:
        sidecar = json.load(f)
    data = torch.load(os.path.join(path, "arrays.pt"), map_location="cpu",
                      weights_only=True)
    by_path = {p: data[f"leaf_{i}"] for i, p in enumerate(sidecar["paths"])}
    out = []
    for key, leaf in _flatten_with_paths(template):
        if key not in by_path:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = by_path[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(arr.shape)} vs {tuple(leaf.shape)}")
        if isinstance(leaf, torch.Tensor):
            arr = arr.to(device=leaf.device, dtype=leaf.dtype)
        out.append(arr)
    return tree_unflatten(template, out)


def checkpoint_meta(path: str) -> dict:
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)["meta"]


class CheckpointManager:
    """Step-indexed checkpoints with retention and async (overlapped)
    saves."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)
        self._pool = cf.ThreadPoolExecutor(1) if async_save else None
        self._pending: cf.Future | None = None

    # -- write ---------------------------------------------------------------
    def save(self, step: int, tree: PyTree, meta: dict | None = None) -> None:
        self.wait()  # one in-flight save at a time
        # snapshot to host BEFORE returning control: the caller may write
        # the device tensors in place afterwards
        items = _flatten_with_paths(tree)
        host = tree_unflatten(tree, [_to_host(leaf) for _, leaf in items])
        path = os.path.join(self.dir, f"step_{step}")
        meta = dict(meta or {}, step=step)
        if self._pool is None:
            save_tree(host, path, meta)
            self._gc()
        else:
            def work():
                save_tree(host, path, meta)
                self._gc()
            self._pending = self._pool.submit(work)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    # -- read ----------------------------------------------------------------
    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "meta.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: PyTree, step: int | None = None
                ) -> tuple[PyTree, dict]:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        return restore_tree(template, path), checkpoint_meta(path)

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
