"""Weights and feature rows, drawn from the seed on the device in a few
large calls, and handed alike to the system under test and the
reference.

A model's parameter layout comes from its reference module
(``param_shapes``): a tree ``{node: {leaf: (shape, kind)}}``, where
``kind`` is ``"glorot"`` (uniform, the Glorot limit of the leaf's first
and last dims), ``"bias"`` (uniform on ``[-bias_scale, bias_scale]``) or
``"table"`` (normal, ``table_std``). All Glorot leaves come from one
``torch.rand`` call, all biases from another, each table from one
``torch.randn``.

Feature rows follow the reference's ``feed_specs``: floats standard
normal, ids uniform over their table's rows.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# weights and features draw from distinct generators of one seed
WEIGHTS_STREAM, FEATURES_STREAM = 11, 12


def generator(seed: int, stream: int, device: torch.device
              ) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def _leaves(tree: dict, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def draw_params(shapes: dict, seed: int, device: torch.device, *,
                table_std: float, bias_scale: float,
                dtype=torch.float32) -> dict:
    """The parameter tree of ``shapes`` (see the module docstring)."""
    g = generator(seed, WEIGHTS_STREAM, device)
    leaves = list(_leaves(shapes))
    out: dict = {}

    def put(path, value):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value

    for kind in ("glorot", "bias"):
        group = [(p, tuple(s)) for p, (s, k) in leaves if k == kind]
        total = sum(math.prod(s) for _, s in group)
        if not total:
            continue
        flat = torch.rand(total, generator=g, device=device, dtype=dtype)
        flat = flat.mul_(2).sub_(1)
        off = 0
        for path, shape in group:
            n = math.prod(shape)
            lim = (math.sqrt(6.0 / (shape[0] + shape[-1])) if kind == "glorot"
                   else bias_scale)
            put(path, flat[off:off + n].view(shape).mul_(lim))
            off += n
    for path, (shape, kind) in leaves:
        if kind == "table":
            put(path, torch.randn(tuple(shape), generator=g, device=device,
                                  dtype=dtype).mul_(table_std))
        elif kind not in ("glorot", "bias"):
            raise ValueError(f"unknown leaf kind {kind!r} at {path}")
    return out


def draw_rows(specs: dict, n: int, g: torch.Generator, *,
              pin: bool = False) -> dict[str, np.ndarray | torch.Tensor]:
    """``n`` rows of each feed of ``specs`` (name -> (row shape, dtype,
    id range or None)), drawn on ``g``'s device; host numpy arrays, or
    pinned host tensors with ``pin``."""
    out = {}
    for name, (shape, dtype, vocab) in specs.items():
        full = (n,) + tuple(shape)
        if vocab is None:
            t = torch.randn(full, generator=g, device=g.device,
                            dtype=torch.float32)
        else:
            t = torch.randint(0, int(vocab), full, generator=g,
                              device=g.device, dtype=torch.int32)
        t = t.to(getattr(torch, dtype))
        if pin:
            host = torch.empty(full, dtype=t.dtype, pin_memory=True)
            out[name] = host.copy_(t)
        else:
            out[name] = t.cpu().numpy()
    return out
