"""Thread-local sharding policy (port of ``repro.dist.policy``).

Model code (``repro_torch.models.transformer``) stays mesh-agnostic: the
launch layer activates a policy for the duration of a call::

    with policy.use(moe_shard_axes=("data",)):
        ...

and the model consults it via ``policy.get`` (a value or None) or
``policy.constrain``. Policies nest — inner ``use`` blocks shadow outer
keys — and are thread-local, so concurrent callers (a batcher's worker
thread and the main thread) cannot leak entries into each other.

A sharding entry is ``(mesh, placements)``: ``constrain`` redistributes a
DTensor to it (the port of ``with_sharding_constraint``). A set key on a
plain tensor raises: a sharding request is never silently ignored.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Iterator

_local = threading.local()


def _stack() -> list[dict]:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


@contextlib.contextmanager
def use(**kv: Any) -> Iterator[None]:
    """Activate policy entries for the enclosed calls (nestable)."""
    _stack().append(kv)
    try:
        yield
    finally:
        _stack().pop()


def get(key: str, default: Any = None) -> Any:
    """Innermost active value for ``key``, or ``default``."""
    for frame in reversed(_stack()):
        if key in frame:
            return frame[key]
    return default


def constrain(x, key: str):
    """``x`` when ``key`` is unset; else the DTensor ``x`` redistributed to
    the entry's ``(mesh, placements)``. A plain tensor under a set key
    raises ``TypeError``."""
    sh = get(key)
    if sh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        raise TypeError(
            f"policy key {key!r} asks for the sharding {sh!r}, but the "
            f"value is a plain {type(x).__name__}: only a DTensor can be "
            "laid out")
    mesh, pl = sh
    if tuple(x.placements) == tuple(pl):
        return x
    return x.redistribute(mesh, tuple(pl))


def active() -> dict:
    """Flattened view of the current policy (inner frames win)."""
    out: dict = {}
    for frame in _stack():
        out.update(frame)
    return out
