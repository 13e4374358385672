"""Thread-local sharding policy (port of ``repro.dist.policy``).

Model code (``repro_torch.models.transformer``) stays mesh-agnostic: the
launch layer activates a policy for the duration of a call::

    with policy.use(moe_shard_axes=("data",)):
        ...

and the model consults it via ``policy.get`` (a value or None) or
``policy.constrain``. Policies nest — inner ``use`` blocks shadow outer
keys — and are thread-local, so concurrent callers (a batcher's worker
thread and the main thread) cannot leak entries into each other.

The port runs on one device and has no DTensor rule sets yet, so a set
key is refused where the model would act on it: ``constrain`` raises
``NotImplementedError`` rather than return ``x`` unsharded, and so does
the model's ``moe_shard_axes`` branch. A sharding request is never
silently ignored.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Iterator

_local = threading.local()

# what a set key waits for
SHARDING_SLICE = ("the DTensor sharding rule sets (ROADMAP Queue 1, the "
                  "sharding item) are not ported yet")


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
    """``x`` when ``key`` is unset; a set key raises ``NotImplementedError``
    (the reference applies ``with_sharding_constraint`` there)."""
    sh = get(key)
    if sh is None:
        return x
    raise NotImplementedError(
        f"policy key {key!r} asks for a sharding constraint ({sh!r}), but "
        f"{SHARDING_SLICE}")


def active() -> dict:
    """Flattened view of the current policy (inner frames win)."""
    out: dict = {}
    for frame in _stack():
        out.update(frame)
    return out
