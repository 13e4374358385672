"""Fault-tolerance control plane (port of ``repro.ft.failures``): the
DETECTION and PLANNING layers are real code, the transport (who pings
whom) an injectable clock / callback.

* HeartbeatMonitor — declares a worker dead after ``timeout`` without a
  heartbeat; the distributed runner beats it once per step (its
  ``spmd_heartbeat`` fault site simulates missed beats).
* plan_elastic_remesh — given the surviving device count, picks the
  largest valid (data, model) mesh that preserves the TP degree (model
  axis is topology-constrained; DP shrinks), and reports the batch
  re-split.
* HedgePolicy — straggler mitigation for serving; it lives in
  ``repro_torch.serve.hedging`` and is re-exported here lazily, so this
  module stays importable without the serve stack.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable


def __getattr__(name):            # lazy back-compat re-export (PEP 562)
    if name == "HedgePolicy":
        from repro_torch.serve.hedging import HedgePolicy
        return HedgePolicy
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class HeartbeatMonitor:
    def __init__(self, workers: list[str], timeout: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.clock = clock
        self.last_seen = {w: clock() for w in workers}
        self._removed: set[str] = set()

    def heartbeat(self, worker: str) -> None:
        # removal is sticky: a stray beat from a decommissioned worker
        # (e.g. one the remesh already planned around) must not silently
        # re-register it — rejoining goes through the explicit add()
        if worker in self._removed:
            return
        self.last_seen[worker] = self.clock()

    def add(self, worker: str) -> None:
        """Explicitly (re-)register a worker, clearing sticky removal."""
        self._removed.discard(worker)
        self.last_seen[worker] = self.clock()

    def dead(self) -> list[str]:
        now = self.clock()
        return [w for w, t in self.last_seen.items()
                if now - t > self.timeout]

    def alive(self) -> list[str]:
        now = self.clock()
        return [w for w, t in self.last_seen.items()
                if now - t <= self.timeout]

    def remove(self, worker: str) -> None:
        self.last_seen.pop(worker, None)
        self._removed.add(worker)


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    old_shape: tuple[int, ...]
    new_shape: tuple[int, ...]
    axes: tuple[str, ...]
    dropped_devices: int
    global_batch_scale: float     # keep per-device batch constant
    notes: str = ""


def plan_elastic_remesh(old_shape: tuple[int, ...], axes: tuple[str, ...],
                        surviving_devices: int) -> ElasticPlan:
    """Shrink DP axes to the largest power-of-two that fits the survivors
    while preserving the model (TP) axis — TP re-layout would need a full
    resharding of every weight, DP shrink only re-splits the batch."""
    model = old_shape[axes.index("model")]
    if surviving_devices < model:
        raise ValueError(
            f"cannot preserve TP={model} with {surviving_devices} devices; "
            "full re-layout required")
    dp_budget = surviving_devices // model
    new_dp = 1
    while new_dp * 2 <= dp_budget:
        new_dp *= 2
    if "pod" in axes:
        # collapse pod into data when a pod is partially lost
        new_shape = tuple(
            {"pod": 1, "data": new_dp, "model": model}[a] for a in axes)
    else:
        new_shape = tuple(
            {"data": new_dp, "model": model}[a] for a in axes)
    old_dp = 1
    for a, s in zip(axes, old_shape):
        if a != "model":
            old_dp *= s
    return ElasticPlan(
        old_shape=old_shape, new_shape=new_shape, axes=axes,
        dropped_devices=old_dp * model - surviving_devices,
        global_batch_scale=new_dp / old_dp,
        notes=f"DP {old_dp}->{new_dp}, TP preserved at {model}")
