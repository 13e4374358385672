"""``ColdRepStore`` — the host-RAM cold tier of the rep hierarchy (a copy of
``repro.mem.cold``, taking device tensors as well as numpy rows).

Stage-1 representations that fall out of the hot ``UserRepCache`` (or are
pre-warmed offline) land here instead of being discarded: a byte-budgeted,
slab-allocated numpy arena per stage-2 boundary tensor, keyed by
``(user_id, feature_version)``. A later request for a cold user pays ONE
arena read (a few row copies) instead of a stage-1 recompute.

Why slabs, not one dict of per-user arrays: at the intended scale
(hundreds of thousands to millions of users) per-user numpy objects cost
an allocator round-trip + object overhead each, and a byte budget over
them is only enforceable by walking the dict. The arena instead allocates
``slab_rows``-row slabs per boundary lazily as occupancy grows, addresses
user rows as ``slot -> (slab, row)``, and recycles slots LRU when the
budget's row capacity is reached — steady-state churn allocates NOTHING
(rows are overwritten in place), and the slab count is bounded by
``ceil(capacity / slab_rows)`` forever.

Layout is discovered from the first ``put``: per-boundary dtype + per-row
shape, from which ``bytes_per_user`` and the slot ``capacity = cold_bytes
// bytes_per_user`` follow. Later rows must match the layout exactly — a
drifting rep shape is rejected, never silently resized.

Bit-exactness: a row goes in and comes out as raw bytes. A numpy row is
assigned into its slab row; a device tensor is copied into it with one
synchronous ``torch.from_numpy(slab_row).copy_(t)`` on the caller's
current CUDA stream (the engine passes its own tier stream), which has
finished when ``put`` returns — so a slot recycled by the next ``put``
can never be read by a copy still in flight. ``get`` hands back fresh
numpy copies. A demote -> promote round trip returns the identical bytes,
so serving from cold is bit-identical to recompute by construction.

Thread safety: one leaf lock around every operation. Callers (the hot
cache's removal listeners, the promotion worker, request threads) may hold
no cache lock here — ``UserRepCache`` fires listeners outside its lock —
and this store calls nothing back, so the lock order is acyclic.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Hashable, Mapping

import numpy as np
import torch

Key = tuple[Hashable, Hashable]          # (user_id, feature_version)

DEFAULT_SLAB_ROWS = 1024


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty(0, dtype=t.dtype).numpy().dtype


class ColdRepStore:
    """Byte-budgeted slab arena of stage-1 reps, keyed like the hot LRU.

    ``cold_bytes`` bounds the arena payload: once the per-user row size is
    known (first ``put``), the budget fixes a slot ``capacity`` and
    inserting past it recycles the least-recently-touched user's slot
    (``evictions``). ``slab_rows`` sizes the lazy allocation granule.
    """

    def __init__(self, cold_bytes: int,
                 slab_rows: int = DEFAULT_SLAB_ROWS):
        if cold_bytes < 1:
            raise ValueError(f"cold_bytes must be >= 1, got {cold_bytes}")
        if slab_rows < 1:
            raise ValueError(f"slab_rows must be >= 1, got {slab_rows}")
        self.cold_bytes = int(cold_bytes)
        self._slab_rows = int(slab_rows)
        # per-boundary layout, discovered from the first put
        self._layout: dict[str, tuple[tuple[int, ...], np.dtype]] | None = None
        self.bytes_per_user: int | None = None
        self.capacity: int | None = None
        self._slabs: dict[str, list[np.ndarray]] = {}
        # user_id -> (feature_version, slot); insertion order == LRU order
        self._map: OrderedDict[Hashable, tuple[Hashable, int]] = OrderedDict()
        self._free: list[int] = []       # recycled slots (LIFO)
        self._next_slot = 0              # high-water mark of virgin slots
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.evictions = 0               # budget-bound slot recycles

    # -- layout -------------------------------------------------------------
    def _discover_layout(self, row: Mapping[str, Any]) -> None:
        layout = {}
        per_user = 0
        for k in sorted(row):
            v = row[k]
            dtype = _np_dtype(v) if isinstance(v, torch.Tensor) else v.dtype
            layout[k] = (tuple(v.shape), np.dtype(dtype))
            per_user += int(np.prod(v.shape, dtype=np.int64)) * \
                np.dtype(dtype).itemsize
        self._layout = layout
        self.bytes_per_user = max(per_user, 1)
        self.capacity = max(1, self.cold_bytes // self.bytes_per_user)
        self._slab_rows = min(self._slab_rows, self.capacity)

    def _row_of(self, reps: Mapping[str, Any]) -> dict[str, Any]:
        """Normalize one user's reps to per-boundary rows (leading dim 1
        stripped; a tensor stays a tensor until it is copied into its
        slab), validating against the arena layout."""
        row = {}
        for k, v in reps.items():
            a = v if isinstance(v, torch.Tensor) else np.asarray(v)
            if a.ndim < 1 or a.shape[0] != 1:
                raise ValueError(
                    f"boundary {k!r}: cold-tier rows are per-user reps with "
                    f"leading dim 1, got shape {tuple(a.shape)}")
            row[k] = a[0]
        if self._layout is not None:
            if set(row) != set(self._layout):
                raise ValueError(
                    f"rep boundaries {sorted(row)} do not match the arena "
                    f"layout {sorted(self._layout)}")
            for k, (shape, dtype) in self._layout.items():
                v = row[k]
                vd = _np_dtype(v) if isinstance(v, torch.Tensor) else v.dtype
                if tuple(v.shape) != shape or vd != dtype:
                    raise ValueError(
                        f"boundary {k!r}: row {tuple(v.shape)}/{vd} does "
                        f"not match the arena layout {shape}/{dtype}")
        return row

    def _slab_of(self, boundary: str, slot: int) -> tuple[np.ndarray, int]:
        idx, off = divmod(slot, self._slab_rows)
        slabs = self._slabs.setdefault(boundary, [])
        shape, dtype = self._layout[boundary]
        while len(slabs) <= idx:
            slabs.append(np.empty((self._slab_rows,) + shape, dtype))
        return slabs[idx], off

    # -- mutation -----------------------------------------------------------
    def put(self, key: Key, reps: Mapping[str, Any]) -> None:
        """Store (demote/warm) one user's reps. An existing entry for the
        user is overwritten in place (any version); at capacity the
        least-recently-touched user's slot is recycled."""
        user_id, version = key
        row = self._row_of(reps)
        with self._lock:
            if self._layout is None:
                self._discover_layout(row)
                row = self._row_of(reps)   # validate against the new layout
            entry = self._map.get(user_id)
            if entry is not None:
                slot = entry[1]
            elif self._free:
                slot = self._free.pop()
            elif self._next_slot < self.capacity:
                slot = self._next_slot
                self._next_slot += 1
            else:
                # budget reached: recycle the LRU user's slot in place —
                # no new slab is ever allocated past capacity
                _, (_, slot) = self._map.popitem(last=False)
                self.evictions += 1
            for k, v in row.items():
                slab, off = self._slab_of(k, slot)
                if isinstance(v, torch.Tensor):
                    # synchronous: done before the slot can be recycled
                    torch.from_numpy(slab[off, ...]).copy_(v)
                else:
                    slab[off] = v
            self._map[user_id] = (version, slot)
            self._map.move_to_end(user_id)
            self.puts += 1

    def get(self, key: Key) -> dict[str, np.ndarray] | None:
        """Read one user's reps back as fresh leading-dim-1 numpy copies
        (LRU-refreshing). None on miss or version mismatch — a stale
        version is dropped (its slot recycles) rather than served."""
        user_id, version = key
        with self._lock:
            entry = self._map.get(user_id)
            if entry is None:
                self.misses += 1
                return None
            if entry[0] != version:
                # stale feature version: never servable again
                self._map.pop(user_id)
                self._free.append(entry[1])
                self.misses += 1
                return None
            self._map.move_to_end(user_id)
            self.hits += 1
            return self._read_slot(entry[1])

    def _read_slot(self, slot: int) -> dict[str, np.ndarray]:
        out = {}
        for k in self._layout:
            slab, off = self._slab_of(k, slot)
            out[k] = slab[off][None].copy()    # fresh (1, ...) row copy
        return out

    def peek(self, key: Key) -> dict[str, np.ndarray] | None:
        """``get`` without touching hit/miss counters or dropping stale
        versions (the promotion worker's re-read must not double-count
        the request path's cold hit)."""
        user_id, version = key
        with self._lock:
            entry = self._map.get(user_id)
            if entry is None or entry[0] != version:
                return None
            self._map.move_to_end(user_id)
            return self._read_slot(entry[1])

    def drop(self, user_id: Hashable) -> int:
        """Remove any version of ``user_id`` (invalidation hook); the slot
        recycles. Returns entries removed (0 or 1)."""
        with self._lock:
            entry = self._map.pop(user_id, None)
            if entry is None:
                return 0
            self._free.append(entry[1])
            return 1

    def clear(self) -> None:
        with self._lock:
            self._map.clear()
            self._free = []
            self._next_slot = 0

    # -- introspection ------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    def __contains__(self, key: Key) -> bool:
        user_id, version = key
        with self._lock:
            entry = self._map.get(user_id)
            return entry is not None and entry[0] == version

    def keys(self) -> list[Key]:
        with self._lock:
            return [(uid, ver) for uid, (ver, _) in self._map.items()]

    @property
    def slab_count(self) -> int:
        """Allocated slabs per boundary (bounded by
        ``ceil(capacity / slab_rows)`` — the no-leak invariant)."""
        with self._lock:
            return max((len(s) for s in self._slabs.values()), default=0)

    def stats(self) -> dict:
        with self._lock:
            slab_bytes = sum(int(s.nbytes) for slabs in self._slabs.values()
                             for s in slabs)
            return {
                "users": len(self._map),
                "capacity": self.capacity,
                "cold_bytes": self.cold_bytes,
                "bytes_per_user": self.bytes_per_user,
                "bytes": (len(self._map) * self.bytes_per_user
                          if self.bytes_per_user else 0),
                "slab_bytes": slab_bytes,
                "slabs": max((len(s) for s in self._slabs.values()),
                             default=0),
                "slab_rows": self._slab_rows,
                "hits": self.hits,
                "misses": self.misses,
                "puts": self.puts,
                "evictions": self.evictions,
            }
