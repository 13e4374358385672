"""Bounded user-representation store for the serving runtime (port of
``repro.serve.cache.UserRepCache`` without its removal listeners, which
only the device and cold tiers — not ported yet — subscribe to).

Stage-1 outputs (user activations + per-``mari_dense`` partials +
decomposed-attention one-shot tensors) are cached per
``(user_id, feature_version)`` so repeat users skip the user tower:

* **LRU bound** — ``max_users`` caps live entries; inserting past the cap
  evicts the least-recently-*scored* user and bumps ``evictions``.
* **version supersede** — one live entry per user: putting a new
  ``feature_version`` frees every older version of that user immediately.
* **invalidation** — ``invalidate_user`` drops all versions of a user.
* **thread safety** — every mutation is taken under one lock.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Hashable, Mapping

Key = tuple[Hashable, Hashable]          # (user_id, feature_version)


class UserRepCache:
    """LRU mapping (user_id, feature_version) -> stage-1 output dict.

    Stored keyed by user_id with the live version alongside, so the
    one-live-entry-per-user invariant costs O(1) per insert.
    """

    def __init__(self, max_users: int | None = None):
        if max_users is not None and max_users < 1:
            raise ValueError(f"max_users must be >= 1, got {max_users}")
        self.max_users = max_users
        # user_id -> (feature_version, reps); insertion order == LRU order
        self._entries: OrderedDict[
            Hashable, tuple[Hashable, Mapping[str, Any]]] = OrderedDict()
        self._lock = threading.Lock()
        self.evictions = 0               # LRU-bound evictions only
        self.hits = 0
        self.misses = 0

    def get(self, key: Key) -> Mapping[str, Any] | None:
        user_id, version = key
        with self._lock:
            entry = self._entries.get(user_id)
            if entry is None or entry[0] != version:
                self.misses += 1
                return None
            self._entries.move_to_end(user_id)
            self.hits += 1
            return entry[1]

    def put(self, key: Key, reps: Mapping[str, Any]) -> None:
        user_id, version = key
        with self._lock:
            # one live entry per user: a newer feature_version overwrites
            # (and frees) the old reps rather than accumulating beside them
            self._entries[user_id] = (version, reps)
            self._entries.move_to_end(user_id)
            while (self.max_users is not None
                   and len(self._entries) > self.max_users):
                self._entries.popitem(last=False)
                self.evictions += 1

    def invalidate_user(self, user_id: Hashable) -> int:
        """Drop the cached entry of ``user_id``; returns entries removed."""
        with self._lock:
            return int(self._entries.pop(user_id, None) is not None)

    def stats(self) -> dict:
        """Occupancy + byte accounting: ``bytes`` is the live-rep
        footprint, ``boundary_bytes`` its split per boundary tensor."""
        with self._lock:
            boundary: dict[str, int] = {}
            for _ver, reps in self._entries.values():
                for k, v in reps.items():
                    boundary[k] = boundary.get(k, 0) + int(
                        getattr(v, "nbytes", 0))
            return {
                "users": len(self._entries),
                "max_users": self.max_users,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "bytes": sum(boundary.values()),
                "boundary_bytes": boundary,
            }

    def keys(self) -> list[Key]:
        with self._lock:
            return [(uid, ver) for uid, (ver, _) in self._entries.items()]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: Key) -> bool:
        user_id, version = key
        with self._lock:
            entry = self._entries.get(user_id)
            return entry is not None and entry[0] == version
