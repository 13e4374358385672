"""Bounded user-representation store for the serving runtime (port of
``repro.serve.cache``: ``UserRepCache`` with its removal listeners, and the
device tier ``DeviceRepStore``).

Stage-1 outputs (user activations + per-``mari_dense`` partials +
decomposed-attention one-shot tensors) are cached per
``(user_id, feature_version)`` so repeat users skip the user tower.
``UserRepCache``:

* **LRU bound** — ``max_users`` caps live entries; inserting past the cap
  evicts the least-recently-*scored* user and bumps ``evictions``.
* **version supersede** — one live entry per user: putting a new
  ``feature_version`` frees every older version of that user immediately.
* **invalidation** — ``invalidate_user`` drops all versions of a user.
* **thread safety** — every mutation is taken under one lock.
* **removal listeners** — ``subscribe`` registers callbacks fired whenever
  a user's entry leaves the cache for ANY reason (LRU eviction, version
  supersede, invalidation, clear); the device tier below frees the user's
  slot through it. ``subscribe_removal`` delivers the full record
  ``(user_id, version, reps, reason)``. Listener snapshots are taken under
  the same lock acquisition as the mutation and callbacks fire strictly
  after release, so listeners may take their own locks.

``DeviceRepStore`` is the *device tier*: instead of re-stacking cached
per-user rows into a fresh ``(U, ...)`` table for every pack (a
``torch.cat`` per boundary per pack), it holds ONE persistent
``(capacity, ...)`` CUDA tensor per boundary and writes a single row per
new user with ``index_copy_``. Stage 2 then reads the persistent tables
by per-row *slot index*; freeing a user merely recycles its slot integer
— the stale row stays in the table but is never referenced, and the
engine's clamped gathers make even an out-of-range index safe.

Ordering replaces the reference's buffer donation: a row write is
enqueued on the current CUDA stream of the calling thread, which is the
engine's stream, the one its stage-2 launches run on. A stage-2 launch
enqueued before a write therefore reads the row as it was, and one
enqueued after reads the new row, with no copy and no wait. The
reference's copy-on-write fork (``fork_next_write``) is kept, as a
``clone()`` of the generation, for its contract and counters.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Hashable, Mapping, Sequence

import torch

Key = tuple[Hashable, Hashable]          # (user_id, feature_version)

# removal reasons delivered to subscribe_removal listeners
EVICT = "evict"            # LRU-bound eviction (reps still valid: demotable)
SUPERSEDE = "supersede"    # newer feature_version replaced the entry
INVALIDATE = "invalidate"  # explicit invalidate_user (GDPR/logout/backfill)
CLEAR = "clear"            # cache.clear()

# one removal: (user_id, feature_version, reps, reason)
Removal = tuple[Hashable, Hashable, Mapping[str, Any], str]


def _reps_nbytes(reps: Mapping[str, Any]) -> dict[str, int]:
    """Per-boundary byte sizes of one user's rep pytree (best effort)."""
    out = {}
    for k, v in reps.items():
        out[k] = int(getattr(v, "nbytes", 0))
    return out


class UserRepCache:
    """LRU mapping (user_id, feature_version) -> stage-1 output pytree.

    Stored keyed by user_id with the live version alongside, so the
    one-live-entry-per-user invariant costs O(1) per insert — a key scan
    per put would be O(cache size) and melt under miss traffic at the
    intended scale.
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
        self._listeners: list[Callable[[Hashable], None]] = []
        self._removal_listeners: list[Callable[..., None]] = []

    def subscribe(self, on_remove: Callable[[Hashable], None]) -> None:
        """Register a callback fired with ``user_id`` whenever that user's
        entry leaves the cache (eviction, supersede, invalidate, clear).
        Callbacks run outside the cache lock (snapshot taken inside the
        mutating acquisition, fired after release), so they may take
        their own locks. Registration takes the cache lock: with a
        shared cache, one scenario may subscribe while another is
        serving (and notifying)."""
        with self._lock:
            self._listeners.append(on_remove)

    def subscribe_removal(self, on_remove: Callable[..., None]) -> None:
        """Like ``subscribe`` but the callback receives the FULL removal
        record ``(user_id, feature_version, reps, reason)`` with reason
        one of ``evict`` / ``supersede`` / ``invalidate`` / ``clear``.
        Only ``evict`` removals carry reps that are still the live value
        for their key; the other reasons mean the reps are stale and must
        not be re-served."""
        with self._lock:
            self._removal_listeners.append(on_remove)

    def _snapshot_listeners(self) -> tuple[tuple, tuple]:
        """Caller must hold ``_lock`` — the one mutating acquisition."""
        return tuple(self._listeners), tuple(self._removal_listeners)

    def _fire(self, removed: Sequence[Removal],
              listeners: tuple, removal_listeners: tuple) -> None:
        """Deliver removal callbacks strictly OUTSIDE the cache lock, on
        the snapshots taken inside the mutating acquisition (no second
        acquisition — rules out lock-order inversion against listener
        locks such as the cold-tier arena lock)."""
        for uid, ver, reps, reason in removed:
            for cb in listeners:
                cb(uid)
            for cb in removal_listeners:
                cb(uid, ver, reps, reason)

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
        removed: list[Removal] = []
        with self._lock:
            # one live entry per user: a newer feature_version overwrites
            # (and frees) the old reps rather than accumulating beside them
            prev = self._entries.get(user_id)
            if prev is not None and prev[0] != version:
                removed.append((user_id, prev[0], prev[1], SUPERSEDE))
            self._entries[user_id] = (version, reps)
            self._entries.move_to_end(user_id)
            while self.max_users is not None and len(self._entries) > self.max_users:
                evicted, (ever, ereps) = self._entries.popitem(last=False)
                self.evictions += 1
                removed.append((evicted, ever, ereps, EVICT))
            listeners, removal_listeners = self._snapshot_listeners()
        self._fire(removed, listeners, removal_listeners)

    def invalidate_user(self, user_id: Hashable) -> int:
        """Drop the cached entry of ``user_id``; returns entries removed."""
        removed: list[Removal] = []
        with self._lock:
            entry = self._entries.pop(user_id, None)
            if entry is not None:
                removed.append((user_id, entry[0], entry[1], INVALIDATE))
            listeners, removal_listeners = self._snapshot_listeners()
        self._fire(removed, listeners, removal_listeners)
        return len(removed)

    def clear(self) -> None:
        with self._lock:
            removed = [(uid, ver, reps, CLEAR)
                       for uid, (ver, reps) in self._entries.items()]
            self._entries.clear()
            listeners, removal_listeners = self._snapshot_listeners()
        self._fire(removed, listeners, removal_listeners)

    def stats(self) -> dict:
        """Occupancy + byte accounting of the host tier.

        ``bytes`` is the total live-rep footprint; ``boundary_bytes`` maps
        each boundary tensor name to its summed bytes across users — the
        number to look at when sizing ``CachePlan.device_slots`` (the
        device tier costs ``capacity * bytes_per_user`` up front).
        """
        with self._lock:
            boundary: dict[str, int] = {}
            for _ver, reps in self._entries.values():
                for k, n in _reps_nbytes(reps).items():
                    boundary[k] = boundary.get(k, 0) + n
            return {
                "users": len(self._entries),
                "max_users": self.max_users,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "bytes": sum(boundary.values()),
                "boundary_bytes": boundary,
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: Key) -> bool:
        user_id, version = key
        with self._lock:
            entry = self._entries.get(user_id)
            return entry is not None and entry[0] == version

    def keys(self) -> list[Key]:
        with self._lock:
            return [(uid, ver) for uid, (ver, _) in self._entries.items()]


class DeviceRepStore:
    """Slot-allocated persistent device tables for stage-1 reps.

    One stacked ``(capacity, ...)`` tensor per boundary tensor, allocated
    from the first user row on that row's device and dtype (shapes
    validated against ``boundary_specs`` when provided). ``ensure_rows``
    maps ``(user, version)`` keys to slot indices, writing at most one row
    per new user with ``index_copy_`` — the tables are reused in place, so
    steady-state serving allocates nothing.

    Slot lifecycle: ``drop`` (wired to ``UserRepCache.subscribe``) returns
    a user's slot to the free list without touching table contents; the
    dead row is simply unreferenced until a later user recycles the slot.
    When every slot is pinned by the current call (``protect``) and none
    is free, ``ensure_rows`` yields ``None`` for the overflow users and the
    engine falls back to the re-stacking path for that pack.

    Writes go on the calling thread's current CUDA stream: callers must
    enqueue them on the stream their stage-2 launches use (the engine
    does both from its dispatching thread). ``fork_next_write`` makes the
    next write land in a ``clone()`` of the tables instead, leaving the
    generation that in-flight launches were handed untouched.
    """

    def __init__(self, capacity: int,
                 boundary_specs: Mapping[str, tuple[int, ...]] | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._specs = dict(boundary_specs) if boundary_specs else None
        self._tables: dict[str, torch.Tensor] | None = None
        self._slot_index: torch.Tensor | None = None   # arange(capacity)
        self._fork_pending = False
        # user -> (version, slot); insertion order == LRU order
        self._map: OrderedDict[Hashable, tuple[Hashable, int]] = OrderedDict()
        self._free: list[int] = list(range(capacity - 1, -1, -1))
        self._lock = threading.Lock()
        self.writes = 0      # row writes (new user or version supersede)
        self.hits = 0        # ensure_rows served from a live slot
        self.recycles = 0    # LRU slot steals (capacity pressure)
        self.drops = 0       # slots returned via drop()
        self.overflows = 0   # ensure_rows rows that could not get a slot
        self.forks = 0       # copy-on-write generation forks (writes armed
        #                      by fork_next_write under in-flight launches)
        self.quarantines = 0  # generation invalidations (failed write or
        #                       detected corruption)
        self._injector = None  # repro_torch.ft.FaultInjector, when injecting

    def set_fault_injector(self, injector) -> None:
        """Attach a ``FaultInjector``: row writes poke the ``slot_write``
        site (plus ``table_fork`` when a copy-on-write fork is armed). An
        injected error rides the failed-write path (the claimed slot is
        returned, the exception propagates to the engine, which
        quarantines the generation); the ``corrupt`` sentinel NaN-poisons
        the written row so detection happens at collect, never at serve."""
        self._injector = injector

    # -- allocation ---------------------------------------------------------
    def _alloc(self, row: Mapping[str, torch.Tensor]) -> None:
        tables = {}
        device = None
        for k, v in row.items():
            per_row = tuple(v.shape[1:])
            if self._specs is not None:
                spec = self._specs.get(k)
                if spec is not None and per_row != tuple(spec):
                    raise ValueError(
                        f"boundary {k!r}: rep row shape {per_row} does not "
                        f"match the split's boundary spec {tuple(spec)}")
            tables[k] = torch.zeros((self.capacity,) + per_row,
                                    dtype=v.dtype, device=v.device)
            device = v.device
        self._slot_index = torch.arange(self.capacity, device=device)
        self._tables = tables

    def _write(self, slot: int, reps: Mapping[str, torch.Tensor]) -> None:
        idx = self._slot_index[slot:slot + 1]
        for k, t in self._tables.items():
            t.index_copy_(0, idx, reps[k].to(t.dtype))

    # -- slot resolution ----------------------------------------------------
    def ensure_rows(self, items: Sequence[tuple[Hashable, Hashable,
                                                Mapping[str, Any]]],
                    protect: Sequence[Hashable] = ()) -> list[int | None]:
        """Resolve ``(user, version, reps)`` triples to device slots.

        Live ``(user, version)`` entries are LRU-bumped and reused without
        a write; new users take a free slot (or steal the LRU slot not in
        ``protect``) and get exactly one row write. Returns one slot per
        item, ``None`` where capacity ran out."""
        protected = set(protect)
        slots: list[int | None] = []
        with self._lock:
            for user, version, reps in items:
                entry = self._map.get(user)
                if entry is not None and entry[0] == version:
                    self._map.move_to_end(user)
                    self.hits += 1
                    slots.append(entry[1])
                    continue
                if entry is not None:
                    # version supersede: rewrite the user's own slot
                    slot = entry[1]
                elif self._free:
                    slot = self._free.pop()
                else:
                    slot = self._steal_lru(protected)
                    if slot is None:
                        self.overflows += 1
                        slots.append(None)
                        continue
                try:
                    if self._injector is not None:
                        act = self._injector.poke("slot_write", user=user,
                                                  slot=slot)
                        if self._fork_pending:
                            act = (self._injector.poke("table_fork",
                                                       user=user, slot=slot)
                                   or act)
                        if act == "corrupt":
                            # detectable corruption: NaN-poison the row
                            # being written — it reaches every score read
                            # from this slot and is caught at collect (the
                            # clean reps stay in the host LRU, so the
                            # rebuild after quarantine is clean)
                            reps = {k: torch.full_like(v, float("nan"))
                                    if v.is_floating_point() else v
                                    for k, v in reps.items()}
                    if self._tables is None:
                        self._alloc(reps)
                    if self._fork_pending:
                        # copy-on-write: in-flight launches keep the
                        # generation they were handed; this write and the
                        # ones after it land in the fork
                        self._tables = {k: t.clone()
                                        for k, t in self._tables.items()}
                        self._fork_pending = False
                        self.forks += 1
                    self._write(slot, reps)
                except Exception:
                    # a failed alloc/write (e.g. a rep row violating the
                    # boundary spec) must not leak the slot it claimed; a
                    # version supersede keeps its old entry
                    if entry is None:
                        self._free.append(slot)
                    raise
                self.writes += 1
                self._map[user] = (version, slot)
                self._map.move_to_end(user)
                protected.add(user)
                slots.append(slot)
        return slots

    def _steal_lru(self, protected: set) -> int | None:
        for user in self._map:          # iterates LRU -> MRU
            if user not in protected:
                _, slot = self._map.pop(user)
                self.recycles += 1
                return slot
        return None

    # -- lifecycle ----------------------------------------------------------
    def drop(self, user: Hashable) -> None:
        """Recycle ``user``'s slot (cache eviction/invalidation hook).
        The table row is left as-is: dead slots are never referenced, and
        stage-2 gathers clamp, so no zeroing pass is needed."""
        with self._lock:
            entry = self._map.pop(user, None)
            if entry is not None:
                self._free.append(entry[1])
                self.drops += 1

    def slot_of(self, user: Hashable) -> int | None:
        with self._lock:
            entry = self._map.get(user)
            return None if entry is None else entry[1]

    def quarantine(self) -> None:
        """Invalidate the current table generation wholesale.

        After a failed write or detected corruption nothing in the
        generation may be served again: the slot map clears, every slot
        returns to the free list, and the tables drop — they rebuild
        lazily from the host LRU on the next ``ensure_rows`` (one row
        write per user, like a cold start). The host tier is untouched:
        quarantine costs re-writes, never re-computes. Launches already
        enqueued on the stream finish before the freed memory is reused
        (the caching allocator is stream-ordered)."""
        with self._lock:
            self._map.clear()
            self._free = list(range(self.capacity - 1, -1, -1))
            self._tables = None
            self._fork_pending = False
            self.quarantines += 1

    def fork_next_write(self) -> None:
        """Arm copy-on-write for the NEXT row write: it lands in a
        ``clone()`` of the tables and leaves the generation in-flight
        launches were handed untouched. Later writes of the same
        resolution write the fork in place. Disarm with
        ``clear_fork_mark`` if the anticipated write never happens."""
        with self._lock:
            self._fork_pending = True

    def clear_fork_mark(self) -> None:
        with self._lock:
            self._fork_pending = False

    def is_live(self, user: Hashable, version: Hashable) -> bool:
        """True iff ``(user, version)`` already holds a slot, i.e. an
        ``ensure_rows`` call for it would be a pure hit — no row write, no
        LRU steal."""
        with self._lock:
            entry = self._map.get(user)
            return entry is not None and entry[0] == version

    @property
    def tables(self) -> dict[str, torch.Tensor] | None:
        """The live per-boundary ``(capacity, ...)`` tables (None until the
        first write). Read-only for callers; a later ``ensure_rows`` may
        replace the dict (fork, quarantine)."""
        return self._tables

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    def stats(self) -> dict:
        with self._lock:
            boundary = ({k: int(t.nbytes) for k, t in self._tables.items()}
                        if self._tables is not None else {})
            return {
                "capacity": self.capacity,
                "resident": len(self._map),
                "free_slots": len(self._free),
                "writes": self.writes,
                "hits": self.hits,
                "recycles": self.recycles,
                "drops": self.drops,
                "overflows": self.overflows,
                "forks": self.forks,
                "quarantines": self.quarantines,
                "bytes": sum(boundary.values()),
                "boundary_bytes": boundary,
            }
