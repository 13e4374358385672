"""``RepWarmer`` — the bulk warming feed into the cold tier (a copy of
``repro.mem.warm``).

Warming precomputes stage-1 representations OFFLINE (from a training
refresh, a nightly job, a launch ramp) straight into the cold arena, so a
warmed user's first live request is already a cold hit: one arena read,
zero stage-1 compute on the request path.

Bit-identity contract: the warmer runs the engine's OWN compiled stage 1
(its ``CompiledRun``) per user at the live path's exact ``(1, ...)`` feed
shapes — never a differently-batched variant — so a warmed rep is
bit-identical to what the request path would have computed. Batching
happens at the dispatch level instead: the calls of a ``batch``-sized
chunk are enqueued without waiting and synchronised ONCE per chunk
(``sync``), then each distinct result is copied to the host once
(``to_host``) and fanned out to every user id that shares it.

That is only sound because every call returns tensors of its own: a
compiled stage 1 overwrites its graph's static outputs on every replay,
and ``CompiledRun`` clones them out behind the replay, so the chunk's
results never alias one another.

Duplicate-feed memoization: callers replaying one feed dict across many
user ids (synthetic universes, template users, the benchmarks' pool-reuse
pattern) pay stage 1 once per DISTINCT feeds object per chunk — identical
inputs compute identical rows, so the memo is value-exact.
"""
from __future__ import annotations

from typing import Any, Callable, Hashable, Iterable, Mapping

import numpy as np
import torch

Item = tuple[Hashable, Hashable, Mapping[str, Any]]
#      (user_id, feature_version, user_feeds)


def _to_numpy(reps: Mapping[str, Any]) -> dict[str, np.ndarray]:
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in reps.items()}


class RepWarmer:
    """Batched offline stage-1 feed into a ``ColdRepStore``.

    ``stage1_fn(params, user_feeds) -> reps`` is the (compiled,
    non-blocking) user-tower call; ``cold`` the destination arena;
    ``batch`` the chunk size between device syncs. ``sync()`` waits for
    the chunk's calls and ``to_host(reps)`` copies one result to numpy
    (the engine runs both on its own streams; the defaults suit host
    arrays and CPU tensors).
    """

    def __init__(self, stage1_fn, cold, *, batch: int = 256, tracer=None,
                 sync: Callable[[], None] | None = None,
                 to_host: Callable[[Mapping[str, Any]],
                                   Mapping[str, np.ndarray]] = _to_numpy):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.stage1_fn = stage1_fn
        self.cold = cold
        self.batch = batch
        self._tracer = tracer
        self._sync = sync
        self._to_host = to_host
        self.warmed = 0              # users written into the cold tier
        self.stage1_launches = 0     # distinct stage-1 dispatches paid

    def set_tracer(self, tracer) -> None:
        """Attach a ``Tracer`` for the ``warm`` instants (or None)."""
        self._tracer = tracer

    def warm(self, items: Iterable[Item], params) -> int:
        """Precompute reps for ``items`` into the cold tier; returns the
        number of users warmed. Items are ``(user_id, feature_version,
        user_feeds)`` with user feeds at leading dim 1."""
        items = list(items)
        total = 0
        for lo in range(0, len(items), self.batch):
            chunk = items[lo:lo + self.batch]
            # launch the whole chunk without blocking; memoize by feeds
            # object identity (same object => same values => same reps)
            memo: dict[int, Any] = {}
            launched: list[tuple[Hashable, Hashable, int]] = []
            for uid, ver, feeds in chunk:
                fid = id(feeds)
                if fid not in memo:
                    memo[fid] = self.stage1_fn(params, feeds)
                    self.stage1_launches += 1
                launched.append((uid, ver, fid))
            # one sync per chunk, then each distinct result to the host
            # ONCE, fanned out to every user id that shares it (the arena
            # copies rows into its slabs, so sharing the source is safe)
            if self._sync is not None:
                self._sync()
            memo_np = {fid: self._to_host(r) for fid, r in memo.items()}
            for uid, ver, fid in launched:
                self.cold.put((uid, ver), memo_np[fid])
            total += len(launched)
            self.warmed += len(launched)
            if self._tracer is not None:
                self._tracer.instant("warm", users=len(launched),
                                     total=self.warmed)
        return total
