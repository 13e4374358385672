"""Hierarchical memory tier for the serving runtime (port of ``repro.mem``;
``MemPlan``).

MaRI's win is reusing user-side precompute; this package is what lets
"reusing" reach past one card's memory. It layers a third tier UNDER the
hot LRU (``repro_torch.serve.cache.UserRepCache``) and the device slot
tables (``DeviceRepStore``):

* ``cold``    — ``ColdRepStore``: a byte-budgeted, slab-allocated host-RAM
  numpy arena per stage-2 boundary, keyed ``(user_id, feature_version)``.
  Hot-LRU eviction DEMOTES reps here (one synchronous device-to-host copy
  per boundary) instead of discarding them; a later request pays one
  arena read and a copy back to the card instead of a stage-1 recompute.
* ``promote`` — ``PromotionWorker``: a background thread applying a
  Zipf-friendly frequency gate (k touches within a window) before copying
  a cold row back onto the card and into the hot LRU — one-shot tail
  users never thrash the hot/device tiers, and promotion never blocks a
  request.
* ``warm``    — ``RepWarmer``: the bulk offline feed — the engine's
  compiled stage 1, synchronised once per chunk, straight into the cold
  arena, so a warmed user's first live request is already a hit.

Tier walk on a request: hot LRU -> device slots on a hot hit; on a hot
miss, the cold arena (serve from the read, touch the promoter, stay OFF
the device tier); only a full miss recomputes stage 1. Cold rows are raw
copies of stage-1 outputs and cold-served packs take the engine's
re-stacking route, so a cold-served score equals a recompute-served one
at the same pack shape bit for bit.

Everything is driven by ``ServePlan.mem`` (``repro_torch.serve.plan.
MemPlan``); the engine wires the tiers, the obs instants (``cold_hit`` /
``cold_miss`` / ``promote`` / ``demote`` / ``warm``) and the per-tier
gauges.
"""
from repro_torch.mem.cold import ColdRepStore  # noqa: F401
from repro_torch.mem.promote import PromotionWorker  # noqa: F401
from repro_torch.mem.warm import RepWarmer  # noqa: F401
