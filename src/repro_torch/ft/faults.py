"""Deterministic fault injection for the serving runtime (port of
``repro.ft.faults``, the same sites, kinds, spec grammar and per-site RNG).

A ``FaultInjector`` is a registry of *armed fault specs* keyed by named
sites threaded through the serve stack.  Each hot-path hook calls
``injector.poke(site)``; when a spec for that site decides to fire, the
poke either

* raises a typed ``FaultInjected`` (kind ``error``),
* sleeps ``delay_ms`` milliseconds (kind ``delay``), or
* returns the ``CORRUPT`` sentinel (kind ``corrupt``) — the caller then
  poisons its payload with NaN, which propagates through stage-2 matmuls
  to the scores and is *detected* at collect (the detectable-corruption
  contract: a corrupted response is never silently served).

Everything is deterministic: each site draws from its own
``random.Random`` seeded ``crc32(site) ^ seed`` (``crc32``, not
``hash()``, which varies per process), and ``count=K`` / ``after=N``
params bound exactly which pokes fire regardless of probability.  The
chaos harness leans on this to script breaker transitions: with
``count``-bounded ``p=1`` specs the Nth failure — and therefore the
open → half-open → close walk — lands on the same poke every run.

Spec strings (carried on ``ServePlan.ft.sites``)::

    site:kind[:key=value[,key=value...]]

    slot_write:error                      every slot write fails
    slot_write:error:count=4              ... only the first 4
    stage2_dispatch:error:after=10,count=3  pokes 11..13 fail
    collect:corrupt:p=0.5                 each collect corrupts w.p. 0.5
    transfer_copy:delay:delay_ms=25       25 ms stall per transfer

Module import is stdlib-only (``FaultInjected`` is imported lazily from
``repro_torch.serve.errors`` at fire time) so plan validation can parse
specs without pulling torch.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
import zlib

# The injection sites wired through the serve stack.  Specs naming any
# other site are rejected at plan construction.  All nine of the
# reference's sites are kept, so a spec valid in one package is valid in
# the other; the port's serve stack pokes every one but spmd_heartbeat
# (distributed serving is not ported).
SITES = (
    "stage1",           # engine: user-rep compute (after a cache miss)
    "pack",             # engine: greedy pack formation / write barrier
    "stage2_dispatch",  # engine: stage-2 executable launch
    "transfer_copy",    # engine: host->device candidate buffer transfer
    "slot_write",       # cache: device-table row write (index_copy_)
    "table_fork",       # cache: copy-on-write generation fork (clone)
    "collect",          # engine: per-pack result unpack
    "worker_loop",      # batcher: dispatch-loop group formation
    "spmd_heartbeat",   # dist runner: per-step worker heartbeat
)

FAULT_SITES = SITES               # the public alias, as the reference names it

KINDS = ("error", "delay", "corrupt")

#: Sentinel returned by ``poke`` for kind ``corrupt``.  Callers that can
#: poison a float payload do so with NaN; sites with no payload treat it
#: like an error.
CORRUPT = "corrupt"


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One parsed fault spec: where, what, and exactly when."""

    site: str
    kind: str
    p: float = 1.0              # fire probability per eligible poke
    count: int | None = None    # max fires (None = unbounded)
    after: int = 0              # skip the first N pokes at this site
    delay_ms: float = 10.0      # stall length for kind "delay"

    def describe(self) -> str:
        parts = [f"{self.site}:{self.kind}"]
        opts = []
        if self.p < 1.0:
            opts.append(f"p={self.p:g}")
        if self.count is not None:
            opts.append(f"count={self.count}")
        if self.after:
            opts.append(f"after={self.after}")
        if self.kind == "delay":
            opts.append(f"delay_ms={self.delay_ms:g}")
        if opts:
            parts.append(",".join(opts))
        return ":".join(parts)


def parse_fault_spec(spec: str) -> FaultSpec:
    """Parse ``site:kind[:k=v,...]`` into a ``FaultSpec``.

    Raises ``ValueError`` with a pointed message on any malformed piece —
    plan validation wraps this into a ``PlanError`` so a typo'd chaos
    schedule fails at construction, not mid-run.
    """
    if not isinstance(spec, str) or not spec.strip():
        raise ValueError("fault spec must be a non-empty string")
    head, _, tail = spec.strip().partition(":")
    kind, _, params = tail.partition(":")
    site = head.strip()
    kind = kind.strip()
    if site not in SITES:
        raise ValueError(
            f"unknown site {site!r} (sites: {', '.join(SITES)})")
    if kind not in KINDS:
        raise ValueError(
            f"unknown kind {kind!r} (kinds: {', '.join(KINDS)})")
    kw: dict = {}
    if params.strip():
        for piece in params.split(","):
            key, eq, val = piece.partition("=")
            key = key.strip()
            if not eq or not val.strip():
                raise ValueError(f"malformed param {piece!r} (want k=v)")
            if key == "p":
                kw["p"] = float(val)
                if not 0.0 < kw["p"] <= 1.0:
                    raise ValueError(f"p={val} outside (0, 1]")
            elif key == "count":
                kw["count"] = int(val)
                if kw["count"] < 1:
                    raise ValueError(f"count={val} must be >= 1")
            elif key == "after":
                kw["after"] = int(val)
                if kw["after"] < 0:
                    raise ValueError(f"after={val} must be >= 0")
            elif key == "delay_ms":
                kw["delay_ms"] = float(val)
                if kw["delay_ms"] < 0:
                    raise ValueError(f"delay_ms={val} must be >= 0")
            else:
                raise ValueError(
                    f"unknown param {key!r} (params: p, count, after, "
                    f"delay_ms)")
    if "delay_ms" in kw and kind != "delay":
        raise ValueError("delay_ms only applies to kind 'delay'")
    return FaultSpec(site=site, kind=kind, **kw)


class _ArmedSpec:
    """Mutable per-spec fire state (guarded by the injector lock)."""

    __slots__ = ("spec", "rng", "pokes", "fired")

    def __init__(self, spec: FaultSpec, seed: int):
        self.spec = spec
        # crc32 keeps the per-site stream stable across processes and
        # PYTHONHASHSEED values; xor-ing the kind in separates streams
        # when one site carries several probabilistic specs.
        self.rng = random.Random(
            zlib.crc32(f"{spec.site}:{spec.kind}".encode()) ^ seed)
        self.pokes = 0
        self.fired = 0


class FaultInjector:
    """Seeded, thread-safe fault registry.

    ``poke(site)`` is the single hot-path entry: a no-op (None) when the
    injector is disarmed or no spec for the site elects to fire, else it
    raises / sleeps / returns ``CORRUPT`` per the spec kind.  ``armed``
    starts True; the chaos harness disarms during warmup so compile-time
    pokes never consume deterministic fault counts.
    """

    def __init__(self, sites, seed: int = 0, tracer=None):
        self._lock = threading.Lock()
        self._tracer = tracer
        self._armed = True
        self.seed = seed
        self._specs: dict[str, list[_ArmedSpec]] = {}
        for raw in sites:
            spec = raw if isinstance(raw, FaultSpec) else parse_fault_spec(raw)
            self._specs.setdefault(spec.site, []).append(
                _ArmedSpec(spec, seed))
        self.fired: dict[str, int] = {s: 0 for s in self._specs}
        self.total_fired = 0

    # -- arming ---------------------------------------------------------
    @property
    def armed(self) -> bool:
        return self._armed

    def set_armed(self, flag: bool) -> None:
        """Arm/disarm all specs.  Disarmed pokes do not advance poke
        counters, so ``after=N`` offsets count live traffic only."""
        with self._lock:
            self._armed = bool(flag)

    # -- the hot-path hook ----------------------------------------------
    def poke(self, site: str, **ctx) -> str | None:
        """Maybe fire a fault at ``site``.

        Returns None (no fault) or ``CORRUPT``; raises ``FaultInjected``
        for kind ``error``; sleeps then returns None for kind ``delay``.
        Extra kwargs ride onto the trace instant for debuggability.
        """
        with self._lock:
            specs = self._specs.get(site)
            if not self._armed or not specs:
                return None
            hit: FaultSpec | None = None
            for st in specs:
                st.pokes += 1
                if hit is not None:
                    continue                     # at most one fire per poke
                spec = st.spec
                if st.pokes <= spec.after:
                    continue
                if spec.count is not None and st.fired >= spec.count:
                    continue
                if spec.p < 1.0 and st.rng.random() >= spec.p:
                    continue
                st.fired += 1
                self.fired[site] += 1
                self.total_fired += 1
                hit = spec
        if hit is None:
            return None
        if self._tracer is not None:
            self._tracer.instant("fault_injected", site=site, kind=hit.kind,
                                 **ctx)
        if hit.kind == "delay":
            time.sleep(hit.delay_ms / 1e3)
            return None
        if hit.kind == "corrupt":
            return CORRUPT
        from repro_torch.serve.errors import FaultInjected
        raise FaultInjected(f"injected fault at site {site!r}", site=site)

    # -- introspection --------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "armed": self._armed,
                "total_fired": self.total_fired,
                "fired": dict(self.fired),
                "specs": [st.spec.describe()
                          for specs in self._specs.values()
                          for st in specs],
            }

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"FaultInjector(seed={self.seed}, "
                f"fired={self.total_fired}, armed={self._armed})")
