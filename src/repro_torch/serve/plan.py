"""``ServePlan`` — the frozen, validated, JSON-serializable serving config
(port of ``repro.serve.plan``, limited to the sections this port serves).

Sections, with the reference's field names so a plan means the same in both
packages:

* ``GraphPlan``  — ``mode`` (vani/uoi/mari), ``reparam_attention``,
  ``fragment``, ``group_by_domain``, ``two_stage``;
* ``KernelPlan`` — ``use_pallas`` (here: the hand-written CUDA kernels),
  ``kernel_gather``, ``gather_attention``, ``precat_weights``;
* ``BatchPlan``  — ``max_batch``, ``min_bucket``, ``max_users_per_batch``,
  ``hedging``, and the batcher's ``linger_ms``, ``max_coalesce``,
  ``deadline_linger_frac``, ``continuous``, ``max_inflight``,
  ``admission``, ``shed_queue_depth``, ``degrade_queue_depth``,
  ``degrade_frac``, ``deadline_headroom_ms``;
* ``CachePlan``  — ``cache_user_reps``, ``max_cached_users``,
  ``device_resident`` (persistent slot-allocated CUDA rep tables),
  ``device_slots``;
* ``FaultPlan``  — section key ``ft``: ``inject`` + ``seed`` + ``sites``
  (deterministic fault injection, ``repro_torch.ft.faults``), ``retries``
  / ``retry_backoff_ms`` / ``retry_jitter`` (the batcher's retries),
  ``breaker_failures`` / ``breaker_cooldown_ms`` / ``breaker_probes`` (the
  circuit breaker on the device-resident stage-2 path);
* ``ObsPlan``    — ``trace`` (the ring-buffer tracer,
  ``repro_torch.obs``), ``trace_capacity``, ``sample_every``, ``metrics``
  (the engine's histograms and counter snapshot). Tracing is off by
  default, as in the reference;
* ``MemPlan``    — ``cold_tier`` (the host-RAM cold rep arena under the
  hot LRU, ``repro_torch.mem``; off by default), ``cold_bytes`` (its byte
  budget), ``promote_touches`` / ``promote_window_s`` (the async
  promotion gate: k cold hits within a sliding window), ``warm_batch``
  (the bulk ``warm()`` feed's chunk size between device syncs).

The reference's other section (shard) is not ported yet: naming it is a
``PlanError``, never a silent no-op.

Resolution table (the rows that touch these fields):

====================================================  =======================
combination                                           resolution
====================================================  =======================
unknown section or field, wrong-typed value           reject (``PlanError``)
``mode`` outside vani/uoi/mari                        reject
``two_stage=True`` with ``mode="vani"``               reject
non-positive ``max_batch`` / ``min_bucket`` /         reject
``max_users_per_batch`` / ``max_cached_users`` /
``device_slots`` / ``max_coalesce`` / ``max_inflight`` /
``shed_queue_depth`` / ``degrade_queue_depth``;
negative ``linger_ms`` / ``deadline_headroom_ms``;
``deadline_linger_frac`` outside [0, 1];
``degrade_frac`` outside (0, 1]
``degrade_queue_depth > shed_queue_depth``            reject
admission thresholds (``shed_queue_depth`` /          drop them + warn
``degrade_queue_depth`` / positive
``deadline_headroom_ms``) without ``admission=True``
``device_resident`` without ``cache_user_reps``       drop
                                                      ``device_resident``
                                                      + warn
``device_resident`` with ``hedging``                  drop ``hedging`` +
                                                      warn
``device_slots`` without ``device_resident``          drop ``device_slots``
                                                      + warn
``kernel_gather`` without ``use_pallas``              drop ``kernel_gather``
                                                      + warn
``gather_attention`` without decomposed attention     drop
(``mode!="mari"`` or no ``reparam_attention``)        ``gather_attention``
                                                      + warn
``reparam_attention``/``fragment``/                   drop them + warn
``group_by_domain`` with ``mode != "mari"``
``min_bucket > max_batch``                            clamp ``min_bucket``
malformed ``ft.sites`` spec (unknown site / kind /    reject
param, bad value)
negative ``ft.retries`` / ``ft.retry_backoff_ms``     reject
/ ``ft.breaker_failures`` /
``ft.breaker_cooldown_ms``; ``ft.retry_jitter``
outside [0, 1]; ``ft.breaker_probes < 1``
``ft.sites`` / ``ft.seed`` without ``ft.inject``      drop them + warn
``ft.retry_backoff_ms`` / ``ft.retry_jitter``         drop them + warn
(non-default) without ``ft.retries > 0``
``ft.breaker_failures > 0`` without                   drop breaker + warn
``cache.device_resident``
``ft.breaker_cooldown_ms`` / ``ft.breaker_probes``    drop them + warn
(non-default) without ``ft.breaker_failures > 0``
``obs.trace_capacity < 1`` / ``obs.sample_every < 1``  reject
``obs.trace_capacity`` / ``obs.sample_every``         drop them + warn
(non-default) without ``obs.trace``
non-positive ``mem.cold_bytes`` /                     reject
``mem.promote_touches`` / ``mem.promote_window_s``
/ ``mem.warm_batch``
``mem.cold_tier`` without ``cache.cache_user_reps``   drop ``cold_tier`` +
                                                      warn
``mem.cold_bytes`` / ``promote_touches`` /            drop them + warn
``promote_window_s`` / ``warm_batch``
(non-default) without ``mem.cold_tier``
====================================================  =======================

Round-trip: ``ServePlan.from_json(plan.to_json()) == plan``.
"""
from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Any, Mapping

from repro_torch.ft.faults import parse_fault_spec

MODES = ("vani", "uoi", "mari")


class PlanError(ValueError):
    """An invalid ``ServePlan`` combination that cannot be auto-resolved."""


class PlanResolutionWarning(UserWarning):
    """An invalid combination was auto-resolved per the resolution table."""


@dataclasses.dataclass(frozen=True)
class GraphPlan:
    """Inference paradigm and MaRI-rewrite shape."""
    mode: str = "mari"                 # "vani" | "uoi" | "mari"
    reparam_attention: bool = False    # mari: decompose eligible attention
    fragment: bool = False             # mari: fragmented-layout rewrite
    group_by_domain: bool = False      # mari: group weight blocks by domain
    two_stage: bool | None = None      # None = infer (uoi/mari split)


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """Kernel dispatch: ``use_pallas`` selects the CUDA kernels."""
    use_pallas: bool = False           # mari_matmul / gather_einsum kernels
    kernel_gather: bool = False        # rep-table gather at acc-init load
    gather_attention: bool = False     # gather-at-load attention boundaries
    precat_weights: bool = True        # build-time grouped-weight concat


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """Bucketing, cross-user coalescing, SLO linger, hedging, the
    continuous dispatch loop, and SLO-tiered admission control."""
    max_batch: int = 4096              # stage-2 row budget per dispatch
    min_bucket: int = 128              # smallest pow2 candidate bucket
    max_users_per_batch: int = 8       # rep-table slot budget per pack
    hedging: bool = True               # duplicate straggling dispatches
    linger_ms: float = 2.0             # batcher window for co-arrivals
    max_coalesce: int = 64             # request budget per batcher group
    deadline_linger_frac: float = 0.25  # linger shrink for deadline SLO
    continuous: bool = True            # pack group k+1 while k executes
    max_inflight: int = 2              # launched-but-uncollected groups
    admission: bool = False            # SLO-tiered admission controller
    shed_queue_depth: int | None = None    # best_effort shed threshold
    degrade_queue_depth: int | None = None  # best_effort degrade threshold
    degrade_frac: float = 0.5          # candidate fraction kept on degrade
    deadline_headroom_ms: float = 0.0  # shed infeasible deadline budgets


@dataclasses.dataclass(frozen=True)
class CachePlan:
    """Bounded LRU user-representation store + optional device tier."""
    cache_user_reps: bool = True
    max_cached_users: int | None = None    # None = unbounded
    device_resident: bool = False          # persistent CUDA rep tables
    device_slots: int | None = None        # device-tier capacity; None =
    #                                        max_cached_users (or 64)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Fault tolerance: deterministic injection + self-healing recovery
    (``repro_torch.ft``)."""
    inject: bool = False               # arm the fault injector
    seed: int = 0                      # per-site deterministic RNG seed
    sites: tuple = ()                  # "site:kind[:k=v,...]" spec strings
    retries: int = 0                   # per-request retry budget (0 = off)
    retry_backoff_ms: float = 1.0      # attempt k sleeps backoff * 2**k
    retry_jitter: float = 0.5          # multiplicative jitter in [0, 1]
    breaker_failures: int = 0          # consecutive device-tier failures
    #                                    that open the breaker (0 = off)
    breaker_cooldown_ms: float = 100.0  # open -> half-open wait
    breaker_probes: int = 1            # half-open successes to close


@dataclasses.dataclass(frozen=True)
class ObsPlan:
    """Observability: request/group tracing + histogram metrics
    (``repro_torch.obs``)."""
    trace: bool = False                # ring-buffer span/instant tracing
    trace_capacity: int | None = None  # ring size; None = obs default
    sample_every: int = 1              # trace every Nth request's events
    metrics: bool = True               # latency histograms + unified
    #                                    counter snapshot()


@dataclasses.dataclass(frozen=True)
class MemPlan:
    """Hierarchical memory tier: host-RAM cold store + async promotion +
    bulk warming (``repro_torch.mem``)."""
    cold_tier: bool = False            # arm the host-RAM cold rep arena
    cold_bytes: int = 1 << 28          # arena byte budget (256 MiB)
    promote_touches: int = 2           # cold hits needed to promote ...
    promote_window_s: float = 60.0     # ... within this sliding window
    warm_batch: int = 256              # bulk-warm chunk between dev syncs


_SECTIONS: dict[str, type] = {"graph": GraphPlan, "kernel": KernelPlan,
                              "batch": BatchPlan, "cache": CachePlan,
                              "ft": FaultPlan, "obs": ObsPlan,
                              "mem": MemPlan}

# per-field type contracts, checked before the range/combination rules. A
# trailing "?" allows None; "int" excludes bool (True is not a row budget).
_FIELD_TYPES: dict[str, dict[str, str]] = {
    "graph": {"mode": "str", "reparam_attention": "bool",
              "fragment": "bool", "group_by_domain": "bool",
              "two_stage": "bool?"},
    "kernel": {"use_pallas": "bool", "kernel_gather": "bool",
               "gather_attention": "bool", "precat_weights": "bool"},
    "batch": {"max_batch": "int", "min_bucket": "int",
              "max_users_per_batch": "int", "hedging": "bool",
              "linger_ms": "num", "max_coalesce": "int",
              "deadline_linger_frac": "num", "continuous": "bool",
              "max_inflight": "int", "admission": "bool",
              "shed_queue_depth": "int?", "degrade_queue_depth": "int?",
              "degrade_frac": "num", "deadline_headroom_ms": "num"},
    "cache": {"cache_user_reps": "bool", "max_cached_users": "int?",
              "device_resident": "bool", "device_slots": "int?"},
    "ft": {"inject": "bool", "seed": "int", "sites": "strs",
           "retries": "int", "retry_backoff_ms": "num",
           "retry_jitter": "num", "breaker_failures": "int",
           "breaker_cooldown_ms": "num", "breaker_probes": "int"},
    "obs": {"trace": "bool", "trace_capacity": "int?",
            "sample_every": "int", "metrics": "bool"},
    "mem": {"cold_tier": "bool", "cold_bytes": "int",
            "promote_touches": "int", "promote_window_s": "num",
            "warm_batch": "int"},
}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise PlanError(msg)


def _type_ok(kind: str, v: Any) -> bool:
    if kind.endswith("?"):
        if v is None:
            return True
        kind = kind[:-1]
    if kind == "str":
        return isinstance(v, str)
    if kind == "bool":
        return isinstance(v, bool)
    if kind == "num":
        return isinstance(v, (int, float)) and not isinstance(v, bool)
    if kind == "strs":                     # tuple of str (lists were
        return (isinstance(v, tuple)       # normalized before this check)
                and all(isinstance(x, str) for x in v))
    return isinstance(v, int) and not isinstance(v, bool)    # "int"


@dataclasses.dataclass(frozen=True)
class ServePlan:
    """Frozen, validated, JSON-serializable serving configuration.

    Sections may be given as dicts — ``ServePlan(graph={"mode": "uoi"})`` —
    which ``from_json`` relies on. Construction rejects or auto-resolves
    per the module docstring's table; the resolved plan is what
    ``to_json`` serializes, so resolution round-trips cleanly.
    """
    graph: GraphPlan = GraphPlan()
    kernel: KernelPlan = KernelPlan()
    batch: BatchPlan = BatchPlan()
    cache: CachePlan = CachePlan()
    ft: FaultPlan = FaultPlan()
    obs: ObsPlan = ObsPlan()
    mem: MemPlan = MemPlan()

    def __post_init__(self):
        for name, cls in _SECTIONS.items():
            v = getattr(self, name)
            if isinstance(v, Mapping):
                known = [f.name for f in dataclasses.fields(cls)]
                unknown = set(v) - set(known)
                _require(not unknown,
                         f"unknown {name}-plan fields {sorted(unknown)}; "
                         f"known: {known} (the port does not serve the "
                         f"reference's other fields yet)")
                object.__setattr__(self, name, cls(**v))
            elif not isinstance(v, cls):
                raise PlanError(
                    f"plan section {name!r} must be a {cls.__name__} or a "
                    f"dict, got {type(v).__name__}")
        # JSON carries tuples as lists: normalize ft.sites before the type
        # check so a round-tripped plan compares equal to the original
        if isinstance(self.ft.sites, list):
            object.__setattr__(
                self, "ft",
                dataclasses.replace(self.ft, sites=tuple(self.ft.sites)))
        for name, fields in _FIELD_TYPES.items():
            section = getattr(self, name)
            for field, kind in fields.items():
                v = getattr(section, field)
                _require(_type_ok(kind, v),
                         f"{name}.{field} must be {kind.rstrip('?')}"
                         f"{' or None' if kind.endswith('?') else ''}, "
                         f"got {type(v).__name__} ({v!r})")
        g, k, b, c, f, o, m = (self.graph, self.kernel, self.batch,
                               self.cache, self.ft, self.obs, self.mem)

        _require(g.mode in MODES,
                 f"unknown mode {g.mode!r}; known: {list(MODES)}")
        _require(not (g.two_stage is True and g.mode == "vani"),
                 "two_stage=True with mode='vani': vani tiles user feeds "
                 "into the candidate batch — there is no user-only stage to "
                 "precompute; drop two_stage or pick uoi/mari")
        for field in ("max_batch", "min_bucket", "max_users_per_batch",
                      "max_coalesce", "max_inflight"):
            v = getattr(b, field)
            _require(v >= 1, f"{field} must be >= 1, got {v}")
        _require(b.linger_ms >= 0, f"linger_ms must be >= 0, got "
                 f"{b.linger_ms}")
        _require(0.0 <= b.deadline_linger_frac <= 1.0,
                 f"deadline_linger_frac must be in [0, 1], got "
                 f"{b.deadline_linger_frac}")
        _require(b.shed_queue_depth is None or b.shed_queue_depth >= 1,
                 f"shed_queue_depth must be >= 1 (or None for no shedding), "
                 f"got {b.shed_queue_depth}")
        _require(b.degrade_queue_depth is None or b.degrade_queue_depth >= 1,
                 f"degrade_queue_depth must be >= 1 (or None for no "
                 f"degrading), got {b.degrade_queue_depth}")
        _require(0.0 < b.degrade_frac <= 1.0,
                 f"degrade_frac must be in (0, 1], got {b.degrade_frac}")
        _require(b.deadline_headroom_ms >= 0,
                 f"deadline_headroom_ms must be >= 0, got "
                 f"{b.deadline_headroom_ms}")
        _require(not (b.shed_queue_depth is not None
                      and b.degrade_queue_depth is not None
                      and b.degrade_queue_depth > b.shed_queue_depth),
                 f"degrade_queue_depth ({b.degrade_queue_depth}) > "
                 f"shed_queue_depth ({b.shed_queue_depth}): requests would "
                 f"be shed outright before the cheaper degrade tier ever "
                 f"engaged — order the thresholds degrade <= shed")
        _require(c.max_cached_users is None or c.max_cached_users >= 1,
                 f"max_cached_users must be >= 1 (or None for unbounded), "
                 f"got {c.max_cached_users}")
        _require(c.device_slots is None or c.device_slots >= 1,
                 f"device_slots must be >= 1 (or None to follow "
                 f"max_cached_users), got {c.device_slots}")
        _require(f.retries >= 0, f"retries must be >= 0, got {f.retries}")
        _require(f.retry_backoff_ms >= 0,
                 f"retry_backoff_ms must be >= 0, got {f.retry_backoff_ms}")
        _require(0.0 <= f.retry_jitter <= 1.0,
                 f"retry_jitter must be in [0, 1], got {f.retry_jitter}")
        _require(f.breaker_failures >= 0,
                 f"breaker_failures must be >= 0 (0 disables the breaker), "
                 f"got {f.breaker_failures}")
        _require(f.breaker_cooldown_ms >= 0,
                 f"breaker_cooldown_ms must be >= 0, got "
                 f"{f.breaker_cooldown_ms}")
        _require(f.breaker_probes >= 1,
                 f"breaker_probes must be >= 1, got {f.breaker_probes}")
        _require(o.trace_capacity is None or o.trace_capacity >= 1,
                 f"trace_capacity must be >= 1 (or None for the obs "
                 f"default), got {o.trace_capacity}")
        _require(o.sample_every >= 1,
                 f"sample_every must be >= 1, got {o.sample_every}")
        _require(m.cold_bytes >= 1,
                 f"mem.cold_bytes must be >= 1, got {m.cold_bytes}")
        _require(m.promote_touches >= 1,
                 f"mem.promote_touches must be >= 1, got "
                 f"{m.promote_touches}")
        _require(m.promote_window_s > 0,
                 f"mem.promote_window_s must be > 0, got "
                 f"{m.promote_window_s}")
        _require(m.warm_batch >= 1,
                 f"mem.warm_batch must be >= 1, got {m.warm_batch}")
        for spec in f.sites:
            try:
                parse_fault_spec(spec)
            except ValueError as e:
                raise PlanError(f"invalid ft.sites spec {spec!r}: {e}") \
                    from None

        notes = []
        if k.kernel_gather and not k.use_pallas:
            notes.append(
                "kernel_gather without use_pallas: the rep-table gather at "
                "accumulator-init load only exists inside the mari_matmul "
                "kernel — resolved to kernel_gather=False (set "
                "use_pallas=True to keep it)")
            object.__setattr__(self, "kernel",
                               dataclasses.replace(self.kernel,
                                                   kernel_gather=False))
        if k.gather_attention and not (g.mode == "mari"
                                       and g.reparam_attention):
            notes.append(
                "gather_attention without decomposed attention (needs "
                "mode='mari' AND reparam_attention=True): there are no "
                "stacked attention boundary tables to gather from — "
                "resolved to gather_attention=False")
            object.__setattr__(self, "kernel",
                               dataclasses.replace(self.kernel,
                                                   gather_attention=False))
        rewrite_knobs = [n for n in ("reparam_attention", "fragment",
                                     "group_by_domain")
                         if getattr(g, n)]
        if rewrite_knobs and g.mode != "mari":
            notes.append(
                f"{'/'.join(rewrite_knobs)} with mode={g.mode!r}: these "
                f"parameterize the MaRI rewrite, which only runs under "
                f"mode='mari' — resolved to False")
            object.__setattr__(
                self, "graph",
                dataclasses.replace(self.graph,
                                    **{n: False for n in rewrite_knobs}))
        adm_knobs = [n for n, v in
                     (("shed_queue_depth", b.shed_queue_depth),
                      ("degrade_queue_depth", b.degrade_queue_depth),
                      ("deadline_headroom_ms",
                       b.deadline_headroom_ms or None))
                     if v is not None]
        if adm_knobs and not b.admission:
            notes.append(
                f"{'/'.join(adm_knobs)} without admission=True: the "
                f"admission controller only runs when admission is enabled "
                f"— resolved to defaults (set admission=True to keep them)")
            object.__setattr__(
                self, "batch",
                dataclasses.replace(self.batch, shed_queue_depth=None,
                                    degrade_queue_depth=None,
                                    deadline_headroom_ms=0.0))
            b = self.batch
        if c.device_resident and not c.cache_user_reps:
            notes.append(
                "device_resident without cache_user_reps: the device tier "
                "mirrors cached stage-1 reps — with caching off there is "
                "nothing to keep resident; resolved to device_resident="
                "False")
            object.__setattr__(self, "cache",
                               dataclasses.replace(self.cache,
                                                   device_resident=False))
            c = self.cache
        if c.device_resident and b.hedging:
            notes.append(
                "device_resident with hedging: a hedged duplicate would "
                "replay a pack whose slot rows a later write may already "
                "have replaced — resolved to hedging=False")
            object.__setattr__(self, "batch",
                               dataclasses.replace(self.batch,
                                                   hedging=False))
            b = self.batch
        if c.device_slots is not None and not c.device_resident:
            notes.append(
                "device_slots without device_resident: it sizes the device "
                "rep tier only — resolved to device_slots=None")
            object.__setattr__(self, "cache",
                               dataclasses.replace(self.cache,
                                                   device_slots=None))
            c = self.cache
        if m.cold_tier and not c.cache_user_reps:
            notes.append(
                "mem.cold_tier without cache.cache_user_reps: the cold tier "
                "catches hot-LRU evictions and feeds promotions back into "
                "the hot cache — with no hot cache there is nothing to "
                "demote from or promote into; resolved to cold_tier=False")
            object.__setattr__(self, "mem",
                               dataclasses.replace(self.mem,
                                                   cold_tier=False))
            m = self.mem
        mem_knobs = [n for n, v in
                     (("cold_bytes",
                       None if m.cold_bytes == 1 << 28 else m.cold_bytes),
                      ("promote_touches",
                       None if m.promote_touches == 2 else m.promote_touches),
                      ("promote_window_s",
                       None if m.promote_window_s == 60.0 else
                       m.promote_window_s),
                      ("warm_batch",
                       None if m.warm_batch == 256 else m.warm_batch))
                     if v is not None]
        if mem_knobs and not m.cold_tier:
            notes.append(
                f"mem.{'/'.join(mem_knobs)} without mem.cold_tier=True: "
                f"they parameterize the cold tier only — resolved to "
                f"defaults (set cold_tier=True to keep them)")
            object.__setattr__(self, "mem",
                               dataclasses.replace(self.mem,
                                                   cold_bytes=1 << 28,
                                                   promote_touches=2,
                                                   promote_window_s=60.0,
                                                   warm_batch=256))
        inj_knobs = [n for n, v in (("sites", f.sites or None),
                                    ("seed", f.seed or None))
                     if v is not None]
        if inj_knobs and not f.inject:
            notes.append(
                f"ft.{'/'.join(inj_knobs)} without ft.inject=True: the "
                f"fault injector only arms when inject is on — resolved to "
                f"defaults (set inject=True to keep them)")
            object.__setattr__(self, "ft",
                               dataclasses.replace(self.ft, sites=(),
                                                   seed=0))
            f = self.ft
        retry_knobs = [n for n, v in
                       (("retry_backoff_ms",
                         None if f.retry_backoff_ms == 1.0 else
                         f.retry_backoff_ms),
                        ("retry_jitter",
                         None if f.retry_jitter == 0.5 else f.retry_jitter))
                       if v is not None]
        if retry_knobs and not f.retries:
            notes.append(
                f"ft.{'/'.join(retry_knobs)} without ft.retries > 0: they "
                f"shape the retry schedule only — resolved to defaults")
            object.__setattr__(self, "ft",
                               dataclasses.replace(self.ft,
                                                   retry_backoff_ms=1.0,
                                                   retry_jitter=0.5))
            f = self.ft
        if f.breaker_failures and not c.device_resident:
            notes.append(
                "ft.breaker_failures without cache.device_resident: the "
                "circuit breaker guards the device-resident stage-2 fast "
                "path — with no device tier every pack already takes the "
                "re-stacking route; resolved to breaker_failures=0")
            object.__setattr__(self, "ft",
                               dataclasses.replace(self.ft,
                                                   breaker_failures=0))
            f = self.ft
        brk_knobs = [n for n, v in
                     (("breaker_cooldown_ms",
                       None if f.breaker_cooldown_ms == 100.0 else
                       f.breaker_cooldown_ms),
                      ("breaker_probes",
                       None if f.breaker_probes == 1 else f.breaker_probes))
                     if v is not None]
        if brk_knobs and not f.breaker_failures:
            notes.append(
                f"ft.{'/'.join(brk_knobs)} without ft.breaker_failures > 0: "
                f"they parameterize the circuit breaker only — resolved to "
                f"defaults")
            object.__setattr__(self, "ft",
                               dataclasses.replace(self.ft,
                                                   breaker_cooldown_ms=100.0,
                                                   breaker_probes=1))
        trc_knobs = [n for n, v in
                     (("trace_capacity", o.trace_capacity),
                      ("sample_every",
                       o.sample_every if o.sample_every != 1 else None))
                     if v is not None]
        if trc_knobs and not o.trace:
            notes.append(
                f"{'/'.join(trc_knobs)} without trace=True: they "
                f"parameterize the ring-buffer tracer only — resolved to "
                f"defaults (set trace=True to keep them)")
            object.__setattr__(self, "obs",
                               dataclasses.replace(self.obs,
                                                   trace_capacity=None,
                                                   sample_every=1))
        # silent normalization: the smallest bucket never exceeds the budget
        if b.min_bucket > b.max_batch:
            object.__setattr__(self, "batch",
                               dataclasses.replace(self.batch,
                                                   min_bucket=b.max_batch))
        object.__setattr__(self, "_notes", tuple(notes))
        for msg in notes:
            warnings.warn(msg, PlanResolutionWarning, stacklevel=3)

    @property
    def resolution_notes(self) -> tuple[str, ...]:
        """Auto-resolutions applied at construction (empty if none)."""
        return self._notes

    def evolve(self, **updates: Any) -> "ServePlan":
        """Return a new plan with section fields replaced, addressed
        ``<section>__<field>``: ``plan.evolve(graph__mode="uoi")``."""
        per_section: dict[str, dict[str, Any]] = {n: {} for n in _SECTIONS}
        for key, value in updates.items():
            section, sep, field = key.partition("__")
            if not sep or section not in _SECTIONS or not field:
                raise TypeError(
                    f"evolve key {key!r} must be <section>__<field> with "
                    f"section in {sorted(_SECTIONS)}")
            per_section[section][field] = value
        return ServePlan(**{
            name: (dataclasses.replace(getattr(self, name), **fields)
                   if fields else getattr(self, name))
            for name, fields in per_section.items()})

    def to_dict(self) -> dict:
        return {name: dataclasses.asdict(getattr(self, name))
                for name in _SECTIONS}

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ServePlan":
        unknown = set(d) - set(_SECTIONS)
        _require(not unknown,
                 f"unknown plan sections {sorted(unknown)}; known: "
                 f"{sorted(_SECTIONS)} (the port does not serve the "
                 f"reference's other sections yet)")
        return cls(**{name: d[name] for name in _SECTIONS if name in d})

    @classmethod
    def from_json(cls, s: str) -> "ServePlan":
        d = json.loads(s)
        _require(isinstance(d, dict), "plan JSON must be an object")
        return cls.from_dict(d)

    @classmethod
    def load(cls, path: str) -> "ServePlan":
        with open(path) as f:
            return cls.from_json(f.read())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def preset(cls, name: str) -> "ServePlan":
        """Named serving shapes: 'paper', 'vanilla', 'uoi', 'tpu'."""
        if name not in PRESETS:
            raise PlanError(
                f"unknown preset {name!r}; known: {sorted(PRESETS)}")
        return PRESETS[name]

    def preset_name(self) -> str | None:
        """The preset this plan equals, if any (provenance labeling)."""
        for name, plan in PRESETS.items():
            if plan == self:
                return name
        return None


PRESETS: dict[str, ServePlan] = {
    # the paper's serving shape: MaRI rewrite + two-stage split + coalescing
    "paper": ServePlan(),
    # baseline paradigms of Fig. 1 (single-stage tiled / two-stage uoi)
    "vanilla": ServePlan(graph=GraphPlan(mode="vani")),
    "uoi": ServePlan(graph=GraphPlan(mode="uoi")),
    # every kernel the path has: fused mari_dense with the kernel-side
    # rep-table gather + gather-at-load decomposed attention (the name is
    # the reference's preset name)
    "tpu": ServePlan(graph=GraphPlan(mode="mari", reparam_attention=True),
                     kernel=KernelPlan(use_pallas=True, kernel_gather=True,
                                       gather_attention=True)),
}
