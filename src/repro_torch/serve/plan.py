"""``ServePlan`` — the frozen, validated, JSON-serializable serving config
(port of ``repro.serve.plan``, limited to the sections this port serves).

Sections, with the reference's field names so a plan means the same in both
packages:

* ``GraphPlan``  — ``mode`` (vani/uoi/mari), ``reparam_attention``,
  ``fragment``, ``group_by_domain``, ``two_stage``;
* ``KernelPlan`` — ``use_pallas`` (here: the hand-written CUDA kernels),
  ``kernel_gather``, ``gather_attention``, ``precat_weights``;
* ``BatchPlan``  — ``max_batch``, ``min_bucket``, ``max_users_per_batch``,
  and the batcher's ``linger_ms``, ``max_coalesce``,
  ``deadline_linger_frac``, ``continuous``, ``max_inflight``,
  ``admission``, ``shed_queue_depth``, ``degrade_queue_depth``,
  ``degrade_frac``, ``deadline_headroom_ms``;
* ``CachePlan``  — ``cache_user_reps``, ``max_cached_users``.

The reference's other sections and fields (shard, obs, mem, ft, the device
tier, hedging) are not ported yet: naming one is a ``PlanError``, never a
silent no-op.

Resolution table (the rows that touch these fields):

====================================================  =======================
combination                                           resolution
====================================================  =======================
unknown section or field, wrong-typed value           reject (``PlanError``)
``mode`` outside vani/uoi/mari                        reject
``two_stage=True`` with ``mode="vani"``               reject
non-positive ``max_batch`` / ``min_bucket`` /         reject
``max_users_per_batch`` / ``max_cached_users`` /
``max_coalesce`` / ``max_inflight`` /
``shed_queue_depth`` / ``degrade_queue_depth``;
negative ``linger_ms`` / ``deadline_headroom_ms``;
``deadline_linger_frac`` outside [0, 1];
``degrade_frac`` outside (0, 1]
``degrade_queue_depth > shed_queue_depth``            reject
admission thresholds (``shed_queue_depth`` /          drop them + warn
``degrade_queue_depth`` / positive
``deadline_headroom_ms``) without ``admission=True``
``kernel_gather`` without ``use_pallas``              drop ``kernel_gather``
                                                      + warn
``gather_attention`` without decomposed attention     drop
(``mode!="mari"`` or no ``reparam_attention``)        ``gather_attention``
                                                      + warn
``reparam_attention``/``fragment``/                   drop them + warn
``group_by_domain`` with ``mode != "mari"``
``min_bucket > max_batch``                            clamp ``min_bucket``
====================================================  =======================

Round-trip: ``ServePlan.from_json(plan.to_json()) == plan``.
"""
from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Any, Mapping

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
    """Bucketing, cross-user coalescing, SLO linger, the continuous
    dispatch loop, and SLO-tiered admission control."""
    max_batch: int = 4096              # stage-2 row budget per dispatch
    min_bucket: int = 128              # smallest pow2 candidate bucket
    max_users_per_batch: int = 8       # rep-table slot budget per pack
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
    """Bounded LRU user-representation store."""
    cache_user_reps: bool = True
    max_cached_users: int | None = None    # None = unbounded


_SECTIONS: dict[str, type] = {"graph": GraphPlan, "kernel": KernelPlan,
                              "batch": BatchPlan, "cache": CachePlan}

# per-field type contracts, checked before the range/combination rules. A
# trailing "?" allows None; "int" excludes bool (True is not a row budget).
_FIELD_TYPES: dict[str, dict[str, str]] = {
    "graph": {"mode": "str", "reparam_attention": "bool",
              "fragment": "bool", "group_by_domain": "bool",
              "two_stage": "bool?"},
    "kernel": {"use_pallas": "bool", "kernel_gather": "bool",
               "gather_attention": "bool", "precat_weights": "bool"},
    "batch": {"max_batch": "int", "min_bucket": "int",
              "max_users_per_batch": "int",
              "linger_ms": "num", "max_coalesce": "int",
              "deadline_linger_frac": "num", "continuous": "bool",
              "max_inflight": "int", "admission": "bool",
              "shed_queue_depth": "int?", "degrade_queue_depth": "int?",
              "degrade_frac": "num", "deadline_headroom_ms": "num"},
    "cache": {"cache_user_reps": "bool", "max_cached_users": "int?"},
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
        for name, fields in _FIELD_TYPES.items():
            section = getattr(self, name)
            for field, kind in fields.items():
                v = getattr(section, field)
                _require(_type_ok(kind, v),
                         f"{name}.{field} must be {kind.rstrip('?')}"
                         f"{' or None' if kind.endswith('?') else ''}, "
                         f"got {type(v).__name__} ({v!r})")
        g, k, b, c = self.graph, self.kernel, self.batch, self.cache

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
