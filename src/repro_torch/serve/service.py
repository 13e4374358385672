"""``RankingService`` — a multi-scenario serving router (port of
``repro.serve.service``).

Industrial rankers serve heterogeneous scenario models side by side
(per-stage rankers, per-surface models, A/B variants). ``RankingService``
hosts the ``repro_torch.configs`` registry's ranking scenarios (din,
deepfm, fm, dlrm-mlperf, paper-ranking) behind ONE
``submit(scenario, request)`` API:

* **per-scenario engines** — each registered scenario gets its own
  ``ServingEngine`` built from a ``ServePlan`` (the service default or a
  per-scenario override) and its own ``CoalescingBatcher`` (cross-user
  coalescing stays within a scenario: different graphs cannot share a
  stage-2 call);
* **registry-by-name** — ``service.register("din")`` builds the scenario
  from ``repro_torch.configs`` (``smoke_build`` by default, the full-size
  ``BUILD`` with ``smoke=False``) and draws params from a fixed seed on
  the service's device; callers may instead pass an explicit
  ``graph``/``params`` pair (e.g. the reference's weights, or trained
  ones);
* **shared rep-cache budget** — every scenario engine plugs into ONE
  bounded ``UserRepCache``: ``shared_cache_users`` caps the LIVE user
  representations across all scenarios together (one LRU, evictions
  compete globally), with cache keys namespaced per scenario so equal user
  ids from different scenarios can never collide on wrong-shaped reps.

Routing adds no numerics: a scenario scores as a standalone engine on the
same params and plan does (the shared cache changes *when* stage 1
recomputes, never what stage 2 computes).

Usage::

    svc = RankingService(ServePlan.preset("paper"))
    svc.register("din"); svc.register("deepfm")
    fut = svc.submit("din", req)          # Future[ServeResult]
    res = svc.score("deepfm", req2)       # synchronous
    svc.close()
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import Future
from typing import Iterable, Mapping, Sequence

import torch

from repro_torch.common import resolve_device
from repro_torch.graph.ir import Graph
from repro_torch.serve.batcher import SLO_BEST_EFFORT, CoalescingBatcher
from repro_torch.serve.cache import UserRepCache
from repro_torch.serve.engine import ServeRequest, ServeResult, ServingEngine
from repro_torch.serve.plan import ServePlan


@dataclasses.dataclass
class _Scenario:
    name: str
    plan: ServePlan
    source_graph: Graph          # pre-rewrite graph (feed specs live here)
    user_inputs: frozenset[str]  # input names with domain == "user"
    engine: ServingEngine
    batcher: CoalescingBatcher


class RankingService:
    """Host several scenario models behind one ``submit`` API.

    ``plan`` (a ``ServePlan`` or preset name) is the default serving shape
    for registered scenarios; ``shared_cache_users`` is the TOTAL live-user
    budget of the shared rep cache (defaults to the plan's
    ``max_cached_users``). ``smoke`` picks the registry build size used by
    name registration; ``seed`` the param-init seed; ``device`` where every
    scenario's engine runs (default ``"cuda"``; raises without a card).
    """

    def __init__(self, plan: ServePlan | str | None = None, *,
                 smoke: bool = True, seed: int = 0,
                 shared_cache_users: int | None = None,
                 device: str | torch.device = "cuda"):
        if isinstance(plan, str):
            plan = ServePlan.preset(plan)
        self.plan = plan if plan is not None else ServePlan()
        self.smoke = smoke
        self.seed = seed
        self.device = resolve_device(device)
        budget = (shared_cache_users if shared_cache_users is not None
                  else self.plan.cache.max_cached_users)
        self.shared_cache = UserRepCache(max_users=budget)
        self._scenarios: dict[str, _Scenario] = {}
        self._closed = False

    # -- registration -------------------------------------------------------
    def register(self, scenario: str, *, graph: Graph | None = None,
                 params: dict | None = None,
                 plan: ServePlan | str | None = None,
                 smoke: bool | None = None,
                 seed: int | None = None) -> ServingEngine:
        """Register one scenario model and build its engine.

        With no ``graph``, the scenario is built from the
        ``repro_torch.configs`` registry by name (``smoke_build``/``BUILD``
        per ``smoke``) and params are drawn from ``seed`` on the service's
        device — deterministic, so a standalone engine built the same way
        scores the same. Returns the scenario's engine.
        """
        if self._closed:
            raise RuntimeError("service is closed")
        if scenario in self._scenarios:
            raise ValueError(f"scenario {scenario!r} is already registered")
        if (graph is None) != (params is None):
            raise ValueError("pass graph and params together (or neither, "
                             "to build from the configs registry)")
        if isinstance(plan, str):
            plan = ServePlan.preset(plan)
        plan = plan if plan is not None else self.plan
        if graph is None:
            from repro_torch import configs as cfgreg
            from repro_torch.graph.executor import init_graph_params
            mod = cfgreg.get_config(scenario)
            use_smoke = self.smoke if smoke is None else smoke
            build = mod.smoke_build() if use_smoke else mod.BUILD
            built = build()
            graph = built[0] if isinstance(built, tuple) else built
            params = init_graph_params(
                graph, seed=self.seed if seed is None else seed,
                device=self.device)
        user_inputs = frozenset(n.name for n in graph.input_nodes()
                                if n.attrs.get("domain") == "user")
        engine = ServingEngine(graph, params, plan=plan,
                               cache=self.shared_cache,
                               cache_scope=scenario, device=self.device)
        # the whole batch section rides the plan spine, and the ft
        # section's retry knobs with it
        batcher = CoalescingBatcher.from_plan(engine, plan.batch, plan.ft)
        self._scenarios[scenario] = _Scenario(
            name=scenario, plan=plan, source_graph=graph,
            user_inputs=user_inputs, engine=engine, batcher=batcher)
        return engine

    # -- lookup -------------------------------------------------------------
    def _get(self, scenario: str) -> _Scenario:
        try:
            return self._scenarios[scenario]
        except KeyError:
            raise KeyError(
                f"scenario {scenario!r} is not registered; registered: "
                f"{sorted(self._scenarios)}") from None

    @property
    def scenarios(self) -> list[str]:
        return sorted(self._scenarios)

    def engine(self, scenario: str) -> ServingEngine:
        return self._get(scenario).engine

    def source_graph(self, scenario: str) -> Graph:
        """The scenario's pre-rewrite graph (input/feed specs)."""
        return self._get(scenario).source_graph

    def split_feeds(self, scenario: str, feeds: Mapping[str, object]
                    ) -> tuple[dict, dict]:
        """Partition a flat feed dict into (user_feeds, candidate_feeds)
        per the scenario graph's ``domain`` coloring — the ``ServeRequest``
        contract."""
        user_in = self._get(scenario).user_inputs
        return ({k: v for k, v in feeds.items() if k in user_in},
                {k: v for k, v in feeds.items() if k not in user_in})

    # -- scoring ------------------------------------------------------------
    def submit(self, scenario: str, req: ServeRequest, *,
               slo: str = SLO_BEST_EFFORT,
               deadline_ms: float | None = None) -> "Future[ServeResult]":
        """Route one request to its scenario's batcher (non-blocking)."""
        return self._get(scenario).batcher.submit(req, slo=slo,
                                                  deadline_ms=deadline_ms)

    def score(self, scenario: str, req: ServeRequest) -> ServeResult:
        return self.submit(scenario, req).result()

    def score_many(self, items: Sequence[tuple[str, ServeRequest]]
                   ) -> list[ServeResult]:
        """Score an interleaved multi-scenario stream: submit everything
        (scenario batchers coalesce their own co-arrivals concurrently),
        then collect results in submission order."""
        futs = [self.submit(scenario, req) for scenario, req in items]
        return [f.result() for f in futs]

    # -- memory hierarchy ---------------------------------------------------
    def warm(self, scenario: str, items, feature_version: int = 0) -> int:
        """Bulk-precompute stage-1 reps into a scenario's cold tier (see
        ``ServingEngine.warm``); requires ``plan.mem.cold_tier=True`` for
        that scenario. ``items``: ``(user_id, user_feeds)`` pairs."""
        return self._get(scenario).engine.warm(
            items, feature_version=feature_version)

    # -- observability ------------------------------------------------------
    def stats(self) -> dict:
        """Per-scenario serving counters (including the stage-boundary
        profile, the device rep tier, hedging, the fault counters and the
        memory tier) + the shared cache's state with byte accounting."""
        return {
            "scenarios": {
                s.name: {
                    "preset": s.plan.preset_name(),
                    "mode": s.engine.mode,
                    "two_stage": s.engine.two_stage,
                    "requests": s.batcher.requests,
                    "batches": s.batcher.batches,
                    "coalesced_requests": s.batcher.coalesced_requests,
                    "queue_wait_ms": s.batcher.queue_wait_ms,
                    "shed_requests": s.batcher.shed_requests,
                    "shed_best_effort": s.batcher.shed_best_effort,
                    "shed_deadline": s.batcher.shed_deadline,
                    "degraded_requests": s.batcher.degraded_requests,
                    "retries_attempted": s.batcher.retries_attempted,
                    "retries_exhausted": s.batcher.retries_exhausted,
                    "worker_crashes": s.batcher.worker_crashes,
                    "worker_respawns": s.batcher.worker_respawns,
                    "stage1_calls": s.engine.stage1_calls,
                    "stage2_calls": s.engine.stage2_calls,
                    "coalesced_calls": s.engine.coalesced_calls,
                    # the device tier's store stats(), pipeline forks,
                    # hedges, faults fired, quarantines, breaker state
                    **s.engine.ft_stats(),
                    # log-bucketed distributions: the tail numbers an SLO
                    # is judged on, which the totals above cannot show
                    "latency": {
                        "request_ms": s.batcher.request_latency.snapshot(),
                        "queue_wait_ms": s.batcher.queue_wait.snapshot(),
                    },
                    "profile": s.engine.profiler.snapshot(),
                    # memory hierarchy (plan.mem): cold arena occupancy,
                    # promotion-policy counters, warm-feed totals
                    "mem": s.engine.mem_stats(),
                } for s in self._scenarios.values()},
            # users/max_users/hits/misses/evictions plus byte accounting
            "shared_cache": self.shared_cache.stats(),
        }

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Drain and stop every scenario's batcher (each admitted request
        is still scored); the service accepts no further registration."""
        for s in self._scenarios.values():
            s.batcher.close()
            s.engine.close()
        self._closed = True

    def __enter__(self) -> "RankingService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __contains__(self, scenario: str) -> bool:
        return scenario in self._scenarios

    def __iter__(self) -> Iterable[str]:
        return iter(self.scenarios)
