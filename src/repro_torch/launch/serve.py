"""Serving launcher (port of ``repro.launch.serve``): scores a stream of
synthetic requests through the serving runtime and reports latency stats.
Configuration is a ``ServePlan`` — from a JSON file, a named preset, or
the flag overrides.

Single-scenario (one ``ServingEngine``)::

  python -m repro_torch.launch.serve --arch din --mode mari --requests 20
  python -m repro_torch.launch.serve --plan plan.json --requests 3
  python -m repro_torch.launch.serve --preset tpu --dump-plan plan.json

Multi-scenario (a ``RankingService`` routing an interleaved stream)::

  python -m repro_torch.launch.serve --scenario dlrm-mlperf,deepfm,fm --requests 12

``--smoke`` is on by default; ``--no-smoke`` builds the full-size
registry models. ``--device`` defaults to ``cuda`` (the run fails without
a card): every stage then runs as replays of captured CUDA graphs.
``--device cpu`` runs on the CPU, where the same static buffers run the
stages eagerly and the kernel wrappers take their plain PyTorch versions.

``--trace out.json`` turns on ``ObsPlan.trace`` for the run and writes a
Chrome trace-event file (load it at https://ui.perfetto.dev): one process
per scenario, the engine's group / stage1 / pack / dispatch / collect
spans and the batcher's and caches' instants.

``--cold-tier`` arms the ``MemPlan`` host-RAM cold tier, bulk-warms the
even user ids of the synthetic stream into the cold arena, and reports
cold hits / async promotions after the stream (the ``[serve] mem`` line)
— so a traced run emits the ``warm`` / ``cold_hit`` / ``promote``
instants.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.data.features import make_recsys_feeds
from repro_torch.graph.executor import init_graph_params
from repro_torch.obs import write_trace
from repro_torch.serve import (RankingService, ServePlan, ServeRequest,
                               ServingEngine)
from repro_torch.serve.plan import MODES, PRESETS


def build_plan(args) -> ServePlan:
    """Resolve the serving plan: file < preset < explicit flag overrides."""
    if args.plan and args.preset:
        raise SystemExit("pass --plan or --preset, not both")
    if args.plan:
        plan = ServePlan.load(args.plan)
    elif args.preset:
        plan = ServePlan.preset(args.preset)
    else:
        plan = ServePlan()
    over = {}
    if args.mode is not None:
        over["graph__mode"] = args.mode
    if args.max_batch is not None:
        over["batch__max_batch"] = args.max_batch
    if args.reparam_attention is not None:
        over["graph__reparam_attention"] = args.reparam_attention
    if args.gather_attention is not None:
        over["kernel__gather_attention"] = args.gather_attention
    if args.use_pallas is not None:
        over["kernel__use_pallas"] = args.use_pallas
    if args.continuous is not None:
        over["batch__continuous"] = args.continuous
    if args.cold_tier is not None:
        over["mem__cold_tier"] = args.cold_tier
    if args.trace:
        over["obs__trace"] = True
    return plan.evolve(**over) if over else plan


def _warm_half(warm, graph, split, candidates: int, n_uids: int = 8):
    """Bulk-warm the EVEN user ids of the launcher's ``r % n_uids`` stream
    into the cold arena. Odd ids stay unwarmed, so one interleaved stream
    deterministically exercises every tier: even ids cold-hit (and, after
    enough touches, promote); odd ids pay stage 1 once and then hot-hit."""
    rng = np.random.default_rng(11)
    items = []
    for uid in range(0, n_uids, 2):
        uf, _ = split(make_recsys_feeds(graph, candidates, rng))
        items.append((uid, uf))
    return warm(items)


def _mem_line(tag: str, engine: ServingEngine) -> None:
    engine.flush_promotions()
    ms = engine.mem_stats()
    print(f"[serve] {tag}mem cold_users={ms['cold']['users']} "
          f"cold_hits={ms['cold_hits']} "
          f"promotions={ms['promote']['promotions']} "
          f"promote_errors={ms['promote']['errors']}")


def _summary(tag: str, lats: list[float]) -> None:
    if not lats:        # e.g. more scenarios than requests in round-robin
        print(f"[serve] {tag} n=0 (no requests routed)")
        return
    lats = np.asarray(lats)
    print(f"[serve] {tag} n={len(lats)} "
          f"avg={lats.mean():.2f}ms p50={np.percentile(lats, 50):.2f}ms "
          f"p99={np.percentile(lats, 99):.2f}ms")


def serve_single(args, plan: ServePlan) -> None:
    from repro_torch import configs as cfgreg
    mod = cfgreg.get_config(args.arch)
    build = mod.smoke_build() if args.smoke else mod.BUILD
    graph, *_ = build()
    params = init_graph_params(graph, seed=0, device=args.device)
    engine = ServingEngine(graph, params, plan=plan, device=args.device)
    if engine.conversion:
        print("[serve] MaRI rewrote:",
              [r.dense for r in engine.conversion.rewrites])
    user_in = {n.name for n in graph.input_nodes()
               if n.attrs.get("domain") == "user"}

    def split(feeds):
        return ({k: v for k, v in feeds.items() if k in user_in},
                {k: v for k, v in feeds.items() if k not in user_in})

    if engine.cold_tier:
        warmed = _warm_half(engine.warm, graph, split, args.candidates)
        print(f"[serve] warmed {warmed} users into the cold tier")
    lats = []
    rng = np.random.default_rng(7)
    for r in range(args.requests):
        feeds = make_recsys_feeds(graph, args.candidates, rng)
        req = ServeRequest(
            user_id=r % 8,
            user_feeds={k: v for k, v in feeds.items() if k in user_in},
            candidate_feeds={k: v for k, v in feeds.items()
                             if k not in user_in})
        lats.append(engine.score(req).latency_ms)
    _summary(f"arch={args.arch} mode={engine.mode}",
             lats[min(2, len(lats) - 1):])   # drop the first, cold calls
    if engine.cold_tier:
        _mem_line("", engine)
    if args.trace and engine.tracer is not None:
        write_trace(args.trace, {args.arch: engine.tracer})
        print(f"[serve] wrote trace -> {args.trace} "
              f"({len(engine.tracer)} events, "
              f"{engine.tracer.dropped} dropped)")
    engine.close()


def serve_multi(args, plan: ServePlan, scenarios: list[str]) -> None:
    """Route an interleaved request stream across several scenario models
    hosted by one ``RankingService`` (shared rep-cache budget, per-scenario
    engines + batchers)."""
    with RankingService(plan, smoke=args.smoke, device=args.device) as svc:
        for sc in scenarios:
            svc.register(sc)
        print(f"[serve] scenarios={','.join(svc.scenarios)} "
              f"(interleaved round-robin)")
        for sc in scenarios:
            if svc.engine(sc).cold_tier:
                warmed = _warm_half(
                    lambda items, sc=sc: svc.warm(sc, items),
                    svc.source_graph(sc),
                    lambda feeds, sc=sc: svc.split_feeds(sc, feeds),
                    args.candidates)
                print(f"[serve] scenario={sc} warmed {warmed} users into "
                      f"the cold tier")
        rng = np.random.default_rng(7)
        items = []
        for r in range(args.requests):
            sc = scenarios[r % len(scenarios)]
            feeds = make_recsys_feeds(svc.source_graph(sc), args.candidates,
                                      rng)
            uf, cf = svc.split_feeds(sc, feeds)
            items.append((sc, ServeRequest(user_id=r % 8, user_feeds=uf,
                                           candidate_feeds=cf)))
        svc.score_many(items)                # warmup pass, untimed
        results = svc.score_many(items)
        per = {sc: [] for sc in scenarios}
        for (sc, _), res in zip(items, results):
            per[sc].append(res.latency_ms)
        for sc in scenarios:
            _summary(f"scenario={sc}", per[sc])
        cache = svc.stats()["shared_cache"]
        print(f"[serve] shared_cache users={cache['users']} "
              f"hits={cache['hits']} misses={cache['misses']} "
              f"evictions={cache['evictions']}")
        for sc in scenarios:
            if svc.engine(sc).cold_tier:
                _mem_line(f"scenario={sc} ", svc.engine(sc))
        if args.trace:
            tracers = {sc: svc.engine(sc).tracer for sc in svc.scenarios
                       if svc.engine(sc).tracer is not None}
            if tracers:
                write_trace(args.trace, tracers)
                n = sum(len(t) for t in tracers.values())
                print(f"[serve] wrote trace -> {args.trace} "
                      f"({n} events across {len(tracers)} scenarios)")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="din",
                    help="single-scenario architecture (configs registry)")
    ap.add_argument("--scenario", default=None,
                    help="comma-separated scenario list — serves them all "
                         "through one RankingService (overrides --arch)")
    ap.add_argument("--plan", default=None, metavar="PATH",
                    help="load the ServePlan from a JSON file")
    ap.add_argument("--preset", choices=sorted(PRESETS), default=None,
                    help="start from a named ServePlan preset")
    ap.add_argument("--dump-plan", default=None, metavar="PATH",
                    help="write the resolved plan JSON and continue")
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--candidates", type=int, default=2048)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="registry smoke builds (--no-smoke = full size)")
    # plan overrides: default None means "whatever the plan says"
    ap.add_argument("--mode", choices=list(MODES), default=None)
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--reparam-attention",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="mari: also re-parameterize eligible "
                         "target_attention units (beyond-paper rewrite)")
    ap.add_argument("--gather-attention",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="consume decomposed-attention boundary tensors as "
                         "stacked (U, ...) tables indexed inside the "
                         "contractions (gather-at-load; pairs with "
                         "--reparam-attention)")
    ap.add_argument("--use-pallas",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="route mari_dense, the gather-aware attention "
                         "contractions and dot_interaction through the "
                         "hand-written CUDA kernels (the field keeps the "
                         "reference's name)")
    ap.add_argument("--continuous",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="continuous (two-phase overlapped) dispatch loop "
                         "in the scenario batchers")
    ap.add_argument("--cold-tier",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="host-RAM cold rep tier (MemPlan): bulk-warm the "
                         "even user ids of the stream, serve cold hits "
                         "from the arena, promote repeat users async")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="trace the run (ObsPlan.trace) and write a "
                         "Perfetto-loadable Chrome trace-event JSON here")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    plan = build_plan(args)
    if args.dump_plan:
        plan.save(args.dump_plan)
        print(f"[serve] wrote plan -> {args.dump_plan}")
    if args.requests < 1:
        return
    if args.scenario:
        # dedupe while preserving order: registering a scenario twice is a
        # service-level error, not something a CLI typo should crash on
        scenarios = list(dict.fromkeys(
            s for s in args.scenario.split(",") if s))
        if not scenarios:
            raise SystemExit("--scenario needs at least one scenario name")
        serve_multi(args, plan, scenarios)
    else:
        serve_single(args, plan)


if __name__ == "__main__":
    main()
