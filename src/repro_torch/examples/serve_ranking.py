"""End-to-end serving example: the coarse-ranking stage of Fig. 2 (port of
``examples/serve_ranking.py``).

Part 1 — paradigm comparison: a stream of requests (one user, thousands of
candidates each) flows through the two-stage ServingEngine: the user-only
subgraph runs once per user and its outputs are cached (stage 1);
candidates are scored by the separately compiled batched residual (stage 2)
in power-of-two batch buckets. Compares the three inference paradigms of
Fig. 1 on the same request stream.

Part 2 — async cross-user coalescing: a simulated multi-user burst (ragged
pool sizes, mixed cache hits/misses) is submitted concurrently to the
``CoalescingBatcher``, which packs candidate chunks from different users
into shared stage-2 buckets — each executed as ONE row-wise call (every
candidate row gathers its own user's cached reps). Scores match the
sequential per-request loop within fp32 rtol = atol = 2e-4 (the reference
asserts bit-identity; on the card cuBLAS may pick another algorithm per
bucket); throughput is reported for both.

Part 3 — overload & SLO admission: the same graph behind a
``RankingService`` with the continuous dispatch loop and deliberately tiny
admission thresholds, hit with a burst far past what the queue will hold.
best_effort requests are shed (typed ``AdmissionError``, failing fast at
submit) or degraded (candidate pool truncated) while every deadline-tagged
request completes at full pool size — the SLO tiering in one printout.

Part 4 — hierarchical memory tier: the user universe is bulk-``warm``ed
OFFLINE into the host-RAM cold arena (``MemPlan.cold_tier``) through the
engine's own compiled stage 1, then the part-2 burst is replayed against a
deliberately tiny hot LRU. Every request is served from a tier — hot hit
or one cold-arena read — with zero online stage-1 recomputes, scores
within 2e-4 of the recompute path, and repeat traffic promoted back to the
hot tier by the async promotion worker::

  python -m repro_torch.examples.serve_ranking [--candidates 4096] \\
      [--use-pallas] [--device cpu]

``--device`` defaults to ``cuda``; ``--use-pallas`` routes ``mari_dense``
through the ``mari_matmul`` kernel (its plain version on the CPU).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.common import resolve_device
from repro_torch.data.features import make_recsys_feeds
from repro_torch.graph.executor import init_graph_params
from repro_torch.models.ranking import (PaperRankingConfig,
                                        build_paper_ranking_model)
from repro_torch.serve import (SLO_DEADLINE, AdmissionError,
                               CoalescingBatcher, RankingService, ServePlan,
                               ServeRequest, ServingEngine)

TOL = dict(rtol=2e-4, atol=2e-4)      # fp32, as tests/test_kernels.py


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--candidates", type=int, default=4096)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--users", type=int, default=6)
    ap.add_argument("--max-batch", type=int, default=2048)
    ap.add_argument("--scale", type=float, default=0.06)
    ap.add_argument("--linger-ms", type=float, default=3.0,
                    help="batcher linger window for collecting co-arriving "
                         "requests")
    ap.add_argument("--use-pallas", action="store_true",
                    help="route mari_dense through the mari_matmul kernel "
                         "(its plain version on the CPU)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Perfetto-loadable Chrome trace of parts "
                         "2+3 (coalescing + overload) — overlapped groups "
                         "show as concurrent group:N tracks")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    graph, _ = build_paper_ranking_model(
        PaperRankingConfig().scaled(args.scale))
    params = init_graph_params(graph, seed=0, device=dev)
    user_in = {n.name for n in graph.input_nodes()
               if n.attrs.get("domain") == "user"}

    # user features are a function of the USER, not the request: the
    # rep-cache contract says one (user_id, feature_version) key maps to
    # one feature set
    user_feeds = {}

    def make_request(r, rng, candidates):
        uid = r % args.users
        feeds = make_recsys_feeds(graph, candidates, rng)
        if uid not in user_feeds:
            user_feeds[uid] = {k2: v for k2, v in feeds.items()
                               if k2 in user_in}
        return ServeRequest(
            user_id=uid,
            user_feeds=user_feeds[uid],
            candidate_feeds={k2: v for k2, v in feeds.items()
                             if k2 not in user_in})

    def request_stream(seed):
        rng = np.random.default_rng(seed)
        for r in range(args.requests):
            yield make_request(r, rng, args.candidates)

    # ---- part 1: VanI vs UOI vs MaRI, sequential per-request loop ----------
    print(f"requests={args.requests} users={args.users} "
          f"candidates/request={args.candidates} max_batch={args.max_batch} "
          f"device={dev}")
    ref_scores = None
    # ONE declarative plan, evolved per paradigm — the three engines differ
    # only in graph.mode
    base_plan = ServePlan().evolve(batch__max_batch=args.max_batch,
                                   kernel__use_pallas=args.use_pallas)
    for mode in ("vani", "uoi", "mari"):
        eng = ServingEngine(graph, params,
                            plan=base_plan.evolve(graph__mode=mode),
                            device=dev)
        if eng.conversion:
            print(f"[{mode}] MaRI rewrote "
                  f"{len(eng.conversion.rewrites)} matmuls")
        if eng.two_stage:
            print(f"[{mode}] {eng.split.summary()}")
        lats, hits, hedges = [], 0, 0
        last = None
        for req in request_stream(42):
            res = eng.score(req)
            lats.append(res.latency_ms)
            hits += res.user_cache_hit
            hedges += res.hedged
            last = res.scores
        lats = np.asarray(lats[2:])   # drop warm-up / capture
        if ref_scores is None:
            ref_scores = last
        else:
            err = np.abs(ref_scores - last).max()
            if not err < 1e-3:
                raise AssertionError(f"{mode} diverged from VanI by {err}")
        extra = (f"  stage1_runs={eng.stage1_calls}"
                 f"  stage2_compiles={eng.stage2_compilations}"
                 if eng.two_stage else "")
        print(f"[{mode}] avg={lats.mean():7.2f}ms  "
              f"p50={np.percentile(lats, 50):7.2f}ms  "
              f"p99={np.percentile(lats, 99):7.2f}ms  "
              f"user_cache_hits={hits}/{args.requests}  "
              f"hedged={hedges}{extra}")
        eng.close()
    print("all modes score-identical ✓")

    # ---- part 2: async multi-user stream through the coalescing batcher ----
    print(f"\n-- async coalescing (mari): multi-user burst, ragged pools, "
          f"linger={args.linger_ms}ms --")
    # hedging off for the timed comparison: duplicate executions would
    # contaminate the seq-vs-coalesced req/s numbers
    eng = ServingEngine(graph, params, plan=base_plan.evolve(
        graph__mode="mari", batch__hedging=False,
        obs__trace=args.trace is not None), device=dev)
    rng = np.random.default_rng(0)
    feed_rng = np.random.default_rng(7)
    burst = [make_request(r, feed_rng,
                          int(rng.integers(args.candidates // 4,
                                           args.candidates)))
             for r in range(args.requests)]

    seq_results = [eng.score(r) for r in burst]      # warms every cache/shape
    t0 = time.perf_counter()
    for r in burst:
        eng.score(r)
    seq_s = time.perf_counter() - t0

    with CoalescingBatcher(eng, linger_ms=args.linger_ms) as batcher:
        co_results = batcher.score_many(burst)       # warm coalesced shapes
        # counters are lifetime-cumulative; snapshot so the printout
        # reflects only the timed burst
        calls0, cross0, batches0 = (eng.stage2_calls, eng.coalesced_calls,
                                    batcher.batches)
        t0 = time.perf_counter()
        co_results = batcher.score_many(burst)
        co_s = time.perf_counter() - t0
        calls = eng.stage2_calls - calls0
        cross = eng.coalesced_calls - cross0
        batches = batcher.batches - batches0

    for s, c in zip(seq_results, co_results):
        np.testing.assert_allclose(c.scores, s.scores, **TOL,
                                   err_msg="coalescing changed scores")
    rows = sum(r.scores.shape[0] for r in co_results)
    print(f"[sequential] {args.requests / seq_s:7.1f} req/s "
          f"({rows / seq_s:10.0f} candidates/s)")
    print(f"[coalesced ] {args.requests / co_s:7.1f} req/s "
          f"({rows / co_s:10.0f} candidates/s)  "
          f"stage2_calls/burst={calls}  "
          f"cross_user_calls={cross}  batches={batches}")
    print("coalesced scores within 2e-4 of per-request ✓")
    eng.close()

    # ---- part 3: overload burst against SLO-tiered admission control -------
    print("\n-- overload & admission (mari): burst past the queue, tiny "
          "shed/degrade depths --")
    # thresholds are deliberately small so a small burst trips every tier:
    # shed best_effort beyond 8 queued, halve its candidate pool beyond 4
    # queued; deadline-tagged requests are exempt from both
    over_plan = base_plan.evolve(
        graph__mode="mari", batch__hedging=False, batch__continuous=True,
        batch__admission=True, batch__shed_queue_depth=8,
        batch__degrade_queue_depth=4, batch__degrade_frac=0.5,
        batch__linger_ms=args.linger_ms,
        obs__trace=args.trace is not None)
    svc = RankingService(over_plan, device=dev)
    svc.register("ranking", graph=graph, params=params, plan=over_plan)
    for r in burst[:4]:                       # warm shapes + rep caches
        svc.score("ranking", r)

    futs = []
    for i, r in enumerate(burst * 3):         # ~3x the part-2 burst at once
        deadline = i % 5 == 0                 # every 5th request is urgent
        futs.append((deadline, svc.submit(
            "ranking", r, slo=SLO_DEADLINE if deadline else "best_effort",
            deadline_ms=250.0 if deadline else None)))
    # a shed future is already failed (fast, typed) when submit returns —
    # it never hangs; admitted futures resolve to ServeResults
    done, shed = [], 0
    for d, f in futs:
        err = f.exception()
        if err is not None:
            if not isinstance(err, AdmissionError):
                raise err
            if d:
                raise AssertionError("deadline work must never be shed by "
                                     "depth")
            if err.queue_depth < 8:
                raise AssertionError(f"shed below the depth: {err}")
            shed += 1
        else:
            done.append((d, f.result()))
    if any(res.degraded for d, res in done if d):
        raise AssertionError("deadline work must never be degraded")
    degraded = sum(res.degraded for _, res in done)

    sc = svc.stats()["scenarios"]["ranking"]
    print(f"[burst     ] submitted={len(burst) * 3}  "
          f"completed={len(done)}  shed_at_submit={shed}  "
          f"degraded={degraded}")
    print(f"[counters  ] shed_best_effort={sc['shed_best_effort']}  "
          f"shed_deadline={sc['shed_deadline']}  "
          f"degraded_requests={sc['degraded_requests']}  "
          f"pipeline_forks={sc['pipeline_forks']}")
    print("deadline tier untouched under overload ✓")

    # ---- part 4: memory tier — warm offline, cold-hit online, promote -----
    print("\n-- memory tier (mari): bulk-warm offline, serve from the cold "
          "arena, promote repeat users --")
    # hot LRU deliberately smaller than the user universe: users live ONLY
    # in the host-RAM arena until the promotion worker sees repeat traffic
    mem_eng = ServingEngine(graph, params, plan=base_plan.evolve(
        graph__mode="mari", batch__hedging=False,
        cache__max_cached_users=2, mem__cold_tier=True), device=dev)
    warmed = mem_eng.warm(sorted(user_feeds.items()))
    warm_results = [mem_eng.score(r) for r in burst]
    hot = sum(r.user_cache_hit for r in warm_results)
    cold = sum(r.cold_hit for r in warm_results)
    if mem_eng.stage1_calls != 0:
        raise AssertionError("warmed users must never pay stage 1 online")
    for w, s in zip(warm_results, seq_results):
        np.testing.assert_allclose(w.scores, s.scores, **TOL,
                                   err_msg="warmed reps changed scores")
    mem_eng.flush_promotions()
    ms = mem_eng.mem_stats()
    print(f"[warm      ] users={warmed}  "
          f"arena_bytes={ms['cold']['bytes']}  "
          f"stage1_launches={ms['warm']['stage1_launches']}")
    print(f"[stream    ] hot_hits={hot}  cold_hits={cold}  "
          f"stage1_recomputes={mem_eng.stage1_calls}  "
          f"promotions={ms['promote']['promotions']}  "
          f"demotions={ms['demotions']}")
    print("every request tier-served, warmed reps within 2e-4 of "
          "recomputed ✓")
    mem_eng.close()
    if args.trace:
        from repro_torch.obs import write_trace
        tracers = {}
        if eng.tracer is not None:
            tracers["coalesce"] = eng.tracer      # part 2 (events persist)
        t3 = svc.engine("ranking").tracer
        if t3 is not None:
            tracers["overload"] = t3              # part 3
        write_trace(args.trace, tracers)
        print(f"wrote trace -> {args.trace} "
              f"({sum(len(t) for t in tracers.values())} events; load it "
              f"at https://ui.perfetto.dev)")
    svc.close()


if __name__ == "__main__":
    main()
