"""Multi-process SPMD serving runner (port of ``repro.dist.runner``).

Every worker process runs the IDENTICAL program: build the paper's ranking
graph and its params from a fixed seed, construct a ``ServingEngine`` with
``shard_candidates`` on (one shard per rank of the ``torch.distributed``
group), and drive the same request sequence in lockstep. Each rank scores
its block of every pack's candidate rows and the closing all-gather (the
step's one collective) hands every rank the full score vector.

Correctness contract: sharded fp32 scores are within rtol = atol = 2e-4 of
a process-local, unsharded engine (each rank's smaller bucket may make
cuBLAS pick another algorithm, so bit equality is printed, not required),
and within the int8 bound ``max|score| / 127 / 2 + 1e-6`` under
``--compress-scores``.

Usage (the spawner re-executes this module as the workers)::

  python -m repro_torch.dist.runner --spawn 2 --verify
  python -m repro_torch.dist.runner --spawn 1 --verify --bench
  python -m repro_torch.dist.runner --spawn 2 --plan plan.json --verify
  python -m repro_torch.dist.runner --spawn 2 --verify --device cpu

Workers run on the card (``cuda:{rank % device_count}``) unless
``--device cpu``; the backend is NCCL when every rank has a card of its
own, gloo otherwise. Each worker prints one JSON record per mode (rank 0's
are re-emitted by the spawner, with every rank's backend, device, launch
counts and check results under ``per_rank``), then ``{"ok": true, ...}``;
the spawner fails if any worker fails or times out.

The serving configuration travels as a serialized ``ServePlan``: the
spawner resolves ONE plan (``--plan`` file or the flag defaults, sharding
forced on) and ships it to every worker as ``--plan-json``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from repro_torch.serve.plan import ServePlan

MODES = ("vani", "uoi", "mari")
TOL = dict(rtol=2e-4, atol=2e-4)      # fp32 parity, as the kernel tests


def build_plan(args) -> ServePlan:
    """The fleet's serving plan: an optional ``--plan`` JSON file with the
    runner's operating requirements layered on top — candidate-axis
    sharding on and hedging off (per-process duplicates would
    desynchronize the SPMD schedule). Flag overrides beat the plan file
    only when given; without a plan file the runner's bench-sized
    defaults apply."""
    base = ServePlan.load(args.plan) if args.plan else ServePlan()
    over = {"batch__hedging": False}
    if not base.shard.shard_candidates:
        # force sharding ON, but keep a plan file's explicit shard COUNT
        over["shard__shard_candidates"] = True
    if args.max_batch is not None:
        over["batch__max_batch"] = args.max_batch
    elif not args.plan:
        over["batch__max_batch"] = 256
    if args.min_bucket is not None:
        over["batch__min_bucket"] = args.min_bucket
    elif not args.plan:
        over["batch__min_bucket"] = 16
    if args.compress_scores:             # store_true: only ever forces ON
        over["shard__compress_scores"] = True
    if args.device_resident:
        # kept by the plan; a multi-process engine keeps the tier off
        over["cache__device_resident"] = True
    if args.trace:
        over["obs__trace"] = True
    return base.evolve(**over)


def build_problem(scale: float, pool: int, users: int, device="cuda"):
    """Deterministic (graph, params, requests), identical in every worker
    (params drawn on ``device`` from seed 0, feeds from CPU
    ``torch.Generator``s seeded per user), so the SPMD dispatch sequence
    matches without coordination."""
    import torch

    from repro_torch.graph.executor import init_graph_params
    from repro_torch.models.ranking import (PaperRankingConfig,
                                            build_paper_ranking_model)
    from repro_torch.serve.engine import ServeRequest

    graph, _ = build_paper_ranking_model(PaperRankingConfig().scaled(scale))
    params = init_graph_params(graph, seed=0, device=device)
    reqs = []
    for u in range(users):
        # ragged pools on purpose: exercises the shard-aligned bucketing
        n = max(1, pool // users + 7 * u)
        gen = torch.Generator().manual_seed(u + 1)
        user, cand = {}, {}
        for node in graph.input_nodes():
            is_user = node.attrs.get("domain") == "user"
            shape = (1 if is_user else n,) + tuple(node.attrs["shape"])
            (user if is_user else cand)[node.name] = torch.randn(
                shape, generator=gen).numpy()
        reqs.append(ServeRequest(user_id=u, user_feeds=user,
                                 candidate_feeds=cand))
    return graph, params, reqs


def run_worker(args) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.dist.topology import Topology
    from repro_torch.kernels import read_launches, reset_launches
    from repro_torch.serve.engine import ServingEngine

    topo = Topology.from_env()
    dev = topo.device(args.device)
    topo.initialize(dev, timeout_s=args.timeout)
    backend = dist.get_backend()
    rank = topo.process_id
    graph, params, reqs = build_problem(args.scale, args.pool, args.users,
                                        dev)
    pool_rows = sum(next(iter(r.candidate_feeds.values())).shape[0]
                    for r in reqs)
    # the spawner ships the resolved plan as JSON; a directly-invoked
    # worker (no --plan-json) falls back to building it from its own flags
    plan = (ServePlan.from_json(args.plan_json) if args.plan_json
            else build_plan(args))
    compress = plan.shard.compress_scores

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # fault-tolerance surface (plan.ft): a per-worker FaultInjector whose
    # ``spmd_heartbeat`` site simulates missed per-step heartbeats, fed to
    # a HeartbeatMonitor on a step-counter clock (timeout 1.5 steps: one
    # missed beat degrades, two consecutive misses declare the worker dead)
    injector = monitor = None
    wid = f"w{rank}"
    hb_step = [0]
    hb_missed = 0
    if plan.ft.inject and plan.ft.sites:
        from repro_torch.ft import FaultInjector, HeartbeatMonitor
        injector = FaultInjector(plan.ft.sites, seed=plan.ft.seed + rank)
        monitor = HeartbeatMonitor([wid], timeout=1.5,
                                   clock=lambda: float(hb_step[0]))
    records = []
    tracers = {}
    failed = False
    for mode in args.modes.split(","):
        mplan = plan.evolve(graph__mode=mode)
        local = mplan.evolve(shard__shard_candidates=False,
                             shard__compress_scores=False)
        ref_scores = plain_scores = None
        if args.verify:
            # process-local references (identical inputs in every worker):
            # the unsharded engine, and with kernels its use_pallas=False
            # twin
            ref = ServingEngine(graph, params, plan=local, device=dev)
            ref_scores = [r.scores for r in ref.score_coalesced(reqs)]
            ref.close()
            if mplan.kernel.use_pallas:
                plain = ServingEngine(graph, params, device=dev,
                                      plan=local.evolve(
                                          kernel__use_pallas=False,
                                          kernel__kernel_gather=False))
                plain_scores = [r.scores for r in
                                plain.score_coalesced(reqs)]
                plain.close()
            del ref

        # launch counts of this rank's sharded engine alone
        sync()
        reset_launches()
        eng = ServingEngine(graph, params, plan=mplan, device=dev)
        res = eng.score_coalesced(reqs)         # capture + verify pass
        mine = {"rank": rank, "device": str(dev), "backend": backend,
                "shard_rank": eng._shard_rank}
        rec = {"mode": mode, "processes": topo.num_processes,
               "shards": eng._n_shards, "devices_per_process": 1,
               "pool": pool_rows, "users": len(reqs),
               "compress_scores": bool(compress), "backend": backend,
               "device": str(dev), "plan": mplan.to_dict()}
        if args.verify:
            d = max(float(np.abs(a.scores - b).max())
                    for a, b in zip(res, ref_scores))
            mine["max_abs_vs_local"] = d
            mine["bit_identical"] = all(np.array_equal(a.scores, b)
                                        for a, b in zip(res, ref_scores))
            if compress:
                # int8 wire: per-element error <= that shard's scale / 2
                tol = max(float(np.abs(s).max()) for s in ref_scores) \
                    / 127.0 / 2.0 + 1e-6
                mine["int8_bound"] = tol
                ok = all(np.allclose(a.scores, b, atol=tol)
                         for a, b in zip(res, ref_scores))
                mine["within_int8_bound"] = bool(ok)
            else:
                ok = all(np.allclose(a.scores, b, **TOL)
                         for a, b in zip(res, ref_scores))
                mine["within_2e-4"] = bool(ok)
            if plain_scores is not None:
                # the sharded scores through the kernels against the plain
                # PyTorch versions (int8 adds its own error on top)
                mine["max_abs_vs_plain"] = max(
                    float(np.abs(a.scores - b).max())
                    for a, b in zip(res, plain_scores))
                ok = ok and all(np.allclose(
                    a.scores, b, **(dict(atol=tol) if compress else TOL))
                    for a, b in zip(res, plain_scores))
            mine["ok"] = bool(ok)
        if args.bench:
            eng.score_coalesced(reqs)           # warm every shape
            eng.profiler.snapshot(reset=True)   # breakdown = timed loop
            walls, snaps = [], []
            for _ in range(args.passes):
                t0 = time.perf_counter()
                eng.score_coalesced(reqs)
                walls.append(time.perf_counter() - t0)
                snaps.append(eng.profiler.snapshot(reset=True))
            pcts = (10, 50, 90)
            wall = float(np.median(walls))
            rec["qps"] = len(reqs) / wall
            rec["rows_per_s"] = rec["pool"] / wall
            # the spread over the timed passes: p10 / p50 / p90
            rec["rows_per_s_pcts"] = [
                rec["pool"] / float(w)
                for w in np.percentile(walls, pcts[::-1])]
            rec["pass_ms_pcts"] = [float(w) * 1e3
                                   for w in np.percentile(walls, pcts)]
            # per phase: host-wall mean µs a call over every timed pass,
            # and its ms a pass at p10 / p50 / p90
            rec["breakdown"] = {}
            for p in snaps[0]:
                calls = sum(s[p]["calls"] for s in snaps)
                ms = [s[p]["total_ms"] for s in snaps]
                if calls:
                    rec["breakdown"][p] = {
                        "calls": calls, "mean_us": sum(ms) * 1e3 / calls,
                        "pass_ms_pcts": [float(x) for x in
                                         np.percentile(ms, pcts)]}
        sync()
        mine["launches"] = {k: n for k, n in read_launches().items() if n}
        mine["stage2_compilations"] = eng.stage2_compilations
        if monitor is not None:
            from repro_torch.serve.errors import FaultInjected
            hb_step[0] += 1
            try:
                injector.poke("spmd_heartbeat", worker=wid, mode=mode)
                monitor.heartbeat(wid)
            except FaultInjected:
                hb_missed += 1          # this step's beat never arrived
            rec["heartbeat"] = {"worker": wid, "step": hb_step[0],
                                "missed": hb_missed,
                                "dead": monitor.dead()}
            rec["faults"] = injector.stats()
        # every rank's own numbers (launch counters are per process)
        per_rank = [None] * dist.get_world_size()
        dist.all_gather_object(per_rank, mine)
        rec["per_rank"] = per_rank
        if args.verify:
            rec["max_abs_vs_local"] = max(r["max_abs_vs_local"]
                                          for r in per_rank)
            rec["bit_identical"] = all(r["bit_identical"] for r in per_rank)
            if compress:
                rec["within_int8_bound"] = all(r["within_int8_bound"]
                                               for r in per_rank)
            else:
                rec["within_2e-4"] = all(r["within_2e-4"] for r in per_rank)
            if plain_scores is not None:
                rec["max_abs_vs_plain"] = max(r["max_abs_vs_plain"]
                                              for r in per_rank)
        records.append(rec)
        if eng.tracer is not None:
            tracers[mode] = eng.tracer    # events outlive the engine
        eng.close()
        del eng
        if rank == 0:
            print(json.dumps(rec), flush=True)
        if args.verify and not all(r["ok"] for r in per_rank):
            print(f"[runner] VERIFY FAILED mode={mode}", file=sys.stderr)
            failed = True
            break
    if args.trace:
        from repro_torch.obs import write_trace
        write_trace(args.trace, tracers)
    Topology.shutdown()
    if failed:
        return 1
    if rank == 0:
        print(json.dumps({"ok": True, "records": len(records)}), flush=True)
    return 0


def spawn(args) -> int:
    """Run ``args.spawn`` localhost workers of this module. They meet
    through a ``file://`` store in a fresh temporary directory, or over
    ``tcp://`` at ``--port`` / ``REPRO_COORDINATOR`` when one is given.
    Worker output goes to temp files, not pipes: the workers are coupled
    through collectives, so serially draining pipes could deadlock the
    fleet if one worker filled its pipe while another held a collective
    open. A worker that fails stops the others and fails the spawner."""
    plan_json = build_plan(args).to_json(indent=None)
    rdzv = None
    if args.port:
        coordinator = f"localhost:{args.port}"
    elif os.environ.get("REPRO_COORDINATOR"):
        coordinator = os.environ["REPRO_COORDINATOR"]
    else:
        rdzv = tempfile.mkdtemp(prefix="repro_rdzv_")
        coordinator = "file://" + os.path.join(rdzv, "store")
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                       ".."))
    workers = []
    for pid in range(args.spawn):
        env = dict(os.environ)
        env.update({
            "REPRO_NUM_PROCESSES": str(args.spawn),
            "REPRO_PROCESS_ID": str(pid),
            "REPRO_COORDINATOR": coordinator,
            "PYTHONPATH": src + os.pathsep + env.get("PYTHONPATH", ""),
        })
        cmd = [sys.executable, "-m", "repro_torch.dist.runner",
               "--modes", args.modes, "--scale", str(args.scale),
               "--pool", str(args.pool), "--users", str(args.users),
               "--passes", str(args.passes), "--device", args.device,
               "--timeout", str(args.timeout),
               # ONE resolved plan, serialized — workers do not re-derive
               # engine knobs from argv
               "--plan-json", plan_json]
        for flag in ("verify", "bench"):
            if getattr(args, flag):
                cmd.append("--" + flag)
        if args.trace:
            cmd += ["--trace", f"{args.trace}.w{pid}"]
        out_f = tempfile.TemporaryFile(mode="w+")
        err_f = tempfile.TemporaryFile(mode="w+")
        workers.append((subprocess.Popen(cmd, env=env, stdout=out_f,
                                         stderr=err_f, text=True),
                        out_f, err_f))
    deadline = time.monotonic() + args.timeout
    timed_out = False
    while any(p.poll() is None for p, _, _ in workers):
        if (time.monotonic() > deadline
                or any(p.poll() not in (None, 0) for p, _, _ in workers)):
            timed_out = time.monotonic() > deadline
            for p, _, _ in workers:
                if p.poll() is None:
                    p.kill()
            break
        time.sleep(0.05)
    rc = 0
    for pid, (p, out_f, err_f) in enumerate(workers):
        p.wait()
        out_f.seek(0)
        err_f.seek(0)
        out, err = out_f.read(), err_f.read()
        out_f.close()
        err_f.close()
        if pid == 0:
            sys.stdout.write(out)
        if p.returncode != 0:
            why = "timed out" if timed_out else f"failed rc={p.returncode}"
            print(f"[runner] worker {pid} {why}:\n" + err[-3000:],
                  file=sys.stderr)
            rc = 1
    if rdzv is not None:
        shutil.rmtree(rdzv, ignore_errors=True)
    if args.trace and rc == 0:
        from repro_torch.obs.export import merge_trace_files
        paths = [f"{args.trace}.w{pid}" for pid in range(args.spawn)]
        merge_trace_files(paths, args.trace)    # pid i = rank i
        for p in paths:
            os.remove(p)
        print(f"[runner] merged {args.spawn} worker traces -> {args.trace}",
              flush=True)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--spawn", type=int, default=0,
                    help="spawn N localhost worker processes and exit")
    ap.add_argument("--devices-per-process", type=int, default=1,
                    help="must be 1: one rank per device (several shards "
                         "in one process are not supported)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (rank r on cuda:{r %% device_count}) or cpu")
    ap.add_argument("--port", type=int, default=0,
                    help="coordinator port on localhost (0 = a file:// "
                         "store in a temporary directory, unless "
                         "REPRO_COORDINATOR is set)")
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--scale", type=float, default=0.03)
    ap.add_argument("--pool", type=int, default=90)
    ap.add_argument("--users", type=int, default=3)
    ap.add_argument("--max-batch", type=int, default=None,
                    help="stage-2 row budget (default: the --plan file's "
                         "value, else 256)")
    ap.add_argument("--min-bucket", type=int, default=None,
                    help="smallest bucket (default: the --plan file's "
                         "value, else 16)")
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--verify", action="store_true",
                    help="hold sharded scores to the local engine's "
                         "(2e-4, or the int8 bound)")
    ap.add_argument("--bench", action="store_true",
                    help="emit qps rows per mode")
    ap.add_argument("--device-resident", action="store_true",
                    help="request the device rep tier (a multi-process "
                         "engine keeps it off and re-stacks)")
    ap.add_argument("--compress-scores", action="store_true",
                    help="opt-in int8-compressed score all-gather")
    ap.add_argument("--plan", default=None, metavar="PATH",
                    help="base ServePlan JSON file (spawner: sharding is "
                         "forced on top of it)")
    ap.add_argument("--plan-json", default=None, metavar="JSON",
                    help="worker-side: the serialized plan shipped by the "
                         "spawner")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="spawner: merge per-worker Chrome traces here "
                         "(pid = rank); worker: write own trace")
    ap.add_argument("--timeout", type=int, default=900,
                    help="seconds for the whole run (spawner) and for the "
                         "rendezvous and each collective (workers)")
    args = ap.parse_args(argv)
    if args.devices_per_process != 1:
        ap.error(f"--devices-per-process {args.devices_per_process}: the "
                 f"port runs one rank per device (one shard per process); "
                 f"spawn one worker per device instead")
    if args.spawn:
        return spawn(args)
    return run_worker(args)


if __name__ == "__main__":
    sys.exit(main())
