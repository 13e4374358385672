"""The port's distributed serving across processes on the CPU: ranks are
subprocesses joined over gloo (a ``file://`` rendezvous in ``tmp_path``,
so parallel tests never race for a port). The worker code imports no jax.

* the collectives (``compressed_psum``, ``compressed_all_gather``,
  ``gather_rows``) over 2 ranks against their numpy formulas;
* slice parity: 2 ranks serve the paper model at ``scaled(0.03)`` in
  vani / uoi / mari with ``max_batch=100`` (not a power of two) on the
  reference's params and feeds, within fp32 rtol = atol = 2e-4 of the
  reference's local JAX ``ServingEngine`` and of the port's local engine,
  and within the int8 bound under ``compress_scores``;
* no collective's size or order depends on the cold tier's promotions;
* the runner CLI: ``--spawn 2 --verify --device cpu`` and 3 ranks over 2
  shards (the third rank serves no rows and still receives the scores).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.serve as jserve
from repro.data.features import make_recsys_feeds
from repro.graph.executor import init_graph_params
from repro.models.ranking import PaperRankingConfig, build_paper_ranking_model

SRC = str(Path(__file__).resolve().parents[1] / "src")
TOL = dict(rtol=2e-4, atol=2e-4)
MODES = ("vani", "uoi", "mari")
POOLS = (40, 77, 130)

WORKER = r'''
import json, sys, time
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common import params_from_numpy
from repro_torch.dist.compress import compressed_all_gather, compressed_psum
from repro_torch.dist.sharding import gather_rows
from repro_torch.dist.topology import Topology
from repro_torch.models.ranking import (PaperRankingConfig,
                                        build_paper_ranking_model)
from repro_torch.serve import ServePlan, ServeRequest, ServingEngine

task, d = sys.argv[1], sys.argv[2]
topo = Topology.from_env().initialize("cpu", timeout_s=60)
rank = topo.process_id
out, meta = {}, {"world": dist.get_world_size()}


def load_problem():
    z = np.load(f"{d}/problem.npz")
    params, reqs = {}, []
    for k in z.files:
        if k.startswith("p::"):
            _, node, leaf = k.split("::")
            params.setdefault(node, {})[leaf] = z[k]
    for u in range(int(z["users"])):
        feeds = {"user": {}, "cand": {}}
        for k in z.files:
            if k.startswith(f"u{u}::"):
                _, role, name = k.split("::")
                feeds[role][name] = z[k]
        reqs.append(ServeRequest(u, feeds["user"], feeds["cand"]))
    graph = build_paper_ranking_model(PaperRankingConfig().scaled(0.03))[0]
    return graph, params_from_numpy(params, "cpu"), reqs


def scores(eng, reqs):
    return np.concatenate([r.scores for r in eng.score_coalesced(reqs)])


if task == "collectives":
    x = torch.from_numpy(np.random.default_rng(rank).standard_normal(
        (5, 3)).astype(np.float32)) * (rank + 1)
    mean, err = compressed_psum({"x": x})
    out = {"x": x.numpy(), "mean": mean["x"].numpy(),
           "err": err["x"].numpy(),
           "gather": compressed_all_gather(x).numpy(),
           "rows": gather_rows(x).numpy()}
elif task == "parity":
    graph, params, reqs = load_problem()
    for mode in ("vani", "uoi", "mari"):
        plan = ServePlan.preset("distributed").evolve(
            graph__mode=mode, batch__max_batch=100, batch__min_bucket=16)
        eng = ServingEngine(graph, params, plan, device="cpu")
        out[mode] = scores(eng, reqs)
        meta[mode] = {"shards": eng._n_shards, "max_batch": eng.max_batch,
                      "graphs": eng.stage2_compilations,
                      "gathers": eng.profiler.snapshot()["gather"]["calls"],
                      "stage2_calls": eng.stage2_calls}
        out[mode + "_local"] = scores(ServingEngine(
            graph, params, plan.evolve(shard__shard_candidates=False),
            device="cpu"), reqs)
    out["mari_int8"] = scores(ServingEngine(
        graph, params, ServePlan.preset("distributed").evolve(
            batch__max_batch=100, batch__min_bucket=16,
            shard__compress_scores=True), device="cpu"), reqs)
elif task == "schedule":
    graph, params, reqs = load_problem()
    log = []
    real_ag = dist.all_gather

    def logged(tensors, tensor, *a, **k):
        log.append(["all_gather", list(tensor.shape), str(tensor.dtype)])
        return real_ag(tensors, tensor, *a, **k)
    dist.all_gather = logged
    base = ServePlan.preset("distributed").evolve(
        batch__max_batch=64, batch__min_bucket=16)
    groups = [reqs[:2], reqs[2:]] * 3
    for name, plan in (
            ("plain", base),
            ("cold", base.evolve(cache__max_cached_users=1,
                                 mem__cold_tier=True,
                                 mem__promote_touches=1))):
        log.clear()
        eng = ServingEngine(graph, params, plan, device="cpu")
        got = []
        for i, group in enumerate(groups):
            got.append(scores(eng, group))
            if rank == 0:
                eng.flush_promotions()      # rank 0 promotes in step,
            else:                           # rank 1 whenever its thread runs
                time.sleep(0.001 * (i % 3))
        eng.flush_promotions()
        meta[name] = {"log": list(log), "mem": eng.mem_stats()}
        out[name] = np.concatenate(got)
        eng.close()
    local = ServingEngine(graph, params, base.evolve(
        shard__shard_candidates=False), device="cpu")
    out["local"] = np.concatenate([scores(local, g) for g in groups])

bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                     "repro")]
assert not bad, bad
np.savez(f"{d}/out{rank}.npz", **out)
with open(f"{d}/meta{rank}.json", "w") as f:
    json.dump(meta, f, default=str)
Topology.shutdown()
'''


def _run_ranks(tmp_path: Path, task: str, n: int = 2, timeout: float = 150):
    """Run the worker script as ``n`` ranks; returns per-rank (npz, meta)."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    procs = []
    for rank in range(n):
        env = dict(os.environ,
                   PYTHONPATH=SRC + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""),
                   REPRO_NUM_PROCESSES=str(n), REPRO_PROCESS_ID=str(rank),
                   REPRO_COORDINATOR=f"file://{tmp_path}/rendezvous",
                   OMP_NUM_THREADS="2")
        log = open(tmp_path / f"log{rank}.txt", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(script), task, str(tmp_path)], env=env,
            stdout=log, stderr=subprocess.STDOUT), log))
    try:
        for p, _ in procs:
            p.wait(timeout=timeout)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for rank, (p, _) in enumerate(procs):
        assert p.returncode == 0, (tmp_path / f"log{rank}.txt").read_text()[
            -3000:]
    return [(np.load(tmp_path / f"out{r}.npz"),
             json.loads((tmp_path / f"meta{r}.json").read_text()))
            for r in range(n)]


def test_collectives_over_two_gloo_ranks(tmp_path):
    (a, _), (b, _) = _run_ranks(tmp_path, "collectives")
    xs = [a["x"], b["x"]]
    scale = np.float32(max(np.abs(x).max() for x in xs)) / np.float32(127.0)
    qs = [np.clip(np.round(x / scale), -127, 127) for x in xs]
    mean = (qs[0] + qs[1]).astype(np.float32) * scale / 2
    for r, got in enumerate((a, b)):
        np.testing.assert_allclose(got["mean"], mean, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got["err"], xs[r] - qs[r] * scale,
                                   atol=1e-7)
        np.testing.assert_array_equal(got["rows"], np.concatenate(xs))
        # each block dequantized with its own shard's scale
        blocks = []
        for x in xs:
            s = np.float32(np.abs(x).max()) / np.float32(127.0)
            blocks.append(np.clip(np.round(x / s), -127, 127) * s)
        np.testing.assert_allclose(got["gather"], np.concatenate(blocks),
                                   rtol=1e-6, atol=1e-7)
    # error feedback closes: the mean plus the residuals gives back the sum
    np.testing.assert_allclose(2 * mean + a["err"] + b["err"],
                               xs[0] + xs[1], atol=1e-5)


@pytest.fixture(scope="module")
def problem():
    """The reference's paper model, params and feeds, and its local
    engine's coalesced scores per mode (``max_batch=100``)."""
    graph, _ = build_paper_ranking_model(PaperRankingConfig().scaled(0.03))
    params = init_graph_params(graph, jax.random.PRNGKey(0))
    user_in = {n.name for n in graph.input_nodes()
               if n.attrs.get("domain") == "user"}
    arrays, reqs = {"users": np.asarray(len(POOLS))}, []
    for u, n in enumerate(POOLS):
        feeds = {k: np.asarray(v) for k, v in make_recsys_feeds(
            graph, n, jax.random.PRNGKey(u + 1)).items()}
        arrays.update({f"u{u}::{'user' if k in user_in else 'cand'}::{k}":
                       v for k, v in feeds.items()})
        reqs.append(jserve.ServeRequest(
            u, {k: v for k, v in feeds.items() if k in user_in},
            {k: v for k, v in feeds.items() if k not in user_in}))
    for node, leaves in params.items():
        arrays.update({f"p::{node}::{leaf}": np.asarray(v)
                       for leaf, v in leaves.items()})
    ref = {}
    for mode in MODES:
        eng = jserve.ServingEngine(graph, params, plan=jserve.ServePlan(
            graph={"mode": mode},
            batch={"max_batch": 100, "min_bucket": 16, "hedging": False}))
        ref[mode] = np.concatenate([r.scores for r in
                                    eng.score_coalesced(reqs)])
        eng.close()
    return arrays, ref


def _write_problem(tmp_path, problem):
    np.savez(tmp_path / "problem.npz", **problem[0])


def test_two_ranks_serve_the_paper_model_within_2e4(tmp_path, problem):
    _write_problem(tmp_path, problem)
    ranks = _run_ranks(tmp_path, "parity")
    ref = problem[1]
    for got, meta in ranks:
        for mode in MODES:
            # 100 rounds down to a 64-row cap split into 32-row shards
            assert meta[mode]["shards"] == 2 and \
                meta[mode]["max_batch"] == 64, meta[mode]
            assert meta[mode]["gathers"] == meta[mode]["stage2_calls"] > 0
            np.testing.assert_allclose(got[mode], ref[mode], **TOL)
            np.testing.assert_allclose(got[mode], got[mode + "_local"],
                                       **TOL)
        tol = float(np.abs(ref["mari"]).max()) / 127.0 / 2.0 + 1e-6
        np.testing.assert_allclose(got["mari_int8"], ref["mari"], atol=tol)
        assert not np.array_equal(got["mari_int8"], got["mari"])
    # both ranks hold the same full score vector
    for mode in MODES + ("mari_int8",):
        np.testing.assert_array_equal(ranks[0][0][mode], ranks[1][0][mode])


def test_no_collective_depends_on_promotions(tmp_path, problem):
    _write_problem(tmp_path, problem)
    ranks = _run_ranks(tmp_path, "schedule")
    (_, m0), (_, m1) = ranks
    # the same collectives, in the same order and sizes, on both ranks and
    # with or without the cold tier (whose promotions run on a thread)
    assert m0["cold"]["log"] == m1["cold"]["log"] == m0["plain"]["log"]
    assert len(m0["plain"]["log"]) > 0
    for got, meta in ranks:
        mem = meta["cold"]["mem"]
        assert mem["cold_hits"] > 0 and mem["demotions"] > 0
        assert mem["promote"]["promotions"] > 0
        np.testing.assert_allclose(got["cold"], got["local"], **TOL)
        np.testing.assert_allclose(got["plain"], got["local"], **TOL)


def _runner(*args, timeout=150):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    p = subprocess.run([sys.executable, "-m", "repro_torch.dist.runner",
                        "--device", "cpu", "--timeout", "120", *args],
                       env=env, capture_output=True, text=True,
                       timeout=timeout)
    assert p.returncode == 0, (p.stdout[-2000:], p.stderr[-3000:])
    return [json.loads(line) for line in p.stdout.strip().splitlines()
            if line.startswith("{")]


def test_runner_spawns_two_ranks_and_verifies(tmp_path):
    # a plan file whose fault injector drops each rank's first heartbeat
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"ft": {
        "inject": True, "sites": ["spmd_heartbeat:error:count=1"]}}))
    recs = _runner("--spawn", "2", "--verify", "--plan", str(plan),
                   "--max-batch", "100", "--min-bucket", "16")
    done = [r for r in recs if r.get("within_2e-4")]
    assert {r["mode"] for r in done} == set(MODES)
    assert all(r["processes"] == 2 and r["shards"] == 2
               and r["backend"] == "gloo" and len(r["per_rank"]) == 2
               and r["plan"]["batch"]["max_batch"] == 100
               and not r["plan"]["batch"]["hedging"] for r in done)
    # one missed beat (step 1) degrades, the next beats keep w0 alive
    assert [r["heartbeat"]["missed"] for r in done] == [1, 1, 1]
    assert [r["heartbeat"]["step"] for r in done] == [1, 2, 3]
    assert all(r["heartbeat"]["dead"] == [] for r in done)
    assert recs[-1] == {"ok": True, "records": 3}


def test_runner_third_rank_serves_no_rows_but_receives_scores():
    recs = _runner("--spawn", "3", "--verify", "--modes", "mari",
                   "--compress-scores")
    rec = recs[0]
    assert rec["processes"] == 3 and rec["shards"] == 2
    assert [r["shard_rank"] for r in rec["per_rank"]] == [0, 1, None]
    assert [r["stage2_compilations"] > 0 for r in rec["per_rank"]] == \
        [True, True, False]
    assert rec["within_int8_bound"] and recs[-1]["ok"]
