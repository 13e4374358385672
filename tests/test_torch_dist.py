"""The port's distributed serving pieces on the CPU, in one process, held
against the JAX reference: the collective-aware bucket planner, the shard
count, the stage-2 placements, int8 compression, the ``ShardPlan`` section
and the ``distributed`` preset, the heartbeat monitor and elastic remesh,
the batcher's refusal of a multi-process engine, the topology, and a
sharded engine without a process group (one shard, the int8 score gather
applied locally). The multi-process tests are in ``test_torch_dist_spmd.py``.
"""
import dataclasses
import types
import warnings

import jax
import numpy as np
import pytest
import torch

import repro.dist.compress as jcomp
import repro.dist.topology as jtopo
import repro.ft.failures as jfail
import repro.serve as jserve
import repro_torch.dist.compress as tcomp
import repro_torch.dist.topology as ttopo
import repro_torch.ft.failures as tfail
import repro_torch.serve as tserve
from repro.core.split import rep_table_pspecs as j_rep_pspecs
from repro.dist.sharding import candidate_pspecs as j_pspecs
from repro.graph.executor import init_graph_params
from repro.models.ranking import PaperRankingConfig as JPaperCfg
from repro.models.ranking import build_paper_ranking_model as j_paper
from repro_torch.common import params_from_numpy
from repro_torch.core.split import rep_table_pspecs as t_rep_pspecs
from repro_torch.dist import runner
from repro_torch.dist.sharding import candidate_pspecs as t_pspecs
from repro_torch.dist.sharding import world
from repro_torch.models.ranking import PaperRankingConfig as TPaperCfg
from repro_torch.models.ranking import build_paper_ranking_model as t_paper
from repro_torch.serve.batcher import CoalescingBatcher

POOLS = (0, 1, 2, 3, 7, 15, 16, 17, 100, 511, 512, 1000, 4096, 4097, 10000)


# -- the bucket planner --------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("max_batch", [5, 64, 100, 1000, 1024, 4096])
def test_bucket_planner_matches_reference(shards, max_batch):
    for min_bucket in (1, 2, 16, 32, 128, 5000):
        kw = dict(min_bucket=min_bucket, max_batch=max_batch)
        for n in POOLS:
            assert ttopo.bucket_for(n, shards, **kw) == \
                jtopo.bucket_for(n, shards, **kw), (n, kw)
            assert ttopo.plan_buckets(n, shards, **kw) == \
                jtopo.plan_buckets(n, shards, **kw), (n, kw)


def test_bucket_planner_invariants_and_rejections():
    for shards in (1, 2, 4, 8, 16):
        for pool in POOLS[1:]:
            plan = ttopo.plan_buckets(pool, shards, min_bucket=32,
                                      max_batch=1024)
            assert all(b % shards == 0 and (b & (b - 1)) == 0
                       and ((b // shards) & (b // shards - 1)) == 0
                       for b in plan)
            assert 0 <= sum(plan) - pool < plan[-1]
    assert ttopo.bucket_for(100, 8, min_bucket=16, max_batch=100) == 64
    assert ttopo.bucket_for(3, 8, min_bucket=2, max_batch=5) == 8
    with pytest.raises(ValueError, match="power of two"):
        ttopo.bucket_for(10, 3)


@pytest.mark.parametrize("ranks,clamp,want", [
    (1, None, 1), (2, None, 2), (3, None, 2), (4, None, 4), (7, None, 4),
    (8, 2, 2), (2, 4, 2), (5, 1, 1)])
def test_candidate_shards_is_the_reference_mesh_size(ranks, clamp, want):
    # candidate_mesh(n) over `ranks` devices: prev_pow2(ranks), clamped
    assert ttopo.candidate_shards(ranks, clamp) == want
    with pytest.raises(ValueError, match="power of two"):
        ttopo.candidate_shards(ranks, 3)


# -- placements ----------------------------------------------------------------

def test_candidate_pspecs_mean_the_reference_specs():
    from jax.sharding import PartitionSpec as P
    (jp, jt, ju, jc), jout = j_pspecs(jtopo.candidate_mesh(),
                                      replicate_out=True)
    (tp, tt, tu, tc), tout = t_pspecs()
    mean = {P(): "Replicate", P("cand"): "Shard(dim=0)"}
    for j, t in ((jp, tp), (jt, tt), (ju, tu), (jc, tc), (jout, tout)):
        want = mean[j.spec]
        assert (t.is_replicate() if want == "Replicate"
                else t.is_shard(dim=0)), (j.spec, t)
    _, rows = t_pspecs(replicate_out=False)
    assert rows.is_shard(dim=0)
    specs = {"u": (4,), "keys": (6, 5)}
    assert set(t_rep_pspecs(specs)) == set(j_rep_pspecs(specs))
    assert all(len(p) == 1 and p[0].is_replicate()
               for p in t_rep_pspecs(specs).values())


# -- int8 compression ----------------------------------------------------------

VECTORS = ([0.0], [0.0, 0.0], [-1e3, 333.3, 0.1], [1e-6],
           list(np.linspace(-1, 1, 64)), [127.0, -127.0],
           # ties: 0.5 / 1.5 / 2.5 / -0.5 at scale 1 round half to even
           [127.0, 0.5, 1.5, 2.5, -0.5, -2.5])


@pytest.mark.parametrize("arr", VECTORS + ("random", "random_2d"))
def test_quantize_int8_matches_reference(arr):
    rng = np.random.default_rng(7)
    if arr == "random":
        x = (rng.standard_normal(1000) * 3).astype(np.float32)
    elif arr == "random_2d":
        x = rng.standard_normal((64, 3)).astype(np.float32)
    else:
        x = np.asarray(arr, np.float32)
    jq, js = jcomp.quantize_int8(x)
    tq, ts = tcomp.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_max_ulp(np.float32(ts.item()),
                                    np.float32(np.asarray(js)), maxulp=1)
    # round trip within the bound
    back = tcomp.dequantize_int8(tq, ts).numpy()
    assert np.abs(back - x).max() <= float(ts) / 2 + 1e-6


def test_compressed_psum_one_participant_matches_reference():
    from jax.sharding import Mesh, PartitionSpec as P
    g = {"w": np.asarray([-2.0, 0.5, 1.7], np.float32),
         "b": {"c": np.asarray([[0.25, -9.0]], np.float32)}}
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    jm, _ = jax.shard_map(lambda t: jcomp.compressed_psum(t, "data"),
                          mesh=mesh, in_specs=(P(),),
                          out_specs=(P(), P()))(g)
    tm, te = tcomp.compressed_psum(
        {"w": torch.from_numpy(g["w"]), "b": {"c": torch.from_numpy(
            g["b"]["c"])}})
    for pick in (lambda t: t["w"], lambda t: t["b"]["c"]):
        tmv, tev, jmv, x = pick(tm), pick(te), pick(jm), pick(g)
        q, s = tcomp.quantize_int8(torch.from_numpy(x))
        # mean == dequantize(quantize(x)), mean + err == x
        np.testing.assert_allclose(tmv.numpy(),
                                   tcomp.dequantize_int8(q, s).numpy())
        np.testing.assert_allclose((tmv + tev).numpy(), x, atol=1e-6)
        np.testing.assert_allclose(tmv.numpy(), np.asarray(jmv), atol=1e-6)


def test_compressed_all_gather_without_a_group_is_local_roundtrip():
    x = torch.tensor([[0.3, -1.0], [2.0, 0.0]])
    got = tcomp.compressed_all_gather(x)
    q, s = tcomp.quantize_int8(x)
    torch.testing.assert_close(got, tcomp.dequantize_int8(q, s))


# -- plan ----------------------------------------------------------------------

@pytest.mark.parametrize("shard", [
    {}, {"shard_candidates": True}, {"shard_candidates": False},
    {"shard_candidates": 0}, {"shard_candidates": 2},
    {"shard_candidates": 3}, {"shard_candidates": -1},
    {"compress_scores": True},
    {"shard_candidates": True, "compress_scores": True},
    {"shard_candidates": 0, "compress_scores": True},
    {"shard_candidates": "2"}, {"compress_scores": 1}])
def test_shard_plan_resolves_as_the_reference(shard):
    def build(mod):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            try:
                return mod.ServePlan.from_dict({"shard": shard}).to_dict()
            except mod.PlanError as e:
                return ("PlanError", str(e))
    ours, theirs = build(tserve), build(jserve)
    if isinstance(theirs, tuple):
        assert ours == theirs
    else:
        assert ours["shard"] == theirs["shard"]


def test_distributed_preset_is_the_reference():
    ours = tserve.ServePlan.preset("distributed").to_dict()
    assert ours == jserve.ServePlan.preset("distributed").to_dict()
    assert tserve.ServePlan.preset("distributed").preset_name() == \
        "distributed"


# -- heartbeat and remesh ------------------------------------------------------

def _heartbeat_scenario(mod):
    now = [0.0]
    mon = mod.HeartbeatMonitor(["a", "b", "c"], timeout=2.0,
                               clock=lambda: now[0])
    seen = []
    for step, beats in enumerate([("a", "b", "c"), ("a", "b"), ("a",),
                                  ("a", "c"), ("a", "b", "c")]):
        now[0] = float(step)
        for w in beats:
            mon.heartbeat(w)
        if step == 2:
            mon.remove("b")
        if step == 3:
            mon.heartbeat("b")          # sticky removal: ignored
        seen.append((sorted(mon.dead()), sorted(mon.alive())))
    now[0] = 9.0
    mon.add("b")
    seen.append((sorted(mon.dead()), sorted(mon.alive())))
    return seen


def test_heartbeat_monitor_matches_reference():
    assert _heartbeat_scenario(tfail) == _heartbeat_scenario(jfail)


@pytest.mark.parametrize("shape,axes,surviving", [
    ((4, 2), ("data", "model"), 8), ((4, 2), ("data", "model"), 7),
    ((4, 2), ("data", "model"), 3), ((2, 4, 2), ("pod", "data", "model"), 9),
    ((8, 1), ("data", "model"), 5), ((4, 4), ("data", "model"), 3)])
def test_plan_elastic_remesh_matches_reference(shape, axes, surviving):
    def plan(mod):
        try:
            return dataclasses.asdict(mod.plan_elastic_remesh(shape, axes,
                                                              surviving))
        except ValueError as e:
            return ("ValueError", str(e))
    assert plan(tfail) == plan(jfail)


def test_ft_reexports_hedge_policy_lazily():
    import repro_torch.ft as tft
    from repro_torch.serve.hedging import HedgePolicy
    assert tft.HedgePolicy is HedgePolicy and tfail.HedgePolicy is HedgePolicy
    assert tft.HeartbeatMonitor is tfail.HeartbeatMonitor


# -- batcher, topology, runner flags --------------------------------------------

def test_batcher_rejects_multiprocess_engine():
    fake = types.SimpleNamespace(_multiproc=True, max_batch=128)
    with pytest.raises(ValueError, match="multi-process"):
        CoalescingBatcher(fake)


def test_single_process_topology_is_degenerate():
    topo = ttopo.Topology()
    assert not topo.is_distributed
    assert topo.backend("cpu") == "gloo"
    assert topo.device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda.is_available"):
            topo.device()
    assert world() == (1, 0)
    try:
        # a one-rank group over an in-process store: no coordinator
        topo.initialize("cpu", timeout_s=30)
        assert world() == (1, 0) and \
            torch.distributed.get_world_size() == 1
        assert topo.initialize("cpu") is topo          # idempotent
    finally:
        ttopo.Topology.shutdown()
    assert world() == (1, 0)


def test_topology_from_env_roundtrip(monkeypatch):
    monkeypatch.setenv("REPRO_NUM_PROCESSES", "4")
    monkeypatch.setenv("REPRO_PROCESS_ID", "2")
    monkeypatch.setenv("REPRO_COORDINATOR", "localhost:7777")
    topo = ttopo.Topology.from_env()
    ref = jtopo.Topology.from_env()
    assert (topo.num_processes, topo.process_id, topo.coordinator) == \
        (ref.num_processes, ref.process_id, ref.coordinator) == \
        (4, 2, "localhost:7777")
    assert topo.is_distributed and topo.backend("cpu") == "gloo"


def test_runner_refuses_several_devices_per_process(capsys):
    with pytest.raises(SystemExit):
        runner.main(["--devices-per-process", "2", "--device", "cpu"])
    assert "one rank per device" in capsys.readouterr().err


def test_runner_plan_forces_sharding_and_no_hedging():
    ns = types.SimpleNamespace(plan=None, max_batch=None, min_bucket=None,
                               compress_scores=True, device_resident=False,
                               trace=None)
    plan = runner.build_plan(ns)
    assert plan.shard.shard_candidates is True and plan.shard.compress_scores
    assert not plan.batch.hedging and plan.batch.max_batch == 256
    assert plan.batch.min_bucket == 16


# -- a sharded engine with no process group -------------------------------------

@pytest.fixture(scope="module")
def paper():
    jg = j_paper(JPaperCfg().scaled(0.03))[0]
    tg = t_paper(TPaperCfg().scaled(0.03))[0]
    jp = init_graph_params(jg, jax.random.PRNGKey(0))
    return jg, tg, jp, jax.tree_util.tree_map(np.asarray, jp)


def _request(graph, n, seed):
    rng = np.random.default_rng(seed)
    user, cand = {}, {}
    for node in graph.input_nodes():
        is_user = node.attrs["domain"] == "user"
        shape = (1 if is_user else n,) + tuple(node.attrs["shape"])
        (user if is_user else cand)[node.name] = \
            rng.standard_normal(shape).astype(np.float32)
    return user, cand


def test_unsharded_world_keeps_the_raw_cap(paper):
    _, tg, _, np_params = paper
    plan = tserve.ServePlan.preset("distributed").evolve(
        batch__max_batch=100, batch__min_bucket=8,
        shard__shard_candidates=1)
    eng = tserve.ServingEngine(tg, params_from_numpy(np_params, "cpu"),
                               plan, device="cpu")
    assert eng._n_shards == 1 and eng.max_batch == 100
    assert eng._bucket(100) == 100 and not eng._multiproc
    assert not eng._collective


def test_compress_scores_within_int8_bound_of_the_reference(paper):
    jg, tg, jp, np_params = paper
    user, cand = _request(tg, 30, seed=1)
    plan = dict(graph={"mode": "mari"},
                batch={"max_batch": 64, "min_bucket": 16, "hedging": False},
                shard={"shard_candidates": True, "compress_scores": True})
    eng = tserve.ServingEngine(tg, params_from_numpy(np_params, "cpu"),
                               tserve.ServePlan.from_dict(plan),
                               device="cpu")
    ref = jserve.ServingEngine(jg, jp, plan=jserve.ServePlan.from_dict(
        dict(plan, shard={"shard_candidates": True})))
    got = eng.score(tserve.ServeRequest(0, user, cand)).scores
    want = ref.score(jserve.ServeRequest(0, user, cand)).scores
    tol = float(np.abs(want).max()) / 127.0 / 2.0 + 1e-6
    np.testing.assert_allclose(got, want, atol=tol)
    assert eng.profiler.snapshot()["gather"]["calls"] == 1
