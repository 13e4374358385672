"""The port's serving engine and plan on the CPU: bucketing, the feed
signature drift check, the two-phase dispatch, plan validation and
resolution, and the package rule that nothing in ``repro_torch`` or
``chip_smoke.py`` imports jax or the reference package."""
import ast
import dataclasses
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.dist.topology import bucket_for as ref_bucket_for
from repro.serve.plan import PRESETS as REF_PRESETS
from repro_torch.common import feeds_from_numpy, params_from_numpy
from repro_torch.graph.executor import Executor, init_graph_params
from repro_torch.models.ranking import (PaperRankingConfig,
                                        build_paper_ranking_model)
from repro_torch.serve import (PlanError, PlanResolutionWarning, ServePlan,
                               ServeRequest, ServingEngine, bucket_for)
from repro_torch.serve.plan import PRESETS

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def paper():
    graph, _ = build_paper_ranking_model(PaperRankingConfig().scaled(0.05))
    return graph, init_graph_params(graph, seed=0, device="cpu")


def _request(graph, uid, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    user, cand = {}, {}
    for node in graph.input_nodes():
        is_user = node.attrs["domain"] == "user"
        shape = (1 if is_user else n,) + tuple(node.attrs["shape"])
        a = rng.standard_normal(shape).astype(np.float32 if is_user
                                              else dtype)
        (user if is_user else cand)[node.name] = a
    return ServeRequest(user_id=uid, user_feeds=user, candidate_feeds=cand)


def _plan(**kw):
    return ServePlan.preset("paper").evolve(batch__max_batch=64,
                                            batch__min_bucket=8, **kw)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 64, 65, 100, 4096, 5000])
@pytest.mark.parametrize("min_bucket,max_batch",
                         [(128, 4096), (8, 64), (16, 100), (200, 64)])
def test_bucket_for_matches_reference_unsharded(n, min_bucket, max_batch):
    assert bucket_for(n, min_bucket=min_bucket, max_batch=max_batch) == \
        ref_bucket_for(n, 1, min_bucket=min_bucket, max_batch=max_batch)


def test_pools_chunk_into_buckets(paper):
    graph, params = paper
    eng = ServingEngine(graph, params, _plan(), device="cpu")
    res = eng.score(_request(graph, 0, 150, seed=1))
    assert res.scores.shape == (150, 2) and res.n_batches == 3
    assert eng.stage2_calls == 3
    assert eng._batch_shapes == {(1, 64), (1, 32)}     # 64 + 64 + 22 -> 32
    assert eng.stage2_shapes == 2
    # a second user in one call packs into shared buckets (2 slots -> U=2)
    eng.score_coalesced([_request(graph, 1, 20, seed=2),
                         _request(graph, 2, 30, seed=3)])
    assert (2, 64) in eng._batch_shapes and eng.coalesced_calls == 1


def test_user_slot_budget_splits_packs(paper):
    graph, params = paper
    eng = ServingEngine(graph, params, _plan(batch__max_users_per_batch=2),
                        device="cpu")
    res = eng.score_coalesced([_request(graph, u, 5, seed=u)
                               for u in range(5)])
    assert eng.stage2_calls == 3                  # 2 + 2 + 1 users
    assert [r.n_batches for r in res] == [1] * 5


def test_feed_signature_drift_rejected(paper):
    graph, params = paper
    eng = ServingEngine(graph, params, _plan(), device="cpu")
    eng.score(_request(graph, 0, 10, seed=1))
    with pytest.raises(ValueError, match="drifted"):
        eng.score(_request(graph, 1, 10, seed=2, dtype=np.float64))
    assert eng.stage2_calls == 1                   # nothing launched


def test_cache_hits_and_lru(paper):
    graph, params = paper
    eng = ServingEngine(graph, params, _plan(cache__max_cached_users=2),
                        device="cpu")
    reqs = [_request(graph, u, 9, seed=u) for u in (0, 1, 0, 2, 1)]
    hits = [eng.score(r).user_cache_hit for r in reqs]
    assert hits == [False, False, True, False, False]
    assert eng.stage1_calls == 4 and eng.cache.evictions == 2


def test_two_phase_poll_collect(paper):
    graph, params = paper
    eng = ServingEngine(graph, params, _plan(), device="cpu")
    reqs = [_request(graph, u, 20 + u, seed=u) for u in range(3)]
    per = [eng.score(r).scores for r in reqs]
    h = eng.begin_coalesced(reqs)
    assert eng.poll(h)
    got = eng.collect(h)
    for p, g in zip(per, got):
        np.testing.assert_allclose(g.scores, p, rtol=2e-4, atol=2e-4)
        assert g.coalesced
    with pytest.raises(RuntimeError, match="not in flight"):
        eng.collect(h)


def test_single_stage_vanilla_does_not_cache(paper):
    graph, params = paper
    eng = ServingEngine(graph, params, "vanilla", device="cpu")
    assert not eng.two_stage and not eng.cache_user_reps
    r = _request(graph, 0, 12, seed=4)
    assert eng.score(r).scores.shape == (12, 2)
    assert not eng.score(r).user_cache_hit and len(eng.cache) == 0


def test_entry_points_default_to_cuda(paper):
    """Entry points default to device='cuda'. Without a card they raise
    rather than falling back to the CPU."""
    graph, params = paper
    calls = [lambda: ServingEngine(graph, params),
             lambda: init_graph_params(graph, seed=0),
             lambda: Executor(graph),
             lambda: params_from_numpy({"w": np.zeros(2)}),
             lambda: feeds_from_numpy({"x": np.zeros(2)})]
    for call in calls:
        if torch.cuda.is_available():
            call()
        else:
            with pytest.raises(RuntimeError, match="cuda.is_available"):
                call()


def test_bridge_copies(paper):
    src = {"a": {"w": np.ones((2, 3), np.float32)}}
    t = params_from_numpy(src, "cpu")
    t["a"]["w"].add_(1)
    assert src["a"]["w"].sum() == 6 and t["a"]["w"].dtype == torch.float32
    f = feeds_from_numpy({"ids": np.arange(4, dtype=np.int32)}, "cpu")
    assert f["ids"].dtype == torch.int32


# -- plan -------------------------------------------------------------------

@pytest.mark.parametrize("bad,match", [
    ({"shard": {"shard_candidates": True}}, "unknown plan sections"),
    ({"obs": {"trace": True, "trace_capacity": 0}},
     "trace_capacity must be >= 1"),
    ({"dist": {"cold_tier": True}}, "unknown plan sections"),
    ({"shard": {"compress_scores": True}}, "unknown plan sections"),
    ({"graph": {"mode": "tiled"}}, "unknown mode"),
    ({"graph": {"mode": "vani", "two_stage": True}}, "no user-only stage"),
    ({"batch": {"max_batch": 0}}, "max_batch must be >= 1"),
    ({"batch": {"min_bucket": -1}}, "min_bucket must be >= 1"),
    ({"batch": {"max_users_per_batch": 0}}, "max_users_per_batch"),
    ({"cache": {"max_cached_users": 0}}, "max_cached_users"),
    ({"batch": {"max_batch": "64"}}, "batch.max_batch must be int"),
    ({"batch": {"max_batch": True}}, "batch.max_batch must be int"),
    ({"kernel": {"use_pallas": 1}}, "kernel.use_pallas must be bool"),
    ({"graph": "mari"}, "must be a GraphPlan or a dict"),
])
def test_plan_rejections(bad, match):
    with pytest.raises(PlanError, match=match):
        ServePlan.from_dict(bad)


@pytest.mark.parametrize("fields,resolved", [
    ({"kernel": {"kernel_gather": True}}, ("kernel", "kernel_gather")),
    ({"kernel": {"gather_attention": True}},
     ("kernel", "gather_attention")),
    ({"graph": {"mode": "uoi", "reparam_attention": True}},
     ("graph", "reparam_attention")),
    ({"graph": {"mode": "vani", "fragment": True}}, ("graph", "fragment")),
])
def test_plan_resolutions_warn_and_drop(fields, resolved):
    with pytest.warns(PlanResolutionWarning):
        plan = ServePlan.from_dict(fields)
    assert getattr(getattr(plan, resolved[0]), resolved[1]) is False
    assert plan.resolution_notes


def test_plan_min_bucket_clamp_and_evolve():
    plan = ServePlan().evolve(batch__max_batch=32, batch__min_bucket=128)
    assert plan.batch.min_bucket == 32
    with pytest.raises(TypeError, match="section__field|<section>__<field>"):
        ServePlan().evolve(max_batch=3)
    with pytest.raises(PlanError):
        ServePlan.preset("distributed")


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_presets_round_trip_and_mean_what_reference_means(name, tmp_path):
    plan = ServePlan.preset(name)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert ServePlan.from_json(plan.to_json()) == plan
    path = tmp_path / "plan.json"
    plan.save(str(path))
    assert ServePlan.load(str(path)) == plan and plan.preset_name() == name
    # every field the port keeps has the reference preset's value
    ref = REF_PRESETS[name].to_dict()
    for section, fields in plan.to_dict().items():
        for field, value in fields.items():
            assert ref[section][field] == value, (section, field)


def test_plan_sections_are_a_subset_of_the_reference():
    ref = REF_PRESETS["paper"]
    for section in ("graph", "kernel", "batch", "cache"):
        ours = {f.name for f in dataclasses.fields(getattr(ServePlan(),
                                                           section))}
        theirs = {f.name for f in dataclasses.fields(getattr(ref, section))}
        assert ours <= theirs


# -- the package never imports jax or the reference -----------------------

def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            # the card's machine has no jax and no msgpack
            assert top not in ("jax", "jaxlib", "repro", "msgpack"), (path,
                                                                      name)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.serve, "
            "repro_torch.graph.executor, repro_torch.kernels.build, "
            "repro_torch.models.recsys, repro_torch.models.ranking, "
            "repro_torch.configs, repro_torch.data.features, "
            "repro_torch.launch.serve, repro_torch.obs.metrics, "
            "repro_torch.ft.recovery, repro_torch.serve.service, "
            "repro_torch.kernels.dot_interaction, "
            "repro_torch.kernels.din_attention, repro_torch.train, "
            "repro_torch.train.loop, repro_torch.ckpt, "
            "repro_torch.launch.train, repro_torch.examples.quickstart, "
            "repro_torch.examples.train_then_convert, "
            "repro_torch.nn.embedding, repro_torch.kernels.embedding_bag, "
            "repro_torch.ft, repro_torch.ft.faults, "
            "repro_torch.serve.hedging, repro_torch.serve.cache; "
            "[repro_torch.configs.get_config(a) for a in "
            "('din', 'deepfm', 'fm', 'dlrm-mlperf', 'paper-ranking')]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'msgpack')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_user_rep_cache_matches_reference():
    from repro.serve.cache import UserRepCache as RefCache
    from repro_torch.serve import UserRepCache
    ops = [("put", (1, 0)), ("put", (2, 0)), ("get", (1, 0)), ("put", (3, 0)),
           ("get", (2, 0)), ("put", (1, 1)), ("get", (1, 0)), ("get", (1, 1)),
           ("inv", 1), ("get", (1, 1)), ("put", (4, 0)), ("get", (3, 0))]
    ref, ours = RefCache(max_users=2), UserRepCache(max_users=2)
    for op, arg in ops:
        if op == "put":
            for c in (ref, ours):
                c.put(arg, {"x": arg})
        elif op == "get":
            assert ours.get(arg) == ref.get(arg), arg
        else:
            assert ours.invalidate_user(arg) == ref.invalidate_user(arg)
        assert len(ours) == len(ref)
        assert all((k in ours) == (k in ref) for k in ((1, 0), (1, 1), (3, 0)))
    for field in ("hits", "misses", "evictions", "users"):
        assert ours.stats()[field] == ref.stats()[field], field
