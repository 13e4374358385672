"""Compiled execution on the CPU (``repro_torch.graph.compiled``): the
signature cache (counted like the reference's ``stage2_compilations`` in
tests/test_serve_two_stage.py), the static-buffer copy-in / copy-out,
calls in flight at one signature, the launch counts recorded at capture
and added per replay, and compiled engines (paper, DIN, DLRM) against the
JAX reference's per-request ``score()`` on the same params moved across
with ``params_from_numpy``; fp32 rtol = atol = 2e-4, never bitwise.

On the CPU an entry runs its body eagerly on the static buffers in place
of a replay; the capture itself is held on the card
(tests/test_torch_gpu.py).
"""
import math
import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.graph.executor import init_graph_params
from repro.models.ranking import PaperRankingConfig as JPaperCfg
from repro.models.ranking import build_paper_ranking_model as j_paper
from repro.models.recsys import build_din as j_din
from repro.serve import ServePlan as JPlan, ServeRequest as JRequest
from repro.serve import ServingEngine as JEngine
import repro_torch.configs as tconfigs
from repro_torch.common import params_from_numpy
from repro_torch.graph.compiled import CompiledRun, GraphPool
from repro_torch.graph.executor import Executor
from repro_torch.kernels import build
from repro_torch.models.ranking import PaperRankingConfig as TPaperCfg
from repro_torch.models.ranking import build_paper_ranking_model as t_paper
from repro_torch.models.recsys import build_din as t_din
from repro_torch.serve import ServePlan as TPlan, ServeRequest as TRequest
from repro_torch.serve import ServingEngine as TEngine

TOL = dict(rtol=2e-4, atol=2e-4)
DIN_SMOKE = dict(embed_dim=8, seq_len=12, attn_mlp=(16, 8), mlp=(24, 12),
                 item_vocab=128)


def _affine(params, feeds):
    """A small body: y = x @ w + b (+ the stacked table's row sum)."""
    y = feeds["x"] @ params["w"] + params["b"]
    if "t" in feeds:
        y = y + feeds["t"].sum()
    return {"y": y, "x2": feeds["x"] * 2}


def _params(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(4, 3, generator=g),
            "b": torch.randn(3, generator=g)}


def _x(n, seed):
    return torch.randn(n, 4, generator=torch.Generator().manual_seed(seed))


# -- CompiledRun ------------------------------------------------------------

def test_signature_cache_counts_like_jit():
    run = CompiledRun(_affine, device="cpu")
    p = _params()
    for n in (8, 16, 8, 16, 8):
        run(p, {"x": _x(n, n)})
    assert run.compilations == 2                  # one entry per shape
    # a dtype is part of the signature, as a shape is
    assert len({run.signature(p, {"x": _x(8, 1)}),
                run.signature(p, {"x": _x(8, 1).double()})}) == 2
    q = _params(1)                                # other params: new entry
    run(q, {"x": _x(8, 2)})
    assert run.compilations == 3
    run(q, {"x": _x(8, 3)})
    assert run.compilations == 3                  # warm: nothing new


def test_refs_are_keyed_by_address():
    run = CompiledRun(_affine, device="cpu")
    p = _params()
    t1, t2 = torch.ones(5, 3), torch.ones(5, 3)
    run(p, {"x": _x(8, 0)}, refs={"t": t1})
    run(p, {"x": _x(8, 0)}, refs={"t": t1})
    assert run.compilations == 1
    out = run(p, {"x": _x(8, 0)}, refs={"t": t2})
    assert run.compilations == 2                  # a new address
    # read in place: a write to the ref shows in the next call
    t2.mul_(2)
    again = run(p, {"x": _x(8, 0)}, refs={"t": t2})
    torch.testing.assert_close(again["y"], out["y"] + 15.0)


def test_copy_in_copy_out_matches_eager():
    run = CompiledRun(_affine, device="cpu")
    p = _params()
    for n, seed in ((8, 0), (8, 1), (3, 2)):
        x = _x(n, seed)
        got = run(p, {"x": x})
        want = _affine(p, {"x": x})
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    # a numpy feed and a list feed stacked along dim 0 at copy-in
    xs = [_x(2, 5), _x(3, 6), _x(3, 7)]
    got = run(p, {"x": xs})
    torch.testing.assert_close(got["y"], _affine(p, {"x": torch.cat(xs)})["y"])
    got = run(p, {"x": xs[1].numpy()})
    torch.testing.assert_close(got["y"], _affine(p, {"x": xs[1]})["y"])


def test_body_runs_on_the_static_buffers():
    seen = []

    def body(params, feeds):
        seen.append(feeds["x"].data_ptr())
        return {"y": feeds["x"] + 1}

    run = CompiledRun(body, device="cpu")
    a, b = _x(4, 0), _x(4, 1)
    run({}, {"x": a})
    run({}, {"x": b})
    assert len(set(seen)) == 1                    # one static buffer
    assert seen[0] not in (a.data_ptr(), b.data_ptr())


def test_calls_in_flight_keep_their_own_outputs():
    """Two calls at one signature, the first's outputs held while the
    second runs: each keeps its own values (outputs are copies, never the
    entry's static outputs)."""
    run = CompiledRun(_affine, device="cpu")
    p = _params()
    xa, xb = _x(8, 10), _x(8, 11)
    out_a = run(p, {"x": xa})
    out_b = run(p, {"x": xb})
    out_b2 = run(p, {"x": xb})
    torch.testing.assert_close(out_a["y"], _affine(p, {"x": xa})["y"])
    torch.testing.assert_close(out_b["y"], _affine(p, {"x": xb})["y"])
    ptrs = {o["y"].data_ptr() for o in (out_a, out_b, out_b2)}
    assert len(ptrs) == 3                         # each call its own copy


def test_concurrent_callers_at_one_signature():
    """More threads than cores, a short switch interval: copy-in, run and
    copy-out of one entry are atomic under the pool's lock, so no caller
    ever reads another caller's result."""
    run = CompiledRun(_affine, device="cpu")
    p = _params()
    xs = [_x(8, 100 + i) for i in range(3 * (os.cpu_count() or 2))]
    want = [_affine(p, {"x": x})["y"] for x in xs]
    bad = []

    def work(i):
        for _ in range(20):
            y = run(p, {"x": xs[i]})["y"]
            if not torch.equal(y, want[i]):
                bad.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert bad == [] and run.compilations == 1


def test_launch_counts_recorded_at_capture_added_per_replay():
    """A capture runs nothing on the card: count_launch inside
    ``recording_launches`` is recorded, not counted, and ``add_launches``
    counts the record once per replay. Other threads keep counting."""
    counts = {"k": 0, "j": 0}
    with build.recording_launches() as rec:
        build.count_launch(counts, "k")
        build.count_launch(counts, "k")
        build.count_launch(counts, "j")
        other = threading.Thread(target=build.count_launch,
                                 args=(counts, "j"))
        other.start()
        other.join()
    assert counts == {"k": 0, "j": 1}             # the other thread counted
    for _ in range(3):                            # three replays
        build.add_launches(rec)
    assert counts == {"k": 6, "j": 4}
    build.count_launch(counts, "k")               # recording is over
    assert counts["k"] == 7


def test_pool_on_the_cpu():
    pool = GraphPool("cpu")
    assert pool.handle is None and pool.capture_stream is None
    run = CompiledRun(_affine, device="cpu", pool=pool)
    assert run.pool is pool


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        CompiledRun(_affine)


def test_compiled_single_call_matches_eager_executor():
    graph = t_paper(TPaperCfg().scaled(0.05))[0]
    from repro_torch.graph.executor import init_graph_params as t_init
    params = t_init(graph, seed=0, device="cpu")
    rng = np.random.default_rng(3)
    feeds = {}
    for node in graph.input_nodes():
        n = 1 if node.attrs["domain"] == "user" else 37
        feeds[node.name] = torch.as_tensor(rng.standard_normal(
            (n,) + tuple(node.attrs["shape"])).astype(np.float32))
    for mode in ("vani", "uoi"):
        ex = Executor(graph, mode, device="cpu")
        run = CompiledRun(ex.run, device="cpu")
        with torch.inference_mode():
            want = ex.run(params, feeds)
        for _ in range(2):
            got = run(params, feeds)
            for o in graph.outputs:
                torch.testing.assert_close(got[o], want[o], **TOL)
        assert run.compilations == 1


# -- compiled engines against the reference --------------------------------

def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _feeds(graph, n, rng):
    vocab = {c.inputs[0]: c.attrs["vocab"] for c in graph.nodes.values()
             if c.op == "embedding"}
    user, cand = {}, {}
    for node in graph.input_nodes():
        is_user = node.attrs["domain"] == "user"
        shape = (1 if is_user else n,) + tuple(node.attrs["shape"])
        if node.attrs.get("dtype", "float32").startswith("int"):
            a = rng.integers(0, vocab[node.name], shape).astype(np.int32)
        else:
            a = rng.standard_normal(shape).astype(np.float32)
        (user if is_user else cand)[node.name] = a
    return user, cand


def _graphs(model):
    if model == "paper":
        return (j_paper(JPaperCfg().scaled(0.05))[0],
                t_paper(TPaperCfg().scaled(0.05))[0])
    if model == "din":
        return j_din(**DIN_SMOKE)[0], t_din(**DIN_SMOKE)[0]
    return (jconfigs.get_config(model).smoke_build()()[0],
            tconfigs.get_config(model).smoke_build()()[0])


@pytest.mark.parametrize("preset", ["paper", "tpu"])
@pytest.mark.parametrize("model", ["paper", "din", "dlrm-mlperf"])
def test_compiled_engine_matches_reference(model, preset):
    """Per-request and coalesced scores of the compiled engine against the
    reference's per-request score(); stage 2 builds one entry per (rows,
    bucket) shape it served, stage 1 one per user-feed signature, and a
    repeated warm pass builds nothing."""
    jg, tg = _graphs(model)
    jp = init_graph_params(jg, jax.random.PRNGKey(5))
    fields = dict(batch__max_batch=64, batch__min_bucket=8)
    jeng = JEngine(jg, jp, JPlan.preset(preset).evolve(batch__hedging=False,
                                                       **fields))
    teng = TEngine(tg, params_from_numpy(_np_tree(jp), "cpu"),
                   TPlan.preset(preset).evolve(**fields), device="cpu")
    rng = np.random.default_rng(6)
    pools = ((0, 11), (1, 70), (2, 5), (2, 9))
    feeds = [_feeds(jg, n, rng) for _, n in pools]
    want = [jeng.score(JRequest(u, uf, cf)).scores
            for (u, _), (uf, cf) in zip(pools, feeds)]
    treqs = [TRequest(u, uf, cf) for (u, _), (uf, cf) in zip(pools, feeds)]
    for _ in range(2):                            # cold, then warm
        per = [teng.score(r) for r in treqs]
        co = teng.score_coalesced(treqs)
        for w, p, c in zip(want, per, co):
            np.testing.assert_allclose(p.scores, w, **TOL)
            np.testing.assert_allclose(c.scores, w, **TOL)
        if _ == 0:
            built = (teng.stage1_compilations, teng.stage2_compilations)
    assert (teng.stage1_compilations, teng.stage2_compilations) == built
    assert teng.stage2_compilations == teng.stage2_shapes \
        == teng.stage2_routes
    assert teng.stage1_compilations == 1          # one user-feed signature
    assert teng.graph_pool.captures == 0          # no capture on the CPU


def test_stage2_compilations_bounded_like_the_reference():
    """tests/test_serve_two_stage.py TestBucketedBatching: one compile
    across pool sizes under one bucket, and the pow2 bound across
    buckets (counted on the port's engine)."""
    _, tg = _graphs("paper")
    from repro_torch.graph.executor import init_graph_params as t_init
    params = t_init(tg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    eng = TEngine(tg, params, TPlan.preset("paper").evolve(
        batch__max_batch=128, batch__hedging=False), device="cpu")
    for n in (100, 1000, 3000):
        uf, cf = _feeds(tg, n, rng)
        assert eng.score(TRequest(0, uf, cf)).scores.shape[0] == n
    assert eng.stage2_compilations == 1
    eng = TEngine(tg, params, TPlan.preset("paper").evolve(
        batch__max_batch=4096, batch__hedging=False), device="cpu")
    sizes = (100, 1000, 3000)
    for n in sizes:
        uf, cf = _feeds(tg, n, rng)
        eng.score(TRequest(0, uf, cf))
    bound = math.ceil(math.log2(max(sizes) / min(sizes))) + 1
    assert eng.stage2_compilations <= bound
    assert eng.stage2_compilations == eng.stage2_shapes


def test_device_tier_and_restacking_are_two_routes():
    """A device-tier pack and a re-stacked pack at the same (rows, bucket)
    read their tables differently (in place / copied), so they are two
    graphs of one shape: stage2_compilations follows stage2_routes."""
    _, tg = _graphs("paper")
    from repro_torch.graph.executor import init_graph_params as t_init
    params = t_init(tg, seed=0, device="cpu")
    eng = TEngine(tg, params, TPlan.preset("paper").evolve(
        batch__max_batch=64, batch__min_bucket=64, batch__hedging=False,
        cache__device_resident=True, cache__device_slots=2), device="cpu")
    rng = np.random.default_rng(1)
    reqs = [TRequest(u, *_feeds(tg, 10, rng)) for u in range(3)]
    eng.score_coalesced(reqs[:2])                 # both fit: slots (2, 64)
    eng.score_coalesced(reqs)                     # 3 users: overflow
    assert eng.device_store.stats()["overflows"] > 0
    assert eng.stage2_compilations == eng.stage2_routes
    assert eng.stage2_routes >= eng.stage2_shapes


def test_feed_order_does_not_add_graphs():
    """Requests listing their candidate (and user) feeds in another order
    reuse the same graphs: the engine feeds them in the pinned signature's
    order."""
    _, tg = _graphs("paper")
    from repro_torch.graph.executor import init_graph_params as t_init
    params = t_init(tg, seed=0, device="cpu")
    eng = TEngine(tg, params, TPlan.preset("paper").evolve(
        batch__max_batch=64, batch__min_bucket=64, batch__hedging=False),
        device="cpu")
    rng = np.random.default_rng(2)
    uf, cf = _feeds(tg, 20, rng)
    a = eng.score(TRequest(0, uf, cf)).scores
    rev = TRequest(1, dict(reversed(list(uf.items()))),
                   dict(reversed(list(cf.items()))))
    b = eng.score(rev).scores
    np.testing.assert_array_equal(a, b)
    assert eng.stage2_compilations == 1 and eng.stage1_compilations == 1
