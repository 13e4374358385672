"""The port (``repro_torch``, on the CPU) held against the JAX reference
(``repro``): the same graphs, the same params and the same numpy-seeded
feeds through both packages' executors, weight conversion and serving
engines. The oracle is the reference's per-request ``score()``; tolerance
fp32 rtol = atol = 2e-4 (tests/test_kernels.py), never bitwise — the
reference itself differs by ~1e-7 across packings on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.mari as jmari
import repro.core.split as jsplit
from repro.graph.executor import Executor as JExecutor, init_graph_params
from repro.graph.ir import GraphBuilder as JBuilder
from repro.models.ranking import (PaperRankingConfig as JPaperCfg,
                                  build_paper_ranking_model as j_paper)
from repro.models.recsys import build_din as j_din
from repro.serve import ServePlan as JPlan, ServeRequest as JRequest
from repro.serve import ServingEngine as JEngine
import repro_torch.core.mari as tmari
import repro_torch.core.split as tsplit
from repro_torch.common import params_from_numpy
from repro_torch.graph.executor import Executor as TExecutor
from repro_torch.graph.ir import GraphBuilder as TBuilder
from repro_torch.models.ranking import (PaperRankingConfig as TPaperCfg,
                                        build_paper_ranking_model as t_paper)
from repro_torch.models.recsys import build_din as t_din
from repro_torch.serve import ServePlan as TPlan, ServeRequest as TRequest
from repro_torch.serve import ServingEngine as TEngine

TOL = dict(rtol=2e-4, atol=2e-4)
DIN_SMOKE = dict(embed_dim=8, seq_len=12, attn_mlp=(16, 8), mlp=(24, 12),
                 item_vocab=128)       # configs/din.py smoke_build widths


def _quickstart(builder_cls):
    """examples/quickstart.py's graph at small widths."""
    b = builder_cls()
    user = b.input("user_profile", shape=(40,), domain="user")
    item = b.input("item_feats", shape=(12,), domain="item")
    cross = b.input("cross_feats", shape=(10,), domain="cross")
    u_emb = b.dense("user_tower", user, 16, activation="relu")
    fusion = b.concat("fusion", [u_emb, item, cross])
    h = b.dense("fc1", fusion, 24, activation="relu")
    h = b.dense("fc2", h, 8, activation="gelu")
    b.output(b.dense("ctr_logit", h, 1))
    return b.graph


def _graphs(model):
    if model == "quickstart":
        return _quickstart(JBuilder), _quickstart(TBuilder)
    if model == "paper":
        return (j_paper(JPaperCfg().scaled(0.05))[0],
                t_paper(TPaperCfg().scaled(0.05))[0])
    return j_din(**DIN_SMOKE)[0], t_din(**DIN_SMOKE)[0]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _feeds(graph, n, rng):
    """numpy feeds: user inputs at batch 1, candidate inputs at n."""
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


def _node_sig(n):
    return (n.op, tuple(n.inputs), dict(n.attrs))


@pytest.mark.parametrize("model", ["quickstart", "paper", "din"])
def test_builders_rewrite_and_split_match_reference(model):
    jg, tg = _graphs(model)
    assert list(jg.nodes) == list(tg.nodes) and jg.outputs == tg.outputs
    assert all(_node_sig(jg.nodes[k]) == _node_sig(tg.nodes[k])
               for k in jg.nodes)
    jc = jmari.mari_rewrite(jg, reparam_attention=True)
    tc = tmari.mari_rewrite(tg, reparam_attention=True)
    assert {k: _node_sig(v) for k, v in jc.graph.nodes.items()} == \
        {k: _node_sig(v) for k, v in tc.graph.nodes.items()}
    js, ts = jsplit.split_two_stage(jc.graph), tsplit.split_two_stage(tc.graph)
    assert js.boundary == ts.boundary
    assert js.boundary_specs == ts.boundary_specs
    assert list(js.stage2.nodes) == list(ts.stage2.nodes)


@pytest.mark.parametrize("model", ["quickstart", "paper", "din"])
def test_convert_params_matches_reference(model):
    jg, tg = _graphs(model)
    jp = init_graph_params(jg, jax.random.PRNGKey(0))
    want = _np_tree(jmari.convert_params(
        jmari.mari_rewrite(jg, reparam_attention=True), jp))
    got = tmari.convert_params(tmari.mari_rewrite(tg, reparam_attention=True),
                               params_from_numpy(_np_tree(jp), "cpu"))
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat_w) == len(jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.numpy(), got)))
    for path, leaf in flat_w:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), leaf)


@pytest.mark.parametrize("mode", ["vani", "uoi", "mari"])
@pytest.mark.parametrize("model", ["quickstart", "paper", "din"])
def test_executor_matches_reference(model, mode):
    jg, tg = _graphs(model)
    jp = init_graph_params(jg, jax.random.PRNGKey(1))
    tp = params_from_numpy(_np_tree(jp), "cpu")
    user, cand = _feeds(jg, 29, np.random.default_rng(2))
    feeds = {**user, **cand}
    if mode == "mari":
        jg, jp, _ = jmari.apply_mari(jg, jp, reparam_attention=True)
        tg, tp, _ = tmari.apply_mari(tg, tp, reparam_attention=True)
    emode = "vani" if mode == "vani" else "uoi"
    want = JExecutor(jg, emode).run(jp, {k: jnp.asarray(v)
                                         for k, v in feeds.items()})
    got = TExecutor(tg, emode, device="cpu").run(tp, feeds)
    for o in jg.outputs:
        np.testing.assert_allclose(got[o].numpy(), np.asarray(want[o]), **TOL)


@pytest.mark.parametrize("model", ["paper", "din"])
def test_executor_kernel_path_matches_plain(model):
    """use_pallas routes mari_dense through the kernel wrapper (its plain
    version on the CPU): same scores as the plain executor."""
    _, tg = _graphs(model)
    jg, _ = _graphs(model)
    jp = init_graph_params(jg, jax.random.PRNGKey(3))
    tg, tp, _ = tmari.apply_mari(tg, params_from_numpy(_np_tree(jp), "cpu"),
                                 reparam_attention=True)
    user, cand = _feeds(tg, 17, np.random.default_rng(4))
    a = TExecutor(tg, "uoi", use_pallas=True, device="cpu").run(
        tp, {**user, **cand})
    b = TExecutor(tg, "uoi", device="cpu").run(tp, {**user, **cand})
    for o in tg.outputs:
        np.testing.assert_allclose(a[o].numpy(), b[o].numpy(), **TOL)


def _serve_pair(model, preset):
    jg, tg = _graphs(model)
    jp = init_graph_params(jg, jax.random.PRNGKey(5))
    fields = dict(batch__max_batch=64, batch__min_bucket=8)
    jplan = JPlan.preset(preset).evolve(batch__hedging=False, **fields)
    tplan = TPlan.preset(preset).evolve(**fields)
    return (JEngine(jg, jp, jplan),
            TEngine(tg, params_from_numpy(_np_tree(jp), "cpu"), tplan,
                    device="cpu"), jg)


@pytest.mark.parametrize("preset", ["paper", "uoi", "vanilla", "tpu"])
@pytest.mark.parametrize("model", ["paper", "din"])
def test_engine_scores_match_reference(model, preset):
    jeng, teng, graph = _serve_pair(model, preset)
    rng = np.random.default_rng(6)
    # pools straddle max_batch=64; user 2 repeats (a cache hit)
    pools = ((0, 11), (1, 70), (2, 5), (2, 9))
    feeds = [_feeds(graph, n, rng) for _, n in pools]
    jreqs = [JRequest(u, uf, cf) for (u, _), (uf, cf) in zip(pools, feeds)]
    treqs = [TRequest(u, uf, cf) for (u, _), (uf, cf) in zip(pools, feeds)]
    want = [jeng.score(r).scores for r in jreqs]
    per = [teng.score(r) for r in treqs]
    co = teng.score_coalesced(treqs)
    for w, p, c in zip(want, per, co):
        assert p.scores.shape == w.shape == c.scores.shape
        np.testing.assert_allclose(p.scores, w, **TOL)
        np.testing.assert_allclose(c.scores, w, **TOL)
    assert [r.user_cache_hit for r in per] == \
        [False, False, False, teng.cache_user_reps]
    assert teng.stage1_calls == jeng.stage1_calls
    assert teng.coalesced_calls >= 1
    if preset == "tpu":
        assert teng.lazy_gather_inputs == jeng.lazy_gather_inputs
        assert teng.lazy_gather_inputs   # the gather-at-load path is live


def test_engine_two_phase_matches_reference():
    """begin_coalesced / poll / collect: two overlapped groups, collected
    out of order, score as the reference's per-request score()."""
    jeng, teng, graph = _serve_pair("din", "tpu")
    rng = np.random.default_rng(8)
    groups = [[(0, 13), (1, 40)], [(2, 66), (0, 3)]]
    handles, wants = [], []
    for g in groups:
        feeds = [_feeds(graph, n, rng) for _, n in g]
        wants.append([jeng.score(JRequest(u, uf, cf)).scores
                      for (u, _), (uf, cf) in zip(g, feeds)])
        handles.append(teng.begin_coalesced(
            [TRequest(u, uf, cf) for (u, _), (uf, cf) in zip(g, feeds)]))
    assert all(teng.poll(h) for h in handles)     # CPU work is synchronous
    for h, want in reversed(list(zip(handles, wants))):
        for r, w in zip(teng.collect(h), want):
            np.testing.assert_allclose(r.scores, w, **TOL)
    with pytest.raises(RuntimeError, match="not in flight"):
        teng.collect(handles[0])


def test_functional_eq7_forms_match_reference():
    rng = np.random.default_rng(9)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    xu, xi, xc = f(1, 7), f(13, 5), f(13, 4)
    wu, wi, wc, b = f(7, 6), f(5, 6), f(4, 6), f(6)
    t = lambda *a: [torch.from_numpy(x) for x in a]
    x_tiled = np.concatenate([np.repeat(xu, 13, 0), xi, xc], -1)
    w_all = np.concatenate([wu, wi, wc], 0)
    want = np.asarray(jmari.matmul_vanilla(x_tiled, w_all, b))
    got = {
        "vanilla": tmari.matmul_vanilla(*t(x_tiled, w_all, b)),
        "mari": tmari.matmul_mari(*t(xu, np.concatenate([xi, xc], -1), wu,
                                     np.concatenate([wi, wc], 0), b)),
        "mari3": tmari.matmul_mari3(*t(xu, xi, xc, wu, wi, wc, b)),
        "fragmented": tmari.matmul_mari_fragmented(
            list(zip(t(xu, xi, xc), t(wu, wi, wc))), torch.from_numpy(b)),
    }
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want, err_msg=name, **TOL)


DIN_WIDE = dict(embed_dim=18, seq_len=100, attn_mlp=(80, 40), mlp=(200, 80),
                item_vocab=512)        # configs/din.py widths, small vocab
# a unit past the CUDA kernel's register tiles (its wide route on the card)
DIN_WIDER = dict(embed_dim=72, attn_mlp=(136, 72), seq_len=12, item_vocab=128)


@pytest.mark.parametrize("mode", ["uoi", "mari"])
@pytest.mark.parametrize("widths", ["smoke", "full", "wider"])
def test_din_single_call_kernel_path_matches_reference(widths, mode,
                                                       monkeypatch):
    """Single-call UOI and MaRI of DIN with use_pallas (the din_attention
    wrapper; its plain version on the CPU) against the reference's
    executor. The whole attention unit goes to the wrapper once, with the
    batch-1 keys as one (L, D) block."""
    import repro_torch.graph.executor as texec
    kw = dict(smoke=DIN_SMOKE, full=DIN_WIDE, wider=DIN_WIDER)[widths]
    jg, tg = j_din(**kw)[0], t_din(**kw)[0]
    jp = init_graph_params(jg, jax.random.PRNGKey(11))
    tp = params_from_numpy(_np_tree(jp), "cpu")
    user, cand = _feeds(jg, 37, np.random.default_rng(12))
    feeds = {**user, **cand}
    if mode == "mari":
        jg, jp, _ = jmari.apply_mari(jg, jp)
        tg, tp, conv = tmari.apply_mari(tg, tp)
        assert [r.dense for r in conv.rewrites] == ["mlp_0"]
        assert not conv.attn_rewrites   # the unit stays whole
    calls = []
    real = texec.din_kernel.din_attention

    def spy(q, keys, mask, *w):
        calls.append((tuple(q.shape), tuple(keys.shape), tuple(mask.shape)))
        return real(q, keys, mask, *w)

    monkeypatch.setattr(texec.din_kernel, "din_attention", spy)
    want = JExecutor(jg, "uoi").run(jp, {k: jnp.asarray(v)
                                         for k, v in feeds.items()})
    got = TExecutor(tg, "uoi", use_pallas=True, device="cpu").run(tp, feeds)
    L, D = kw["seq_len"], kw["embed_dim"]
    assert calls == [((37, D), (L, D), (L,))]
    for o in jg.outputs:
        np.testing.assert_allclose(got[o].numpy(), np.asarray(want[o]), **TOL)
    # VanI tiles the keys to B: the unit stays on the plain code
    calls.clear()
    TExecutor(tg, "vani", use_pallas=True, device="cpu").run(tp, feeds)
    assert calls == []
