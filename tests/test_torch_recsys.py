"""The port's DLRM / DeepFM / FM path on the CPU, held against the JAX
reference: builders and the configs registry node for node, the executor
in vani / uoi / mari, ``ServingEngine.score`` under the ``paper`` and
``tpu`` presets against the reference's per-request ``score()``, the
``dot_interaction`` plain version against the reference's Pallas kernel
(interpret mode) and its jnp oracle, and the synthetic feed pipeline.
Same params and numpy-seeded feeds through both packages; fp32
rtol = atol = 2e-4, never bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.core.mari as jmari
import repro.core.split as jsplit
from repro.data.features import feed_specs as j_feed_specs
from repro.graph.executor import Executor as JExecutor, init_graph_params
from repro.kernels.dot_interaction import dot_interaction as j_dot_pallas
from repro.kernels.dot_interaction.ref import dot_interaction_ref
from repro.models import recsys as jrecsys
from repro.serve import ServePlan as JPlan, ServeRequest as JRequest
from repro.serve import ServingEngine as JEngine
import repro_torch.configs as tconfigs
import repro_torch.core.mari as tmari
import repro_torch.core.split as tsplit
from repro_torch.common import params_from_numpy
from repro_torch.data.features import feed_specs, make_recsys_feeds
from repro_torch.graph.executor import Executor as TExecutor
from repro_torch.kernels import dot_interaction as tdot
from repro_torch.models import recsys as trecsys
from repro_torch.serve import ServePlan as TPlan, ServeRequest as TRequest
from repro_torch.serve import ServingEngine as TEngine

TOL = dict(rtol=2e-4, atol=2e-4)
MODELS = ("dlrm-mlperf", "deepfm", "fm")
REGISTRY = ("din", "deepfm", "fm", "dlrm-mlperf", "paper-ranking")


def _smoke(name):
    """The registry's smoke graph from both packages."""
    return (jconfigs.get_config(name).smoke_build()()[0],
            tconfigs.get_config(name).smoke_build()()[0])


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _node_sig(n):
    return (n.op, tuple(n.inputs), dict(n.attrs))


def _graph_sig(g):
    return ({k: _node_sig(v) for k, v in g.nodes.items()}, list(g.nodes),
            list(g.outputs))


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


# -- builders and the registry ---------------------------------------------

@pytest.mark.parametrize("model", MODELS)
def test_builders_rewrite_and_split_match_reference(model):
    jg, tg = _smoke(model)
    assert _graph_sig(jg) == _graph_sig(tg)
    jc = jmari.mari_rewrite(jg, reparam_attention=True)
    tc = tmari.mari_rewrite(tg, reparam_attention=True)
    assert _graph_sig(jc.graph) == _graph_sig(tc.graph)
    assert [r.dense for r in jc.rewrites] == [r.dense for r in tc.rewrites]
    js, ts = jsplit.split_two_stage(jc.graph), tsplit.split_two_stage(tc.graph)
    assert js.boundary == ts.boundary
    assert js.boundary_specs == ts.boundary_specs
    assert list(js.stage2.nodes) == list(ts.stage2.nodes)


@pytest.mark.parametrize("builder,kw", [
    ("build_dlrm", dict(scale_tables=0.1)),       # the card run's tables
    ("build_dlrm", dict()),                       # published table rows
    ("build_deepfm", dict(vocab_size=1_000_000)),
    ("build_fm", dict(vocab_size=1_000_000)),
])
def test_full_width_builders_match_reference(builder, kw):
    jg, jspec = getattr(jrecsys, builder)(**kw)
    tg, tspec = getattr(trecsys, builder)(**kw)
    assert _graph_sig(jg) == _graph_sig(tg)
    assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)


def test_dlrm_rewrites_top_mlp_0_at_full_width():
    """MaRI's target on DLRM: the interaction (B, 351) feeds the eligible
    first top-MLP layer beside the user-side bottom MLP output."""
    tg, spec = trecsys.build_dlrm(scale_tables=0.1)
    assert spec.expected_eligible == ("top_mlp_0",)
    conv = tmari.mari_rewrite(tg)
    assert [r.dense for r in conv.rewrites] == ["top_mlp_0"]
    assert sum(trecsys.build_dlrm(scale_tables=0.1)[1].vocab_sizes.values()
               ) == sum(trecsys.pad_vocab(max(4, int(r * 0.1)))
                        for r in trecsys.DLRM_TABLE_ROWS)


@pytest.mark.parametrize("name", REGISTRY)
def test_registry_matches_reference(name):
    jmod, tmod = jconfigs.get_config(name), tconfigs.get_config(name)
    assert tmod.FAMILY == jmod.FAMILY and tmod.SHAPES == jmod.SHAPES
    jg, tg = _smoke(name)
    assert _graph_sig(jg) == _graph_sig(tg)
    assert _graph_sig(jmod.BUILD()[0]) == _graph_sig(tmod.BUILD()[0])


@pytest.mark.parametrize("name", ["schnet"])
def test_registry_refuses_unported_archs(name):
    """The last arch the port lacked (SchNet) is in its registry now, as
    in the reference's; a name neither registry holds is refused."""
    jmod, tmod = jconfigs.get_config(name), tconfigs.get_config(name)
    assert tmod.FAMILY == jmod.FAMILY and tmod.SHAPES == jmod.SHAPES
    for reg in (jconfigs, tconfigs):
        with pytest.raises(KeyError, match="unknown arch"):
            reg.get_config("no-such-arch")


# -- executor and engine ---------------------------------------------------

@pytest.mark.parametrize("mode", ["vani", "uoi", "mari"])
@pytest.mark.parametrize("model", MODELS)
def test_executor_matches_reference(model, mode):
    jg, tg = _smoke(model)
    jp = init_graph_params(jg, jax.random.PRNGKey(1))
    tp = params_from_numpy(_np_tree(jp), "cpu")
    user, cand = _feeds(jg, 29, np.random.default_rng(2))
    feeds = {**user, **cand}
    if mode == "mari":
        jg, jp, _ = jmari.apply_mari(jg, jp)
        tg, tp, _ = tmari.apply_mari(tg, tp)
    emode = "vani" if mode == "vani" else "uoi"
    want = JExecutor(jg, emode).run(jp, {k: jnp.asarray(v)
                                         for k, v in feeds.items()})
    for use_pallas in (False, True):
        got = TExecutor(tg, emode, use_pallas=use_pallas,
                        device="cpu").run(tp, feeds)
        for o in jg.outputs:
            np.testing.assert_allclose(got[o].numpy(), np.asarray(want[o]),
                                       **TOL)


@pytest.mark.parametrize("preset", ["paper", "tpu"])
@pytest.mark.parametrize("model", MODELS)
def test_engine_scores_match_reference(model, preset):
    jg, tg = _smoke(model)
    jp = init_graph_params(jg, jax.random.PRNGKey(5))
    fields = dict(batch__max_batch=64, batch__min_bucket=8)
    jeng = JEngine(jg, jp, JPlan.preset(preset).evolve(batch__hedging=False,
                                                       **fields))
    teng = TEngine(tg, params_from_numpy(_np_tree(jp), "cpu"),
                   TPlan.preset(preset).evolve(**fields), device="cpu")
    rng = np.random.default_rng(6)
    # pools straddle max_batch=64; user 2 repeats (a cache hit)
    pools = ((0, 11), (1, 70), (2, 5), (2, 9))
    feeds = [_feeds(jg, n, rng) for _, n in pools]
    want = [jeng.score(JRequest(u, uf, cf)).scores
            for (u, _), (uf, cf) in zip(pools, feeds)]
    treqs = [TRequest(u, uf, cf) for (u, _), (uf, cf) in zip(pools, feeds)]
    per = [teng.score(r) for r in treqs]
    co = teng.score_coalesced(treqs)
    for w, p, c in zip(want, per, co):
        assert p.scores.shape == w.shape == c.scores.shape
        np.testing.assert_allclose(p.scores, w, **TOL)
        np.testing.assert_allclose(c.scores, w, **TOL)
    assert [r.user_cache_hit for r in per] == [False, False, False, True]
    assert teng.stage1_calls == jeng.stage1_calls
    assert teng.lazy_gather_inputs == jeng.lazy_gather_inputs
    rewrites = [r.dense for r in teng.conversion.rewrites]
    assert rewrites == [r.dense for r in jeng.conversion.rewrites]


# -- the dot_interaction kernel's plain version ----------------------------

@pytest.mark.parametrize("keep_self", [False, True])
@pytest.mark.parametrize("B", [1, 7, 130])
@pytest.mark.parametrize("F", [5, 27])
def test_dot_interaction_plain_matches_reference(F, B, keep_self):
    x = np.random.default_rng(F * B).standard_normal(
        (B, F, 16)).astype(np.float32)
    got = tdot.dot_interaction_plain(torch.from_numpy(x), keep_self).numpy()
    assert got.shape == (B, tdot.n_pairs(F, keep_self))
    pallas = j_dot_pallas(jnp.asarray(x), keep_self=keep_self, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(dot_interaction_ref(jnp.asarray(x), keep_self)),
        **TOL)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(
        tdot.dot_interaction(torch.from_numpy(x), keep_self).numpy(), got)


@pytest.mark.parametrize("keep_self", [False, True])
def test_dot_interaction_triangle_order(keep_self):
    """Row-major upper triangle: distinct one-hot rows make each output
    name its own (i, j), so a transposed map cannot pass."""
    F = 5
    x = torch.zeros((1, F, F))
    for i in range(F):
        x[0, i, i] = 1.0
        x[0, i, (i + 1) % F] = 10.0 ** i      # row i overlaps rows i, i+1
    before = dict(tdot.LAUNCHES)
    got = tdot.dot_interaction(x, keep_self)[0]
    assert tdot.LAUNCHES == before        # a CPU tensor launches nothing
    iu, ju = np.triu_indices(F, k=0 if keep_self else 1)
    full = (x[0] @ x[0].T).numpy()
    np.testing.assert_array_equal(got.numpy(), full[iu, ju])


def test_dot_interaction_rejects_bad_rank():
    with pytest.raises(ValueError, match=r"\(B, F, D\)"):
        tdot.dot_interaction(torch.zeros(3, 4))


# -- feeds ------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("model", MODELS)
def test_feed_specs_match_reference(model, train):
    jg, tg = _smoke(model)
    want = j_feed_specs(jg, 33, train=train)
    got = feed_specs(tg, 33, train=train)
    assert list(got) == list(want)
    for k, spec in want.items():
        assert got[k].shape == tuple(spec.shape)
        assert got[k].dtype == np.dtype(spec.dtype)


@pytest.mark.parametrize("tile_user", [False, True])
@pytest.mark.parametrize("model", MODELS)
def test_make_recsys_feeds_shapes_and_vocab(model, tile_user):
    _, tg = _smoke(model)
    feeds = make_recsys_feeds(tg, 40, np.random.default_rng(0),
                              tile_user=tile_user)
    specs = feed_specs(tg, 40, train=tile_user)
    vocab = {c.inputs[0]: c.attrs["vocab"] for c in tg.nodes.values()
             if c.op == "embedding"}
    for k, a in feeds.items():
        assert a.shape == specs[k].shape and a.dtype == specs[k].dtype
        if k in vocab:
            assert 0 <= a.min() and a.max() < vocab[k]
        if tile_user and tg.nodes[k].attrs["domain"] == "user":
            assert (a == a[:1]).all()
    again = make_recsys_feeds(tg, 40, np.random.default_rng(0),
                              tile_user=tile_user)
    assert all(np.array_equal(feeds[k], again[k]) for k in feeds)
