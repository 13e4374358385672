"""The port's ``embedding_bag`` path on the CPU, held against the JAX
reference: the kernel module's plain versions against the reference's
Pallas kernel (interpret mode) and its jnp oracle on
``TestEmbeddingBag``'s sweep, ``nn/embedding.py`` against
``repro.nn.embedding``, the executor's pooled ``embedding`` op against the
reference ``Executor``, and the multi-hot DLRM (``test_torch_multihot``)
served by both engines. Same params and numpy-seeded inputs through both
packages; tolerance 1e-5 for the lookups (as tests/test_kernels.py) and
fp32 rtol = atol = 2e-4 for scores.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.nn.embedding as jemb
from repro.graph.executor import Executor as JExecutor, init_graph_params
from repro.graph.ir import GraphBuilder as JBuilder
from repro.kernels.embedding_bag import embedding_bag as j_bag_pallas
from repro.kernels.embedding_bag.ref import embedding_bag_ref
from repro.models.recsys import pad_vocab as j_pad_vocab
from repro.serve import ServePlan as JPlan, ServeRequest as JRequest
from repro.serve import ServingEngine as JEngine
import repro_torch.nn.embedding as temb
from repro_torch.common import params_from_numpy
from repro_torch.graph.executor import Executor as TExecutor
from repro_torch.graph.ir import GraphBuilder as TBuilder
from repro_torch.kernels import embedding_bag as teb
from repro_torch.serve import ServePlan as TPlan, ServeRequest as TRequest
from repro_torch.serve import ServingEngine as TEngine
from test_torch_multihot import smoke_multihot_dlrm

LOOKUP_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=2e-4, atol=2e-4)


def _bag_inputs(V, D, S, nnz, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((V, D)).astype(np.float32),
            rng.integers(0, V, nnz).astype(np.int32),
            rng.integers(0, S, nnz).astype(np.int32),
            rng.random(nnz).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the kernel module's plain versions ------------------------------------

@pytest.mark.parametrize("V,D,S,nnz", [(16, 8, 4, 20), (100, 32, 17, 123),
                                       (1000, 128, 64, 512)])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_embedding_bag_matches_reference_sweep(V, D, S, nnz, combiner):
    """TestEmbeddingBag's sweep: the port's wrapper (its plain version on
    the CPU) against the reference's Pallas kernel in interpret mode and
    its jnp oracle."""
    table, ids, segs, _ = _bag_inputs(V, D, S, nnz, seed=V + nnz)
    got = teb.embedding_bag(_t(table), _t(ids), _t(segs), S, combiner)
    pallas = j_bag_pallas(jnp.asarray(table), jnp.asarray(ids),
                          jnp.asarray(segs), num_segments=S,
                          combiner=combiner)
    ref = embedding_bag_ref(jnp.asarray(table), jnp.asarray(ids),
                            jnp.asarray(segs), S, combiner)
    for want in (pallas, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOOKUP_TOL)


def test_embedding_bag_empty_segments_zero():
    table = torch.ones((8, 4))
    out = teb.embedding_bag(table, torch.tensor([0, 1], dtype=torch.int32),
                            torch.tensor([2, 2], dtype=torch.int32), 4)
    want = j_bag_pallas(jnp.ones((8, 4)), jnp.array([0, 1], jnp.int32),
                        jnp.array([2, 2], jnp.int32), num_segments=4)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert out[[0, 1, 3]].abs().sum() == 0 and torch.equal(
        out[2], 2 * torch.ones(4))


def test_embedding_bag_unsorted_input():
    rng = np.random.default_rng(9)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    ids = rng.integers(0, 50, 64).astype(np.int32)
    segs = rng.permutation(np.repeat(np.arange(8), 8)).astype(np.int32)
    got = teb.embedding_bag(_t(table), _t(ids), _t(segs), 8)
    want = j_bag_pallas(jnp.asarray(table), jnp.asarray(ids),
                        jnp.asarray(segs), num_segments=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOOKUP_TOL)


def test_embedding_bag_index_contract():
    """Segment ids outside [0, S) are dropped, as jax.ops.segment_sum
    drops them; ids outside [0, V) clamp to the table's edge rows (the
    kernel's choice: it never reads outside the table); int64 ids work."""
    table, ids, segs, w = _bag_inputs(40, 6, 5, 90, seed=3)
    segs = segs.copy()
    segs[::7] = -1
    segs[3::11] = 9
    for combiner in ("sum", "mean"):
        got = teb.embedding_bag(_t(table), _t(ids).long(), _t(segs), 5,
                                combiner)
        want = embedding_bag_ref(jnp.asarray(table), jnp.asarray(ids),
                                 jnp.asarray(segs), 5, combiner)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOOKUP_TOL)
    out = teb.embedding_bag(_t(table), torch.tensor([-3, 99]),
                            torch.tensor([0, 1]), 2)
    np.testing.assert_array_equal(out.numpy(), table[[0, 39]])
    fixed = teb.embedding_bag_fixed(_t(table), torch.tensor([[-3, 99]]))
    np.testing.assert_allclose(fixed.numpy(), table[[0, 39]].sum(0,
                                                                 keepdims=True),
                               **LOOKUP_TOL)
    with pytest.raises(ValueError, match="unknown combiner"):
        teb.embedding_bag(_t(table), _t(ids), _t(segs), 5, "max")


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_fixed_hotness_matches_csr_and_reference(combiner):
    """The fixed-hotness entry equals the CSR entry with segments b and
    the reference's ``EmbeddingBag.apply_dense``, weighted and not."""
    rng = np.random.default_rng(5)
    table = rng.standard_normal((300, 24)).astype(np.float32)
    ids = rng.integers(0, 300, (37, 9)).astype(np.int32)
    w = rng.random((37, 9)).astype(np.float32)
    segs = np.repeat(np.arange(37), 9).astype(np.int32)
    for weights in (None, w):
        tw = _t(weights) if weights is not None else None
        fixed = teb.embedding_bag_fixed(_t(table), _t(ids), combiner, tw)
        csr = teb.embedding_bag(_t(table), _t(ids.reshape(-1)), _t(segs),
                                37, combiner,
                                tw.reshape(-1) if tw is not None else None)
        np.testing.assert_allclose(fixed.numpy(), csr.numpy(), **LOOKUP_TOL)
        want = jemb.embedding_bag_lookup(
            jnp.asarray(table), jnp.asarray(ids.reshape(-1)),
            jnp.asarray(segs), 37, combiner=combiner,
            weights=(jnp.asarray(weights.reshape(-1))
                     if weights is not None else None))
        np.testing.assert_allclose(fixed.numpy(), np.asarray(want),
                                   **LOOKUP_TOL)


def test_plain_versions_count_no_launch():
    teb.reset_launches()
    table, ids, segs, _ = _bag_inputs(20, 4, 3, 10, seed=1)
    teb.embedding_bag(_t(table), _t(ids), _t(segs), 3)
    teb.embedding_bag_fixed(_t(table), _t(ids).reshape(2, 5))
    assert teb.LAUNCHES == {"csr": 0, "fixed": 0}


# -- nn/embedding.py --------------------------------------------------------

@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_nn_embedding_matches_reference(combiner):
    """Embedding / EmbeddingBag.apply (with and without weights) /
    apply_dense / embedding_bag_lookup against repro.nn.embedding on the
    same table."""
    table, ids, segs, w = _bag_inputs(120, 16, 11, 200, seed=2)
    jt, tt = {"table": jnp.asarray(table)}, {"table": _t(table)}
    dense_ids = ids[:198].reshape(22, 9)
    e_j, e_t = jemb.Embedding(120, 16), temb.Embedding(120, 16)
    np.testing.assert_allclose(e_t.apply(tt, _t(dense_ids)).numpy(),
                               np.asarray(e_j.apply(jt, dense_ids)),
                               **LOOKUP_TOL)
    b_j = jemb.EmbeddingBag(120, 16, combiner)
    b_t = temb.EmbeddingBag(120, 16, combiner)
    for weights in (None, w):
        got = b_t.apply(tt, _t(ids), _t(segs), 11,
                        _t(weights) if weights is not None else None)
        want = b_j.apply(jt, jnp.asarray(ids), jnp.asarray(segs), 11,
                         jnp.asarray(weights) if weights is not None
                         else None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOOKUP_TOL)
        got = temb.embedding_bag_lookup(
            _t(table), _t(ids), _t(segs), 11, combiner=combiner,
            weights=_t(weights) if weights is not None else None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOOKUP_TOL)
    np.testing.assert_allclose(
        b_t.apply_dense(tt, _t(dense_ids)).numpy(),
        np.asarray(b_j.apply_dense(jt, jnp.asarray(dense_ids))),
        **LOOKUP_TOL)


def test_nn_embedding_init_shapes_and_scale():
    g = torch.Generator().manual_seed(0)
    p = temb.EmbeddingBag(10_000, 32).init(g)["table"]
    assert p.shape == (10_000, 32) and p.dtype == torch.float32
    assert abs(float(p.std()) - 0.01) < 1e-3           # 1 / sqrt(vocab)
    q = temb.Embedding(500, 8).init(g)["table"]
    assert q.shape == (500, 8) and abs(float(q.std()) - 0.02) < 3e-3


# -- the executor's pooled embedding op -------------------------------------

def _pooled_graph(builder_cls, pool):
    b = builder_cls()
    ids = b.input("ids", (6,), "item", dtype="int32")
    uids = b.input("uids", (4,), "user", dtype="int32")
    e = b.embedding("e", ids, vocab=50, dim=12, pool=pool)
    u = b.embedding("u", uids, vocab=30, dim=12, pool=pool)
    h = b.dense("d", b.concat("c", [e, u]), 5, activation="relu")
    b.output(h)
    return b.graph


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("mode", ["vani", "uoi"])
@pytest.mark.parametrize("pool", ["sum", "mean"])
def test_executor_pooled_embedding_matches_reference(pool, mode, use_pallas):
    jg, tg = _pooled_graph(JBuilder, pool), _pooled_graph(TBuilder, pool)
    jp = init_graph_params(jg, jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(2)
    feeds = {"ids": rng.integers(0, 50, (13, 6)).astype(np.int32),
             "uids": rng.integers(0, 30, (1, 4)).astype(np.int32)}
    want = JExecutor(jg, mode).run(jp, {k: jnp.asarray(v)
                                        for k, v in feeds.items()})
    got = TExecutor(tg, mode, use_pallas=use_pallas, device="cpu").run(
        tp, feeds)
    for o in jg.outputs:
        np.testing.assert_allclose(got[o].numpy(), np.asarray(want[o]),
                                   **TOL)


# -- the multi-hot DLRM served by both engines ------------------------------

@pytest.fixture(scope="module")
def multihot():
    jg = smoke_multihot_dlrm(JBuilder, pad=j_pad_vocab)
    tg = smoke_multihot_dlrm(TBuilder)
    jp = init_graph_params(jg, jax.random.PRNGKey(0))
    return jg, tg, jp, jax.tree_util.tree_map(np.asarray, jp)


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


@pytest.mark.parametrize("preset", ["vanilla", "uoi", "paper", "tpu"])
def test_multihot_dlrm_engines_match_reference(multihot, preset):
    """vani / uoi / mari and ``tpu``: the port's per-request and coalesced
    scores within 2e-4 of the reference's per-request ``score()``; under
    ``tpu`` the pooled lookups go through the kernel wrapper."""
    jg, tg, jp, np_params = multihot
    fields = dict(batch__max_batch=64, batch__min_bucket=8)
    jeng = JEngine(jg, jp, JPlan.preset(preset).evolve(batch__hedging=False,
                                                       **fields))
    teng = TEngine(tg, params_from_numpy(np_params, "cpu"),
                   TPlan.preset(preset).evolve(**fields), device="cpu")
    rng = np.random.default_rng(6)
    pools = ((0, 11), (1, 70), (2, 5), (2, 9))
    feeds = [_feeds(tg, n, rng) for _, n in pools]
    want = [jeng.score(JRequest(u, uf, cf)).scores
            for (u, _), (uf, cf) in zip(pools, feeds)]
    treqs = [TRequest(u, uf, cf) for (u, _), (uf, cf) in zip(pools, feeds)]
    per = [teng.score(r) for r in treqs]
    co = teng.score_coalesced(treqs)
    for w, p, c in zip(want, per, co):
        assert p.scores.shape == w.shape == c.scores.shape
        np.testing.assert_allclose(p.scores, w, **TOL)
        np.testing.assert_allclose(c.scores, w, **TOL)
    if preset != "vanilla":
        assert [r.user_cache_hit for r in per] == [False, False, False,
                                                   True]
