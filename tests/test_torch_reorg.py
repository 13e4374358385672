"""The port's §2.4 reorganization (``repro_torch.core.reorg``), weight
partition (``core.partition``), FLOPs model (``core.mari`` Eq. 8 / 9) and
fragmented layout (``data.features.fragment_layout``) held against the JAX
reference on the CPU: the same graphs, params moved across with
``np.asarray`` -> ``params_from_numpy`` and numpy-seeded feeds through both
packages. Plans must be equal field by field, integers exactly, scores
within fp32 rtol = atol = 2e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (WeightPartition as JPartition,
                        convert_params_reorg as j_convert_reorg,
                        reorganize as j_reorganize)
import repro.core.mari as jmari
from repro.data.features import fragment_layout as j_fragment_layout
from repro.graph.executor import Executor as JExecutor, init_graph_params
from repro.graph.ir import GraphBuilder as JBuilder
from repro.serve import ServePlan as JPlan, ServeRequest as JRequest
from repro.serve import ServingEngine as JEngine
import repro_torch.core.mari as tmari
from repro_torch.common import params_from_numpy
from repro_torch.core import (WeightPartition as TPartition,
                              convert_params_reorg as t_convert_reorg,
                              mari_flops, reorganize as t_reorganize,
                              vanilla_flops)
from repro_torch.data.features import (fragment_layout as t_fragment_layout,
                                       interleaved_spans)
from repro_torch.graph.executor import Executor as TExecutor
from repro_torch.graph.ir import GraphBuilder as TBuilder
from repro_torch.kernels import mari_matmul as mm
from repro_torch.serve import ServePlan as TPlan, ServeRequest as TRequest
from repro_torch.serve import ServingEngine as TEngine

hypothesis = pytest.importorskip(
    "hypothesis", reason="hypothesis not installed in this environment")
from hypothesis import given, settings, strategies as st  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
# an interleaved layout: user / item / cross chunks in industrial order
INTERLEAVED = [("a", 5, "user"), ("b", 3, "item"), ("c", 4, "user"),
               ("d", 2, "cross"), ("e", 6, "item")]
USER = [n for n, _, d in INTERLEAVED if d == "user"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params(jg, seed):
    """The reference's params for ``jg`` and the same values as tensors."""
    jp = init_graph_params(jg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(_np_tree(jp), "cpu")


def _seg_feeds(segs, batch, rng):
    """numpy feeds for (name, width, domain) inputs: user at batch 1."""
    return {n: rng.standard_normal((1 if d == "user" else batch, w))
            .astype(np.float32) for n, w, d in segs}


def _assert_plans_equal(tplans, jplans):
    assert len(tplans) == len(jplans)
    for t, j in zip(tplans, jplans):
        for f in ("concat", "old_order", "new_order", "perm",
                  "remapped_denses", "restored_consumers"):
            assert getattr(t, f) == getattr(j, f), f
        assert isinstance(t.row_perm, np.ndarray)
        assert t.row_perm.dtype == np.int64
        np.testing.assert_array_equal(t.row_perm, j.row_perm)


def _nodes(g):
    return [(n.name, n.op, n.inputs, dict(n.attrs)) for n in g.nodes.values()]


def _interleaved(builder_cls, segs=INTERLEAVED, side=False):
    b = builder_cls()
    names = [b.input(n, (w,), d) for n, w, d in segs]
    c = b.concat("cc", names)
    f = b.dense("f", c, 8, activation="relu")
    outs = [b.dense("out", f, 1)]
    if side:             # a non-matmul consumer: reorg gives it a restore
        outs.append(b.dense("side_out", b.act("side", c, "relu"), 1))
    b.output(*outs)
    return b.graph


# -- TestReorg (tests/test_mari_core.py) through the port ----------------------

def test_interleaved_roundtrip():
    jg, tg = _interleaved(JBuilder), _interleaved(TBuilder)
    jp, tp = _params(jg, 0)
    feeds = _seg_feeds(INTERLEAVED, 6, np.random.default_rng(1))
    ref = JExecutor(jg, "vani").run(jp, feeds)["out"]
    jg2, jplans = j_reorganize(jg)
    tg2, tplans = t_reorganize(tg)
    _assert_plans_equal(tplans, jplans)
    assert tplans[0].new_order == ("a", "c", "b", "e", "d")
    assert _nodes(tg2) == _nodes(jg2)
    tp2 = t_convert_reorg(tplans, tp)
    out = TExecutor(tg2, "uoi", device="cpu").run(tp2, feeds)["out"]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_neat_layout_noop():
    def neat(builder_cls):
        b = builder_cls()
        u = b.input("u", (12,), "user")
        i = b.input("i", (6,), "item")
        b.output(b.dense("f1", b.concat("c", [u, i]), 4))
        return b.graph
    _, jplans = j_reorganize(neat(JBuilder))
    g2, tplans = t_reorganize(neat(TBuilder))
    assert tplans == jplans == []
    assert [n.op for n in g2.nodes.values()] == ["input", "input", "concat",
                                                 "dense"]


def test_restore_node_for_other_consumer():
    def build(builder_cls):
        b = builder_cls()
        i = b.input("i", (3,), "item")
        u = b.input("u", (2,), "user")
        c = b.concat("cc", [i, u])          # item first -> reorg permutes
        f = b.dense("f", c, 4)
        a = b.act("other", c, "relu")       # non-matmul consumer
        b.output(f, a)
        return b.graph
    jg, tg = build(JBuilder), build(TBuilder)
    jp, tp = _params(jg, 0)
    feeds = {"i": np.arange(12, dtype=np.float32).reshape(4, 3),
             "u": np.ones((1, 2), np.float32)}
    ref = JExecutor(jg, "vani").run(jp, feeds)
    jg2, jplans = j_reorganize(jg)
    tg2, tplans = t_reorganize(tg)
    _assert_plans_equal(tplans, jplans)
    assert tplans[0].restored_consumers == ("other",)
    assert _nodes(tg2) == _nodes(jg2)
    tp2 = t_convert_reorg(tplans, tp)
    out = TExecutor(tg2, "uoi", device="cpu").run(tp2, feeds)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **TOL)


def test_convert_params_reorg_shares_untouched_leaves():
    tg = _interleaved(TBuilder)
    _, tp = _params(_interleaved(JBuilder), 3)
    _, plans = t_reorganize(tg)
    tp2 = t_convert_reorg(plans, tp)
    assert tp2["out"] is tp["out"]                  # not remapped: shared
    assert tp2["f"]["b"] is tp["f"]["b"]
    w, w2 = tp["f"]["w"], tp2["f"]["w"]
    assert w2.is_contiguous() and w2.device == w.device
    assert torch.equal(w2, w[torch.as_tensor(plans[0].row_perm)])


# -- the losslessness property (tests/test_property.py:76) --------------------

segments = st.lists(
    st.tuples(st.sampled_from(["user", "item", "cross"]),
              st.integers(min_value=1, max_value=9)),
    min_size=2, max_size=6,
).filter(lambda segs: any(d == "user" for d, _ in segs)
         and any(d != "user" for d, _ in segs))


@given(segs=segments, seed=st.integers(0, 2**30), batch=st.integers(1, 17))
@settings(max_examples=25, deadline=None)
def test_reorg_is_pure_reparameterization(segs, seed, batch):
    named = [(f"s{i}", w, d) for i, (d, w) in enumerate(segs)]

    def build(builder_cls):
        b = builder_cls()
        h = b.concat("c", [b.input(n, (w,), d) for n, w, d in named])
        h = b.dense("fc0", h, 8, activation="relu")
        b.output(b.dense("out", h, 1))
        return b.graph
    jg, tg = build(JBuilder), build(TBuilder)
    jp, tp = _params(jg, seed)
    feeds = _seg_feeds(named, batch, np.random.default_rng(seed + 1))
    ref = JExecutor(jg, "vani").run(jp, feeds)["out"]
    jg2, jplans = j_reorganize(jg)
    tg2, tplans = t_reorganize(tg)
    _assert_plans_equal(tplans, jplans)
    jout = JExecutor(jg2, "uoi").run(j_convert_reorg(jplans, jp), feeds)
    out = TExecutor(tg2, "uoi", device="cpu").run(
        t_convert_reorg(tplans, tp), feeds)["out"]
    np.testing.assert_allclose(out.numpy(), np.asarray(jout["out"]), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    if tplans:
        plan = tplans[0]
        assert sorted(plan.perm) == list(range(len(segs)))
        assert sorted(plan.row_perm.tolist()) == list(
            range(sum(w for _, w in segs)))


# -- MaRI on an interleaved layout (fragmented / grouped by domain) -----------

@pytest.mark.parametrize("kw", [dict(fragment=True),
                                dict(group_by_domain=True)],
                         ids=["fragment", "group_by_domain"])
def test_mari_rewrite_on_an_interleaved_layout(kw):
    jg, tg = _interleaved(JBuilder), _interleaved(TBuilder)
    jp, tp = _params(jg, 4)
    jconv, tconv = jmari.mari_rewrite(jg, **kw), tmari.mari_rewrite(tg, **kw)
    assert _nodes(tconv.graph) == _nodes(jconv.graph)
    for f in ("dense", "concat", "seg_names", "seg_widths", "seg_groups",
              "groups", "fragment"):
        assert [getattr(r, f) for r in tconv.rewrites] == \
            [getattr(r, f) for r in jconv.rewrites], f
    feeds = _seg_feeds(INTERLEAVED, 9, np.random.default_rng(5))
    want = JExecutor(jconv.graph, "uoi").run(
        jmari.convert_params(jconv, jp),
        {k: jnp.asarray(v) for k, v in feeds.items()})
    got = TExecutor(tconv.graph, "uoi", device="cpu").run(
        tmari.convert_params(tconv, tp), feeds)
    ref = JExecutor(jg, "vani").run(jp, feeds)["out"]
    np.testing.assert_allclose(got["out"].numpy(), np.asarray(want["out"]),
                               **TOL)
    np.testing.assert_allclose(got["out"].numpy(), np.asarray(ref), **TOL)


def test_fragment_single_call_streams_one_prepared_weight(monkeypatch):
    """The single-call executor over a fragmented rewrite: with the weights
    prepared once (``prepare_mari_params``), the batched segments reach the
    kernel as one stream with its prepared weight, never a raw one."""
    jg, tg = _interleaved(JBuilder), _interleaved(TBuilder)
    jp, tp = _params(jg, 6)
    jmg, jmp, _ = jmari.apply_mari(jg, jp, fragment=True)
    tmg, tmp, _ = tmari.apply_mari(tg, tp, fragment=True)
    tmp = mm.prepare_mari_params(tmg, tmp)
    assert isinstance(tmp["f"]["w_prep"], mm.MariWeight)
    calls = []

    def kernel(x, w, u, user_index=None, activation="identity"):
        assert isinstance(w, mm.MariWeight), "a raw weight reached the kernel"
        calls.append(x.shape)
        return mm.mari_matmul_plain(x, w, u, user_index, activation)
    monkeypatch.setattr(mm.ops, "mari_matmul", kernel)
    feeds = _seg_feeds(INTERLEAVED, 13, np.random.default_rng(7))
    want = JExecutor(jmg, "uoi").run(jmp, {k: jnp.asarray(v)
                                           for k, v in feeds.items()})
    got = TExecutor(tmg, "uoi", use_pallas=True, device="cpu").run(tmp, feeds)
    np.testing.assert_allclose(got["out"].numpy(), np.asarray(want["out"]),
                               **TOL)
    assert calls == [(13, 3 + 2 + 6)]     # the item and cross segments


@pytest.mark.parametrize("kw", [dict(graph__fragment=True),
                                dict(graph__group_by_domain=True), {}],
                         ids=["fragment", "group_by_domain", "neat"])
def test_single_stage_engine_prepared_params_match_unprepared(monkeypatch,
                                                              kw):
    """A single-stage ``tpu`` engine over the interleaved layout (no stage
    1: user features arrive row-wise in each pack, and a fragment node has
    no precomputed user partial). With its weights prepared as the engine
    prepares them on the card, every kernel call takes the one prepared
    stream, the row-wise user products as its init; its scores equal those
    of the same engine with unprepared weights and of the reference
    engine."""
    jg, tg = _interleaved(JBuilder), _interleaved(TBuilder)
    jp, tp = _params(jg, 10)
    fields = dict(graph__two_stage=False, batch__max_batch=64,
                  batch__min_bucket=8, **kw)
    jeng = JEngine(jg, jp, JPlan.preset("tpu").evolve(batch__hedging=False,
                                                      **fields))
    plan = TPlan.preset("tpu").evolve(**fields)
    raw = TEngine(tg, tp, plan, device="cpu")
    prep = TEngine(tg, tp, plan, device="cpu")
    assert not raw.two_stage
    assert raw.conversion.rewrites[0].fragment == ("graph__fragment" in kw)
    assert "w_prep" not in raw.params["f"]
    prep.params = mm.prepare_mari_params(prep.graph, prep.params)
    assert isinstance(prep.params["f"]["w_prep"], mm.MariWeight)
    seen = []

    def kernel(x, w, u, user_index=None, activation="identity"):
        seen.append(isinstance(w, mm.MariWeight))
        return mm.mari_matmul_plain(x, w, u, user_index, activation)
    monkeypatch.setattr(mm.ops, "mari_matmul", kernel)
    rng = np.random.default_rng(11)
    for uid, n in ((0, 5), (1, 40), (2, 64)):
        f = _seg_feeds(INTERLEAVED, n, rng)
        uf = {k: f[k] for k in USER}
        cf = {k: v for k, v in f.items() if k not in USER}
        want = jeng.score(JRequest(uid, uf, cf)).scores
        seen.clear()
        got_raw = raw.score(TRequest(uid, uf, cf)).scores
        assert seen and not any(seen)
        seen.clear()
        got_prep = prep.score(TRequest(uid, uf, cf)).scores
        assert seen and all(seen)
        np.testing.assert_allclose(got_prep, got_raw, **TOL)
        np.testing.assert_allclose(got_prep, want, **TOL)
    for e in (raw, prep, jeng):
        e.close()


# -- a reorganized graph served by the tpu engine ------------------------------

def test_engine_serves_a_reorganized_graph_with_a_restore():
    """A ``tpu`` engine (kernels' plain versions on the CPU) over a
    reorganized graph whose concat also feeds a non-matmul consumer:
    ``gather_last`` lands in stage 2, and per-request and coalesced scores
    match the reference engine on the reference's reorganized graph."""
    jg, tg = _interleaved(JBuilder, side=True), _interleaved(TBuilder,
                                                             side=True)
    jp, tp = _params(jg, 8)
    jg2, jplans = j_reorganize(jg)
    tg2, tplans = t_reorganize(tg)
    _assert_plans_equal(tplans, jplans)
    assert tplans[0].restored_consumers == ("side",)
    fields = dict(batch__max_batch=64, batch__min_bucket=8)
    jeng = JEngine(jg2, j_convert_reorg(jplans, jp), JPlan.preset("tpu")
                   .evolve(batch__hedging=False, **fields))
    teng = TEngine(tg2, t_convert_reorg(tplans, tp),
                   TPlan.preset("tpu").evolve(**fields), device="cpu")
    ops = lambda g: {n.op for n in g.nodes.values()}     # noqa: E731
    assert "gather_last" in ops(teng.split.stage2)
    assert "gather_last" not in ops(teng.split.stage1)
    assert [r.dense for r in teng.conversion.rewrites] == ["f"]
    rng = np.random.default_rng(9)
    pools = ((0, 11), (1, 70), (2, 5), (0, 9))
    reqs = []
    for uid, n in pools:
        f = _seg_feeds(INTERLEAVED, n, rng)
        reqs.append((uid, {k: f[k] for k in USER},
                     {k: v for k, v in f.items() if k not in USER}))
    # one feature set per user, as the rep cache's contract says
    first = {}
    reqs = [(u, first.setdefault(u, uf), cf) for u, uf, cf in reqs]
    want = [jeng.score(JRequest(u, uf, cf)).scores for u, uf, cf in reqs]
    treqs = [TRequest(u, uf, cf) for u, uf, cf in reqs]
    per = [teng.score(r) for r in treqs]
    co = teng.score_coalesced(treqs)
    for w, p, c in zip(want, per, co):
        assert p.scores.shape == w.shape == (w.shape[0], 2)
        np.testing.assert_allclose(p.scores, w, **TOL)
        np.testing.assert_allclose(c.scores, w, **TOL)
    teng.close()
    jeng.close()


# -- the FLOPs and bytes model (Eq. 8 / 9, Table 2) ----------------------------

@pytest.mark.parametrize("du,di,dc,d", [(4000, 1000, 1000, 512),
                                        (4000, 500, 0, 512),
                                        (4000, 1000, 0, 512),
                                        (500, 1000, 0, 512),
                                        (8000, 1000, 0, 512),
                                        (4000, 1000, 0, 2048),
                                        (7, 3, 5, 1)])
def test_weight_partition_equals_reference(du, di, dc, d):
    jpart, tpart = JPartition(du, di, dc, d), TPartition(du, di, dc, d)
    assert (tpart.d_in, tpart.d_rest) == (jpart.d_in, jpart.d_rest)
    assert tpart.row_slices() == jpart.row_slices()
    for B in (1, 100, 500, 1000, 2000, 100_000):
        assert tpart.flops_vanilla(B) == jpart.flops_vanilla(B)
        assert tpart.flops_mari(B) == jpart.flops_mari(B)
        assert tpart.flops_speedup(B) == jpart.flops_speedup(B)
        assert tpart.bytes_vanilla(B) == jpart.bytes_vanilla(B)
        assert tpart.bytes_mari(B) == jpart.bytes_mari(B)
        assert tpart.bytes_mari(B, 2) == jpart.bytes_mari(B, 2)
        assert type(tpart.flops_mari(B)) is int
        for du_, dr_ in ((du, di + dc), (1, 1)):
            assert mari_flops(B, du_, dr_, d) == jmari.mari_flops(B, du_,
                                                                  dr_, d)
        assert vanilla_flops(B, du + di + dc, d) == jmari.vanilla_flops(
            B, du + di + dc, d)
    w = np.arange(jpart.d_in * 2, dtype=np.float32).reshape(jpart.d_in, 2)
    for k, blk in tpart.split(torch.as_tensor(w)).items():
        assert isinstance(blk, torch.Tensor)
        np.testing.assert_array_equal(blk.numpy(), jpart.split(w)[k])


def test_flops_match_table2():
    """tests/test_mari_core.py's Table 2 points through the port."""
    part = TPartition(4000, 1000, 1000, 512)
    assert vanilla_flops(2000, 6000, 512) == part.flops_vanilla(2000)
    assert mari_flops(2000, 4000, 2000, 512) == part.flops_mari(2000)
    assert abs(part.flops_speedup(100) - 2.94) < 0.01
    assert abs(part.flops_speedup(2000) - 3.00) < 0.01
    assert abs(TPartition(4000, 500, 0, 512).flops_speedup(2000) - 8.96) < 0.01
    assert abs(TPartition(4000, 1000, 0, 512).flops_speedup(2000)
               - 4.99) < 0.01
    ratio = 1 - part.flops_mari(100000) / part.flops_vanilla(100000)
    assert abs(ratio - 4000 / 6000) < 1e-3


# -- the fragmented layout -----------------------------------------------------

@pytest.mark.parametrize("seed", [None, 0, 1, 2])
@pytest.mark.parametrize("d_total,chunk", [(5000, 100), (5000, 50),
                                           (1000, 300), (7, 7)])
def test_fragment_layout_equals_reference(seed, d_total, chunk):
    rng = lambda: None if seed is None else np.random.default_rng(seed)  # noqa: E731
    got = t_fragment_layout(d_total, chunk, rng())
    assert got == j_fragment_layout(d_total, chunk, rng())
    assert sum(w for _, w in got) == d_total
    if seed is None:
        assert [d for d, _ in got[:4]] == ["user", "item", "user",
                                           "item"][:len(got)]


@pytest.mark.parametrize("d_user,d_item,chunk", [(4000, 1000, 100),
                                                 (4000, 1000, 50),
                                                 (10, 23, 4), (7, 0, 3)])
def test_interleaved_spans_tile_both_domains(d_user, d_item, chunk):
    """Table 3's interleaved layout: each domain's chunks tile its span in
    order, and a chunk is full-width while the other domain lasts, user
    and item taking turns."""
    spans = interleaved_spans(d_user, d_item, chunk)
    for dom, total in (("user", d_user), ("item", d_item)):
        mine = [(o, w) for d, o, w in spans if d == dom]
        assert [o for o, _ in mine] == list(np.cumsum([0] + [w for _, w
                                                             in mine])[:-1])
        assert sum(w for _, w in mine) == total
        assert all(w == chunk for _, w in mine[:-1])
    n_alt = 2 * min(-(-d_user // chunk), -(-d_item // chunk))
    assert [d for d, _, _ in spans[:n_alt]] == ["user", "item"] * (n_alt // 2)
