"""The arithmetic and plumbing of the 3xTF32 ``mari_matmul`` kernel on the
CPU: tf32 rounding and the hi / lo split, why the split exists (3xTF32
keeps the fp32 tolerance, one TF32 pass does not), ``prepare_mari_weight``'s
layout, ``prepare_mari_params`` against the weight concatenation it
extends, the stride rule for the x stream, and engines / the single-call
executor run with prepared weights through a CPU emulation of the kernel's
arithmetic (which reads the prepared w_hi / w_lo), held against the JAX
reference's per-request ``score()``. Same params and numpy-seeded feeds
through both packages; fp32 rtol = atol = 2e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.graph.executor import Executor as JExecutor, init_graph_params
import repro.core.mari as jmari
from repro.models.ranking import (PaperRankingConfig as JPaperCfg,
                                  build_paper_ranking_model as j_paper)
from repro.serve import ServePlan as JPlan, ServeRequest as JRequest
from repro.serve import ServingEngine as JEngine
import repro_torch.configs as tconfigs
import repro_torch.core.mari as tmari
from repro_torch.common import params_from_numpy, take_clip
from repro_torch.graph.executor import Executor as TExecutor
from repro_torch.kernels import mari_matmul as mm
from repro_torch.models.ranking import (PaperRankingConfig as TPaperCfg,
                                        build_paper_ranking_model as t_paper)
from repro_torch.models.recsys import build_deepfm, build_dlrm
from repro_torch.nn.layers import ACTIVATIONS
from repro_torch.serve import ServePlan as TPlan, ServeRequest as TRequest
from repro_torch.serve import ServingEngine as TEngine
from repro_torch.serve.engine import _precat_mari_weights

TOL = dict(rtol=2e-4, atol=2e-4)
ops = mm.ops


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


def _tf32_oracle(x: np.ndarray) -> np.ndarray:
    """Round fp32 to an 11-bit significand, half away from zero, from
    frexp: an independent statement of cvt.rna.tf32.f32 (finite x)."""
    m, e = np.frexp(np.abs(x.astype(np.float64)))     # m in [0.5, 1)
    q = np.floor(m * 2.0 ** 11 + 0.5)
    return (np.sign(x) * np.ldexp(q, e - 11)).astype(np.float32)


# -- tf32 arithmetic ----------------------------------------------------------

def test_tf32_round_matches_the_rounding_rule():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(4096).astype(np.float32) * 10.0 ** rng.integers(
            -30, 30, 4096),
        # ties: the 13 dropped bits exactly half an ulp, both signs
        (0x3F800000 | np.arange(64, dtype=np.uint32) << 13 | 0x1000
         ).view(np.float32),
        -(0x3F800000 | np.arange(64, dtype=np.uint32) << 13 | 0x1000
          ).view(np.float32),
        np.float32([0.0, -0.0, 1.0, -1.0, 3.0e38]),
    ]).astype(np.float32)
    got = ops.tf32_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _tf32_oracle(x))
    assert not np.any(got.view(np.uint32) & 0x1FFF)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4])
def test_split_tf32_hi_plus_lo_is_x(scale):
    x = torch.randn(3000, generator=torch.Generator().manual_seed(1)) * scale
    hi, lo = ops.split_tf32(x)
    for part in (hi, lo):
        assert not torch.any(part.view(torch.int32) & 0x1FFF)
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max()
    assert rel <= 2.0 ** -22


def test_3xtf32_keeps_fp32_tolerance_one_tf32_pass_does_not():
    """At the paper's expert fc0 (K = 1064, N = 512), B = 2048 candidates:
    the three-product split is within 2e-4 of an fp64 oracle, a single
    TF32 product is not — which is why the kernel splits."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2048, 1064), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((1064, 512), dtype=np.float32)
                         * np.float32(0.05))
    oracle = x.double() @ w.double()

    def worst(y):     # max |d| / (atol + rtol |oracle|)
        return float(((y.double() - oracle).abs()
                      / (TOL["atol"] + TOL["rtol"] * oracle.abs())).max())

    xh, xl = ops.split_tf32(x)
    wh, wl = ops.split_tf32(w)
    assert worst(xl @ wh + xh @ wl + xh @ wh) <= 0.05
    assert worst(ops.tf32_round(x) @ ops.tf32_round(w)) > 1.0


# -- prepared weights ---------------------------------------------------------

@pytest.mark.parametrize("K,N", [(1064, 512), (1064, 4), (256, 128),
                                 (500, 64), (48, 200), (351, 1024),
                                 (190, 400), (1, 1), (33, 9)])
def test_prepare_mari_weight_layout(K, N):
    g = torch.Generator().manual_seed(K * N)
    w = torch.randn(K, N, generator=g)
    mw = mm.prepare_mari_weight(w)
    kp = -(-K // 4) * 4
    assert mw.w is not None and torch.equal(mw.w, w)
    assert mw.shape == w.shape and mw.device == w.device
    assert mw.hi.shape == mw.lo.shape == (N, kp)
    assert mw.hi.is_contiguous() and mw.lo.is_contiguous()
    assert not mw.hi[:, K:].any() and not mw.lo[:, K:].any()   # zero tail
    hi, lo = mw.hi[:, :K].t(), mw.lo[:, :K].t()
    for part in (hi, lo):
        assert not torch.any(part.contiguous().view(torch.int32) & 0x1FFF)
    rel = (hi.double() + lo.double() - w.double()).abs() / w.double().abs()
    assert rel.max() <= 2.0 ** -22
    assert mw.bn == ops.tile_config(1, N)[1] and mw.maps is None  # no card
    assert mm.prepare_mari_weight(mw) is mw


def test_prepare_mari_weight_bf16_and_refusals():
    w = torch.randn(37, 20).bfloat16()
    mw = mm.prepare_mari_weight(w)
    assert mw.lo is None and mw.hi.shape == (20, 40)
    assert torch.equal(mw.hi[:, :37], w.t()) and not mw.hi[:, 37:].any()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mm.prepare_mari_weight(torch.zeros(4, 4, dtype=torch.float16))
    with pytest.raises(TypeError, match="2-D"):
        mm.prepare_mari_weight(torch.zeros(4))


@pytest.mark.parametrize("B,N,tile", [(4096, 512, (128, 128)),
                                      (2048, 512, (64, 128)),
                                      (4096, 4, (64, 8)),
                                      (4096, 1024, (128, 128)),
                                      (4096, 200, (64, 128)),
                                      (4096, 400, (128, 128)),
                                      (64, 64, (64, 64)),
                                      (1, 32, (64, 32)),
                                      (5000, 9, (64, 32))])
def test_tile_config(B, N, tile):
    assert ops.tile_config(B, N) == tile


def test_tile_width_depends_on_n_alone():
    for N in (1, 4, 8, 9, 32, 33, 64, 65, 128, 200, 400, 512, 1024):
        widths = {ops.tile_config(B, N)[1] for B in (1, 64, 2048, 4096)}
        assert len(widths) == 1 and widths.pop() in (8, 32, 64, 128)


# -- prepare_mari_params against the concatenation it extends -----------------

def _batched(graph_fn, plan):
    """The engine's batched graph and its params (CPU), without kernels."""
    graph, params = graph_fn()
    eng = TEngine(graph, params, plan.evolve(kernel__use_pallas=False,
                                             kernel__kernel_gather=False),
                  device="cpu")
    return eng._stage2_ex.graph, eng.params


def _paper_graph():
    g, _ = t_paper(TPaperCfg().scaled(0.05))
    from repro_torch.graph.executor import init_graph_params as tinit
    return g, tinit(g, seed=0, device="cpu")


def _smoke_graph(name):
    def fn():
        g = tconfigs.get_config(name).smoke_build()()[0]
        from repro_torch.graph.executor import init_graph_params as tinit
        return g, tinit(g, seed=0, device="cpu")
    return fn


@pytest.mark.parametrize("graph_fn", [_paper_graph, _smoke_graph("din"),
                                      _smoke_graph("dlrm-mlperf"),
                                      _smoke_graph("deepfm")],
                         ids=["paper", "din", "dlrm", "deepfm"])
@pytest.mark.parametrize("plan", [
    TPlan.preset("tpu"),
    TPlan.preset("tpu").evolve(graph__group_by_domain=True),
    TPlan.preset("tpu").evolve(graph__fragment=True)],
    ids=["tpu", "group_by_domain", "fragment"])
def test_prepare_mari_params_covers_the_precat_nodes(graph_fn, plan):
    graph, params = _batched(graph_fn, plan)
    walked = ops.stream_weight_blocks(graph, params)
    precat = _precat_mari_weights(graph, params)
    prepared = mm.prepare_mari_params(graph, params)
    kernel_nodes = {n for n in walked
                    if not graph.nodes[n].attrs.get("cast_dtype")}
    assert {n for n, p in prepared.items()
            if isinstance(p, dict) and "w_prep" in p} == kernel_nodes
    assert {n for n, p in precat.items()
            if isinstance(p, dict) and "w_cat" in p} == \
        {n for n, ws in walked.items() if len(ws) > 1}
    for name in kernel_nodes:
        mw = prepared[name]["w_prep"]
        want = precat[name].get("w_cat", walked[name][0])
        assert torch.equal(mw.w, want)
        if len(walked[name]) > 1:
            assert torch.equal(prepared[name]["w_cat"], want)
    # nodes the walk leaves out keep their params untouched
    for name, p in params.items():
        if name not in kernel_nodes:
            assert prepared[name] is p


# -- engines and the executor with prepared weights ---------------------------

def _emulated_kernel(calls):
    """mari_matmul as the card computes it, from the prepared operands:
    act(u_init + lo(x) w_hi + hi(x) w_lo + hi(x) w_hi). Records each call's
    weight and x so a test can see what the kernel would have been given."""
    def kernel(x, w, u, user_index=None, activation="identity"):
        calls.append((w, x))
        assert isinstance(w, mm.MariWeight), "a raw weight reached the kernel"
        K = x.shape[1]
        xh, xl = ops.split_tf32(x)
        hi, lo = w.hi[:, :K].t(), w.lo[:, :K].t()
        acc = xl @ hi + xh @ lo + xh @ hi
        if user_index is not None:
            u = take_clip(u, user_index)
        return ACTIVATIONS[activation](u.float() + acc)
    return kernel


def _pair(name):
    if name == "paper":
        jg = j_paper(JPaperCfg().scaled(0.05))[0]
        tg = t_paper(TPaperCfg().scaled(0.05))[0]
    else:
        jg = jconfigs.get_config(name).smoke_build()()[0]
        tg = tconfigs.get_config(name).smoke_build()()[0]
    return jg, tg


@pytest.mark.parametrize("model", ["paper", "din", "dlrm-mlperf"])
def test_engine_with_prepared_params_matches_reference(model, monkeypatch):
    jg, tg = _pair(model)
    jp = init_graph_params(jg, jax.random.PRNGKey(5))
    fields = dict(batch__max_batch=64, batch__min_bucket=8)
    jeng = JEngine(jg, jp, JPlan.preset("tpu").evolve(batch__hedging=False,
                                                      **fields))
    teng = TEngine(tg, params_from_numpy(_np_tree(jp), "cpu"),
                   TPlan.preset("tpu").evolve(**fields), device="cpu")
    # what the engine does at load on the card
    teng.params = mm.prepare_mari_params(teng._stage2_ex.graph, teng.params)
    calls = []
    monkeypatch.setattr(ops, "mari_matmul", _emulated_kernel(calls))
    rng = np.random.default_rng(6)
    pools = ((0, 11), (1, 70), (2, 5), (2, 9))
    feeds = [_feeds(jg, n, rng) for _, n in pools]
    want = [jeng.score(JRequest(u, uf, cf)).scores
            for (u, _), (uf, cf) in zip(pools, feeds)]
    treqs = [TRequest(u, uf, cf) for (u, _), (uf, cf) in zip(pools, feeds)]
    per = [teng.score(r) for r in treqs]
    co = teng.score_coalesced(treqs)
    for w, p, c in zip(want, per, co):
        np.testing.assert_allclose(p.scores, w, **TOL)
        np.testing.assert_allclose(c.scores, w, **TOL)
    assert calls and all(isinstance(w, mm.MariWeight) for w, _ in calls)


@pytest.mark.parametrize("model", ["paper", "din"])
def test_single_call_executor_with_prepared_params_matches_reference(
        model, monkeypatch):
    """The single-call MaRI executor (Eq. 7 for one user) with the weights
    prepared once before its calls, as the examples and chip_smoke do."""
    jg, tg = _pair(model)
    jp = init_graph_params(jg, jax.random.PRNGKey(7))
    jmg, jmp, _ = jmari.apply_mari(jg, jp)
    tmg, tmp, _ = tmari.apply_mari(tg, params_from_numpy(_np_tree(jp),
                                                         "cpu"))
    tmp = mm.prepare_mari_params(tmg, tmp)
    calls = []
    monkeypatch.setattr(ops, "mari_matmul", _emulated_kernel(calls))
    user, cand = _feeds(jg, 37, np.random.default_rng(8))
    feeds = {**user, **cand}
    want = JExecutor(jmg, "uoi").run(jmp, {k: jnp.asarray(v)
                                           for k, v in feeds.items()})
    ex = TExecutor(tmg, "uoi", use_pallas=True, device="cpu")
    for _ in range(2):                  # the prepared weight is reused
        got = ex.run(tmp, feeds)
        for o in jg.outputs:
            np.testing.assert_allclose(got[o].numpy(), np.asarray(want[o]),
                                       **TOL)
    assert calls and len({id(w) for w, _ in calls}) == len(calls) // 2


@pytest.mark.parametrize("second", ["prepared", "gathered_init"])
def test_fused_groups_refuses_a_prepared_weight_among_several_streams(
        second):
    x, w = torch.randn(5, 3), torch.randn(3, 2)
    pw = mm.prepare_mari_weight(w)
    if second == "prepared":
        parts, kw = [(x, pw), (x, mm.prepare_mari_weight(w))], {}
    else:
        parts = [(x, pw), (x, w)]
        kw = dict(acc0=torch.randn(3, 2),
                  user_index=torch.tensor([0, 1, 2, 1, 0]))
    with pytest.raises(ValueError, match="prepared weight among several"):
        mm.mari_matmul_fused_groups(parts, **kw)


def test_fused_groups_folds_row_wise_parts_beside_a_prepared_weight():
    """A single-stage pack: row-wise user parts beside the prepared stream
    seed a row-wise init; the sum is the plain one."""
    g = torch.Generator().manual_seed(3)
    xu, xs, xi = (torch.randn(5, k, generator=g) for k in (3, 4, 1))
    wu, ws, wi = (torch.randn(k, 2, generator=g) for k in (3, 4, 1))
    b = torch.randn(2, generator=g)
    got = mm.mari_matmul_fused_groups(
        [(xu, wu), (xs, mm.prepare_mari_weight(ws)), (xi[:1], wi)], b,
        activation="relu")
    want = torch.relu(xu @ wu + xs @ ws + xi[:1] @ wi + b)
    torch.testing.assert_close(got, want, rtol=2e-6, atol=2e-6)


# -- the stride rule for the x stream -----------------------------------------

def test_aligned_buffers_and_the_copy_rule():
    assert ops.aligned_ld(351, torch.float32) == 352
    assert ops.aligned_ld(190, torch.float32) == 192
    assert ops.aligned_ld(1064, torch.float32) == 1064
    assert ops.aligned_ld(190, torch.bfloat16) == 192
    assert ops.aligned_ld(100, torch.bfloat16) == 104
    v = ops.empty_stream(7, 351, torch.float32, torch.device("cpu"))
    assert v.shape == (7, 351) and v.stride() == (352, 1) and ops.tma_ready(v)
    x = torch.randn(7, 351)
    assert not ops.tma_ready(x)                       # 1404-byte rows
    y, copied = ops.stream_operand(x)
    assert copied and y.stride() == (352, 1) and torch.equal(y, x)
    z, copied = ops.stream_operand(y)
    assert not copied and z is y
    assert not ops.tma_ready(torch.randn(7, 1).expand(7, 8))   # stride 0
    assert not ops.tma_ready(torch.randn(7, 9)[:, 1:])         # base + 4 B


def _stream_x(graph, params, n, monkeypatch):
    """The x each kernel-path mari_dense hands the kernel, by call."""
    calls = []
    monkeypatch.setattr(ops, "mari_matmul", _emulated_kernel(calls))
    eng = TEngine(graph, params, TPlan.preset("tpu"), device="cpu")
    eng.params = mm.prepare_mari_params(eng._stage2_ex.graph, eng.params)
    user, cand = _feeds(graph, n, np.random.default_rng(9))
    eng.score(TRequest(0, user, cand))
    return [x for _, x in calls]


def test_stride_rule_deepfm_stream_is_written_padded(monkeypatch):
    """DeepFM's deep_mlp_0 stream (19 item fields x 10 = 190 wide) is a
    concatenation: the executor writes it into a 192-wide buffer, so TMA
    reads it with no copy."""
    from repro_torch.graph.executor import init_graph_params as tinit
    graph, _ = build_deepfm(vocab_size=100)
    xs = _stream_x(graph, tinit(graph, seed=0, device="cpu"), 33,
                   monkeypatch)
    assert [x.shape[1] for x in xs] == [190]        # rows: the pow2 bucket
    assert xs[0].stride() == (192, 1) and ops.tma_ready(xs[0])


def test_stride_rule_dlrm_stream_needs_the_copy(monkeypatch):
    """DLRM's top_mlp_0 stream is dot_interaction's (B, 351) output as it
    is: no concatenation to write it padded, so the wrapper copies it
    (counted in STRIDE_COPIES on the card)."""
    from repro_torch.graph.executor import init_graph_params as tinit
    graph, _ = build_dlrm(table_rows=[16] * 26)
    xs = _stream_x(graph, tinit(graph, seed=0, device="cpu"), 21,
                   monkeypatch)
    assert [x.shape[1] for x in xs] == [351]
    assert not ops.tma_ready(xs[0])
    y, copied = ops.stream_operand(xs[0])
    assert copied and ops.tma_ready(y) and torch.equal(y, xs[0])
