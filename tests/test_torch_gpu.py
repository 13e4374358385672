"""Card-only checks of the port's CUDA kernels and engine (jax-free).

Every test here is marked ``gpu`` and skips without a CUDA device; on the
card run ``python -m pytest -m gpu tests/test_torch_gpu.py``. Kernels are
held against their plain PyTorch versions on the same device at fp32
rtol = atol = 2e-4 (tests/test_kernels.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.mari import apply_mari
from repro_torch.data.features import make_recsys_feeds
from repro_torch.graph.executor import Executor, init_graph_params
from repro_torch.kernels import din_attention as da
from repro_torch.kernels import dot_interaction as di
from repro_torch.kernels import embedding_bag as eb
from repro_torch.kernels import gather_einsum as ge
from repro_torch.kernels import mari_matmul as mm
from repro_torch.models.ranking import (PaperRankingConfig,
                                        build_paper_ranking_model)
from repro_torch.graph.ir import GraphBuilder
from repro_torch.models.recsys import build_din
from repro_torch.nn.embedding import EmbeddingBag, embedding_bag_lookup
from repro_torch.serve import ServePlan, ServeRequest, ServingEngine
from test_torch_multihot import smoke_multihot_dlrm

pytestmark = pytest.mark.gpu
TOL = dict(rtol=2e-4, atol=2e-4)
ACTS = ("identity", "relu", "gelu", "silu", "sigmoid", "tanh")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device=gen.device)


def _gen(dev, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("mode", ["broadcast", "rowwise", "gather"])
@pytest.mark.parametrize("B,K,N", [(37, 50, 40), (1000, 1064, 512),
                                   (1, 7, 1), (130, 16, 64)])
def test_mari_matmul_kernel_matches_plain(cuda, mode, activation, B, K, N):
    g = _gen(cuda, B + K)
    x, w = _randn(g, B, K), _randn(g, K, N)
    U = 5
    u = _randn(g, {"broadcast": 1, "rowwise": B, "gather": U}[mode], N)
    idx = (torch.randint(-2, U + 3, (B,), generator=g, device=cuda,
                         dtype=torch.int32) if mode == "gather" else None)
    launched = mm.ops.init_mode(B, u, idx)     # B == 1: a (1, N) u broadcasts
    before = mm.LAUNCHES[launched]
    got = mm.mari_matmul(x, w, u, idx, activation)
    torch.cuda.synchronize()
    assert mm.LAUNCHES[launched] == before + 1
    torch.testing.assert_close(got, mm.mari_matmul_plain(x, w, u, idx,
                                                         activation), **TOL)


def test_mari_matmul_row_independent_of_batch(cuda):
    """No split-K: a row's result does not depend on B or its position."""
    g = _gen(cuda, 1)
    x, w, u = _randn(g, 300, 700), _randn(g, 700, 96), _randn(g, 300, 96)
    full = mm.mari_matmul(x, w, u, None, "relu")
    part = mm.mari_matmul(x[123:200].contiguous(), w,
                          u[123:200].contiguous(), None, "relu")
    assert torch.equal(full[123:200], part)


def test_mari_matmul_kernel_refuses_bf16(cuda):
    x = torch.zeros(4, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32 only"):
        mm.mari_matmul(x, x.T.contiguous(), torch.zeros(1, 4, device=cuda,
                                                       dtype=torch.bfloat16))


@pytest.mark.parametrize("U", [1, 5])
@pytest.mark.parametrize("spec", ge.KERNEL_SPECS)
def test_gather_einsum_kernel_matches_plain(cuda, spec, U):
    g = _gen(cuda, U)
    B, L, D, H = 301, 100, 18, 80
    x_shape, t_shape = {
        "bd,uldh->blh": ((B, D), (U, L, D, H)),
        "bl,uld->bd": ((B, L), (U, L, D)),
        "blh,uh->bl": ((B, L, H), (U, H)),
    }[spec]
    x, table = _randn(g, *x_shape), _randn(g, *t_shape)
    idx = torch.randint(-3, U + 4, (B,), generator=g, device=cuda,
                        dtype=torch.int32)
    before = ge.LAUNCHES[spec]
    got = ge.gather_einsum(spec, x, table, idx)
    torch.cuda.synchronize()
    assert ge.LAUNCHES[spec] == before + 1
    torch.testing.assert_close(got, ge.gather_einsum_plain(spec, x, table,
                                                           idx), **TOL)


def test_gather_einsum_other_spec_raises_on_cuda(cuda):
    x = torch.zeros(3, 4, device=cuda)
    table = torch.zeros(2, 4, 5, device=cuda)
    idx = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="CUDA kernel covers"):
        ge.gather_einsum("bi,uij->bj", x, table, idx)


@pytest.mark.parametrize("keep_self", [False, True])
@pytest.mark.parametrize("B,F,D", [(4096, 27, 128), (1000, 5, 16),
                                   (1, 27, 16), (130, 7, 33),
                                   (33, 40, 64)])
def test_dot_interaction_kernel_matches_plain(cuda, B, F, D, keep_self):
    x = _randn(_gen(cuda, B + F), B, F, D)
    before = di.LAUNCHES["triu_keep_self" if keep_self else "triu"]
    got = di.dot_interaction(x, keep_self)
    torch.cuda.synchronize()
    assert di.LAUNCHES["triu_keep_self" if keep_self else "triu"] == \
        before + 1
    assert got.shape == (B, di.n_pairs(F, keep_self))
    torch.testing.assert_close(got, di.dot_interaction_plain(x, keep_self),
                               **TOL)


def test_dot_interaction_kernel_triangle_order_and_rows(cuda):
    """One-hot rows name each output's (i, j); a row's result does not
    depend on B; a strided (expanded) input is made contiguous."""
    F = 5
    x = torch.zeros((1, F, F), device=cuda)
    for i in range(F):
        x[0, i, i] = 1.0
        x[0, i, (i + 1) % F] = 10.0 ** i
    for keep_self in (False, True):
        iu, ju = np.triu_indices(F, k=0 if keep_self else 1)
        full = (x[0] @ x[0].T).cpu().numpy()
        got = di.dot_interaction(x, keep_self)[0].cpu().numpy()
        np.testing.assert_allclose(got, full[iu, ju], **TOL)
    y = _randn(_gen(cuda, 2), 300, 27, 128)
    full = di.dot_interaction(y)
    assert torch.equal(full[100:140], di.dot_interaction(y[100:140]))
    e = y[:1].expand(64, 27, 128)
    torch.testing.assert_close(di.dot_interaction(e),
                               di.dot_interaction_plain(e), **TOL)


def test_dot_interaction_kernel_refuses_what_it_cannot_take(cuda):
    with pytest.raises(TypeError, match="float32 only"):
        di.dot_interaction(torch.zeros(4, 3, 8, device=cuda,
                                       dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="shared memory"):
        di.dot_interaction(torch.zeros(2, 64, 1024, device=cuda))


def _requests(graph, pools, seed):
    rng = np.random.default_rng(seed)
    vocab = {n.inputs[0]: n.attrs["vocab"] for n in graph.nodes.values()
             if n.op == "embedding"}
    out = []
    for uid, n in enumerate(pools):
        user, cand = {}, {}
        for node in graph.input_nodes():
            is_user = node.attrs["domain"] == "user"
            shape = (1 if is_user else n,) + tuple(node.attrs["shape"])
            if node.attrs.get("dtype", "float32").startswith("int"):
                a = rng.integers(0, vocab[node.name], shape, dtype=np.int32)
            else:
                a = rng.standard_normal(shape, dtype=np.float32)
            (user if is_user else cand)[node.name] = a
        out.append(ServeRequest(uid, user, cand))
    return out


@pytest.mark.parametrize("model", ["paper", "din"])
def test_engine_on_card_matches_cpu(cuda, model):
    if model == "paper":
        graph, _ = build_paper_ranking_model(PaperRankingConfig().scaled(0.1))
    else:
        graph, _ = build_din(embed_dim=8, seq_len=12, attn_mlp=(16, 8),
                             mlp=(24, 12), item_vocab=128)
    params = init_graph_params(graph, seed=0, device="cpu")
    plan = ServePlan.preset("tpu").evolve(batch__max_batch=64,
                                          batch__min_bucket=8)
    reqs = _requests(graph, (11, 70, 5), seed=1)
    want = [r.scores for r in
            ServingEngine(graph, params, plan, device="cpu")
            .score_coalesced(reqs)]
    mm.reset_launches()
    ge.reset_launches()
    eng = ServingEngine(graph, params, plan, device=cuda)
    per = [eng.score(r).scores for r in reqs]
    co = [r.scores for r in eng.score_coalesced(reqs)]
    for w, p, c in zip(want, per, co):
        np.testing.assert_allclose(p, w, **TOL)
        np.testing.assert_allclose(c, p, **TOL)
    assert mm.LAUNCHES["gather"] > 0
    if model == "din":
        assert ge.LAUNCHES["bd,uldh->blh"] > 0
        assert ge.LAUNCHES["bl,uld->bd"] > 0


def test_dlrm_tpu_engine_matches_plain_twin(cuda):
    """DLRM under ``tpu``: stage 2 runs the gathered mari_matmul and the
    dot_interaction kernel; a use_pallas=False engine on the same params
    runs their plain versions."""
    graph = get_config("dlrm-mlperf").smoke_build()()[0]
    params = init_graph_params(graph, seed=0, device=cuda)
    plan = ServePlan.preset("tpu").evolve(batch__max_batch=256,
                                          batch__min_bucket=16)
    twin = ServingEngine(graph, params, plan.evolve(
        kernel__use_pallas=False, kernel__kernel_gather=False), device=cuda)
    reqs = _requests(graph, (11, 300, 5), seed=2)
    want = [r.scores for r in twin.score_coalesced(reqs)]
    mm.reset_launches()
    di.reset_launches()
    eng = ServingEngine(graph, params, plan, device=cuda)
    per = [eng.score(r).scores for r in reqs]
    co = [r.scores for r in eng.score_coalesced(reqs)]
    for w, p, c in zip(want, per, co):
        np.testing.assert_allclose(p, w, **TOL)
        np.testing.assert_allclose(c, w, **TOL)
    assert mm.LAUNCHES["gather"] > 0 and di.LAUNCHES["triu"] > 0


def test_overlapped_groups_keep_private_buffers(cuda):
    """Several same-bucket groups launched before any is collected: each
    pack's pinned buffers stay its own while its non-blocking copy is
    pending, so no group reads another group's candidate rows."""
    graph, _ = build_paper_ranking_model(PaperRankingConfig().scaled(0.1))
    params = init_graph_params(graph, seed=0, device=cuda)
    eng = ServingEngine(graph, params, ServePlan.preset("tpu").evolve(
        batch__max_batch=256, batch__min_bucket=256), device=cuda)
    groups = [_requests(graph, (200, 50), seed=s) for s in range(6)]
    for g, s in zip(groups, range(6)):
        for uid, r in enumerate(g):
            r.user_id = 10 * s + uid
    want = [[eng.score(r).scores for r in g] for g in groups]
    handles = [eng.begin_coalesced(g) for g in groups]
    for h, w in zip(handles, want):
        for r, expect in zip(eng.collect(h), w):
            np.testing.assert_allclose(r.scores, expect, **TOL)


def _din_case(dev, B, L, D, h1, h2, seed=0):
    g = _gen(dev, seed)
    q, keys = _randn(g, B, D), _randn(g, L, D)
    mask = torch.rand(L, generator=g, device=dev) < 0.8
    mask[0] = True
    weights = (_randn(g, 4 * D, h1) * 0.2, _randn(g, h1) * 0.1,
               _randn(g, h1, h2) * 0.2, _randn(g, h2) * 0.1,
               _randn(g, h2, 1) * 0.2, _randn(g, 1) * 0.1)
    return (q, keys, mask) + weights


@pytest.mark.parametrize("B,L,D,h1,h2", [(4096, 100, 18, 80, 40),
                                         (4, 5, 8, 16, 8),
                                         (33, 20, 18, 16, 8),
                                         (128, 100, 18, 16, 8),
                                         (1, 7, 6, 12, 5),
                                         (300, 37, 33, 128, 64)])
def test_din_attention_kernel_matches_plain(cuda, B, L, D, h1, h2):
    args = _din_case(cuda, B, L, D, h1, h2, seed=B + L)
    before = da.LAUNCHES["shared_keys"]
    got = da.din_attention(*args)
    torch.cuda.synchronize()
    assert da.LAUNCHES["shared_keys"] == before + 1
    assert got.shape == (B, D)
    torch.testing.assert_close(got, da.din_attention_plain(*args), **TOL)


def test_din_attention_kernel_rows_and_masks(cuda):
    """A row's result does not depend on B; an all-masked history pools
    the keys uniformly, as the reference's softmax over -1e30 does."""
    args = _din_case(cuda, 300, 100, 18, 80, 40, seed=3)
    full = da.din_attention(*args)
    part = da.din_attention(args[0][117:203].contiguous(), *args[1:])
    assert torch.equal(full[117:203], part)
    masked = (args[0], args[1], torch.zeros_like(args[2])) + args[3:]
    got = da.din_attention(*masked)
    torch.testing.assert_close(got, da.din_attention_plain(*masked), **TOL)
    torch.testing.assert_close(got, args[1].mean(0).expand_as(got), **TOL)


def test_din_attention_kernel_refuses_what_it_cannot_take(cuda):
    args = _din_case(cuda, 8, 10, 6, 16, 8)
    with pytest.raises(TypeError, match="float32 only"):
        da.din_attention(args[0].bfloat16(), *args[1:])
    wide = _din_case(cuda, 8, 10, 6, 200, 8)
    with pytest.raises(ValueError, match="register tiles"):
        da.din_attention(*wide)
    long = _din_case(cuda, 8, 4000, 18, 16, 8)
    with pytest.raises(ValueError, match="shared memory"):
        da.din_attention(*long)
    # the executor's routing asks the same predicate
    assert da.fits(*args) and da.fits(*_din_case(cuda, 8, 100, 18, 80, 40))
    assert not da.fits(*wide) and not da.fits(*long)
    assert not da.fits(*_din_case(cuda, 8, 10, 6, 16, 65))
    # DIN at configs/din.py width stages 91552 bytes: room to spare
    assert da.ops._lib().din_attention_smem_bytes(100, 18, 80, 40) == 91552
    with pytest.raises(ValueError, match="4D -> h1 -> h2 -> 1"):
        da.din_attention(args[0], args[1], args[2], args[3][:-1], *args[4:])


def _autograd_cases(dev):
    g = _gen(dev, 9)
    x, w, u = _randn(g, 16, 8), _randn(g, 8, 4), _randn(g, 1, 4)
    idx = torch.zeros(16, dtype=torch.int32, device=dev)
    return {
        "mari_matmul": (lambda a: mm.mari_matmul(a, w, u, None, "relu"), x),
        "gather_einsum": (lambda a: ge.gather_einsum(
            "bl,uld->bd", a, _randn(g, 2, 16, 8), idx), _randn(g, 16, 16)),
        "dot_interaction": (di.dot_interaction, _randn(g, 16, 5, 8)),
        "din_attention": (lambda a: da.din_attention(
            a, *_din_case(dev, 16, 10, 8, 16, 8)[1:]), _randn(g, 16, 8)),
        "embedding_bag": (lambda a: eb.embedding_bag_fixed(
            a, torch.zeros(4, 3, dtype=torch.int32, device=dev)),
            _randn(g, 10, 8)),
    }


@pytest.mark.parametrize("kernel", ["mari_matmul", "gather_einsum",
                                    "dot_interaction", "din_attention",
                                    "embedding_bag"])
def test_kernel_wrappers_refuse_autograd(cuda, kernel):
    """No kernel has a backward: a CUDA input that requires grad under grad
    mode raises instead of leaving its gradient out; without grad mode the
    same call launches."""
    fn, x = _autograd_cases(cuda)[kernel]
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fn(x)
    with torch.no_grad():
        assert fn(x).requires_grad is False
    with torch.inference_mode():
        fn(x.detach())


def test_executor_routes_shared_key_din_to_kernel(cuda):
    """Single-call UOI and MaRI over batch-1 DIN keys go through the
    din_attention kernel and agree with the plain executors; VanI tiles
    the keys and never launches it."""
    graph = get_config("din").smoke_build()()[0]
    params = init_graph_params(graph, seed=0, device=cuda)
    feeds = make_recsys_feeds(graph, 300, np.random.default_rng(4))
    mg, mp, _ = apply_mari(graph, params)
    for g, p in ((graph, params), (mg, mp)):
        want = Executor(g, "uoi", device=cuda).run(p, feeds)
        da.reset_launches()
        got = Executor(g, "uoi", use_pallas=True, device=cuda).run(p, feeds)
        torch.cuda.synchronize()
        assert da.LAUNCHES["shared_keys"] == 1
        for o in g.outputs:
            torch.testing.assert_close(got[o], want[o], **TOL)
    da.reset_launches()
    Executor(graph, "vani", use_pallas=True, device=cuda).run(params, feeds)
    assert da.LAUNCHES["shared_keys"] == 0


# -- embedding_bag ------------------------------------------------------------

def _bag_case(dev, V, D, S, nnz, seed, lo=0, hi=None, seg_lo=0, seg_hi=None,
              id_dtype=torch.int32):
    g = _gen(dev, seed)
    table = _randn(g, V, D)
    ids = torch.randint(lo, V if hi is None else hi, (nnz,), generator=g,
                        device=dev).to(id_dtype)
    segs = torch.randint(seg_lo, S if seg_hi is None else seg_hi, (nnz,),
                         generator=g, device=dev)
    return table, ids, segs, torch.rand(nnz, generator=g, device=dev)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("V,D,S,nnz", [(16, 8, 4, 20), (100, 32, 17, 123),
                                       (1000, 128, 64, 512), (50, 18, 9, 70),
                                       (30, 1, 5, 40), (200, 130, 33, 300)])
def test_embedding_bag_kernel_matches_plain(cuda, V, D, S, nnz, combiner,
                                            weighted):
    """The reference's sweep (tests/test_kernels.py::TestEmbeddingBag) and
    ragged widths: D = 18 and 1 take the scalar path, D = 130 a partial
    column tile; unsorted segments, empty bags."""
    table, ids, segs, w = _bag_case(cuda, V, D, S, nnz, seed=V + nnz)
    w = w if weighted else None
    before = eb.LAUNCHES["csr"]
    got = eb.embedding_bag(table, ids, segs, S, combiner, w)
    torch.cuda.synchronize()
    assert eb.LAUNCHES["csr"] == before + 1
    torch.testing.assert_close(
        got, eb.embedding_bag_plain(table, ids, segs, S, combiner, w), **TOL)


def test_embedding_bag_kernel_index_contract(cuda):
    """Ids outside [0, V) clamp to the table's edge rows (no read outside
    the table); segment ids outside [0, S) are dropped; int64 ids work;
    empty bags are 0."""
    table, ids, segs, w = _bag_case(cuda, 64, 16, 8, 400, seed=7, lo=-40,
                                    hi=120, seg_lo=-3, seg_hi=12,
                                    id_dtype=torch.int64)
    for combiner in ("sum", "mean"):
        got = eb.embedding_bag(table, ids, segs, 8, combiner, w)
        want = eb.embedding_bag_plain(table, ids, segs, 8, combiner, w)
        torch.testing.assert_close(got, want, **TOL)
    clamped = eb.embedding_bag(table, torch.tensor([-5, 999], device=cuda),
                               torch.tensor([0, 1], device=cuda), 3)
    torch.testing.assert_close(clamped[:2], table[[0, 63]], **TOL)
    assert torch.equal(clamped[2], torch.zeros(16, device=cuda))


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("V,B,H,D", [(2_564_352, 4096, 100, 128),
                                     (1000, 300, 7, 128), (97, 33, 3, 18),
                                     (500, 5, 1, 64), (40, 17, 12, 1)])
def test_embedding_bag_fixed_kernel_matches_plain(cuda, V, B, H, D,
                                                  combiner):
    """The fixed-hotness entry at the multi-hot DLRM path's largest bag
    (sparse_20 at scale_tables=0.1) and ragged shapes, int32 and int64."""
    g = _gen(cuda, B + H)
    table = _randn(g, V, D)
    ids = torch.randint(0, V, (B, H), generator=g, device=cuda,
                        dtype=torch.int32)
    w = torch.rand(B, H, generator=g, device=cuda)
    before = eb.LAUNCHES["fixed"]
    for i, weights in enumerate((None, w)):
        got = eb.embedding_bag_fixed(table, ids.long() if i else ids,
                                     combiner, weights)
        torch.testing.assert_close(
            got, eb.embedding_bag_fixed_plain(table, ids, combiner, weights),
            **TOL)
    torch.cuda.synchronize()
    assert eb.LAUNCHES["fixed"] == before + 2


def test_embedding_bag_kernel_rows_and_refusals(cuda):
    """A bag's result does not depend on B; non-fp32 tables are refused;
    ``EmbeddingBag`` and ``embedding_bag_lookup`` launch the kernel."""
    g = _gen(cuda, 3)
    table = _randn(g, 5000, 128)
    ids = torch.randint(0, 5000, (300, 27), generator=g, device=cuda)
    full = eb.embedding_bag_fixed(table, ids)
    assert torch.equal(full[100:140],
                       eb.embedding_bag_fixed(table, ids[100:140]))
    with pytest.raises(TypeError, match="float32 only"):
        eb.embedding_bag_fixed(table.bfloat16(), ids)
    bag = EmbeddingBag(vocab=5000, dim=128, combiner="mean")
    params = {"table": table}
    flat, segs = ids.reshape(-1), torch.arange(300, device=cuda
                                               ).repeat_interleave(27)
    eb.reset_launches()
    a = bag.apply(params, flat, segs, 300)
    b = bag.apply_dense(params, ids)
    c = embedding_bag_lookup(table, flat, segs, 300, combiner="mean")
    torch.cuda.synchronize()
    assert eb.LAUNCHES == {"csr": 2, "fixed": 1}
    for x in (a, c):
        torch.testing.assert_close(x, b, **TOL)


def test_executor_routes_pooled_embedding_to_kernel(cuda):
    """The pooled ``embedding`` op under ``use_pallas`` launches the
    fixed-hotness entry and agrees with the plain executor."""
    graph = smoke_multihot_dlrm(GraphBuilder)
    params = init_graph_params(graph, seed=0, device=cuda)
    feeds = make_recsys_feeds(graph, 300, np.random.default_rng(4))
    want = Executor(graph, "uoi", device=cuda).run(params, feeds)
    eb.reset_launches()
    got = Executor(graph, "uoi", use_pallas=True, device=cuda).run(params,
                                                                   feeds)
    torch.cuda.synchronize()
    assert eb.LAUNCHES["fixed"] == 15       # 7 user-side + 8 item-side bags
    for o in graph.outputs:
        torch.testing.assert_close(got[o], want[o], **TOL)


# -- the device-resident tier on the card -------------------------------------

def _multihot_problem(cuda):
    graph = smoke_multihot_dlrm(GraphBuilder)
    return graph, init_graph_params(graph, seed=0, device=cuda)


def test_device_tier_multihot_dlrm_matches_plain_twin(cuda):
    """The multi-hot DLRM on ``tpu`` with the device tier: stage 2 reads
    the persistent slot tables through mari_matmul's gather init and runs
    embedding_bag and dot_interaction; every score agrees with a plain
    re-stacking engine and with its own per-request score, through slot
    writes, hits, a version bump, LRU steals and overflow."""
    graph, params = _multihot_problem(cuda)
    plan = ServePlan.preset("tpu").evolve(
        batch__max_batch=256, batch__min_bucket=16,
        cache__device_resident=True, cache__device_slots=4)
    twin = ServingEngine(graph, params, plan.evolve(
        kernel__use_pallas=False, kernel__kernel_gather=False,
        cache__device_resident=False), device=cuda)
    eng = ServingEngine(graph, params, plan, device=cuda)
    assert eng.device_resident and not eng.hedging
    mm.reset_launches()
    eb.reset_launches()
    di.reset_launches()
    passes = [_requests(graph, (11, 300, 5), seed=2)]
    passes.append(passes[0])                            # slot hits
    bumped = _requests(graph, (40,), seed=3)[0]
    bumped.user_id, bumped.feature_version = 0, 1
    passes.append([bumped])                             # supersede
    many = _requests(graph, (9,) * 6, seed=4)
    for r in many:
        r.user_id += 10
    passes.append(many)                                 # steal + overflow
    for reqs in passes:
        co = eng.score_coalesced(reqs)
        for r, c in zip(reqs, co):
            want = twin.score(r).scores
            np.testing.assert_allclose(c.scores, want, **TOL)
            np.testing.assert_allclose(eng.score(r).scores, want, **TOL)
    st = eng.device_store.stats()
    assert st["writes"] > 0 and st["hits"] > 0 and st["recycles"] > 0
    assert st["overflows"] > 0
    assert mm.LAUNCHES["gather"] > 0 and di.LAUNCHES["triu"] > 0
    assert eb.LAUNCHES["fixed"] > 0


def test_device_tier_write_after_launch_keeps_inflight_scores(cuda):
    """A pack launched before a row write reads the row as it was: the
    write is enqueued after it on the same stream (with the reference's
    copy-on-write fork armed, as under in-flight launches)."""
    graph, params = _multihot_problem(cuda)
    plan = ServePlan.preset("tpu").evolve(
        batch__max_batch=256, batch__min_bucket=256,
        cache__device_resident=True, cache__device_slots=1)
    eng = ServingEngine(graph, params, plan, device=cuda)
    a, b = _requests(graph, (200, 200), seed=5)
    b.user_id = 7
    want_a, want_b = eng.score(a).scores, eng.score(b).scores
    eng.score(a)                                  # user a holds the slot
    h_a = eng.begin_coalesced([a])
    h_b = eng.begin_coalesced([b])                # steals a's only slot
    assert eng.pipeline_forks == 1 and eng.device_store.forks == 1
    np.testing.assert_allclose(eng.collect(h_a)[0].scores, want_a, **TOL)
    np.testing.assert_allclose(eng.collect(h_b)[0].scores, want_b, **TOL)
    # without the fork: an in-place write right after a launch
    h_b = eng.begin_coalesced([b])
    store = eng.device_store
    store.ensure_rows([(a.user_id, 0, eng.cache.get((a.user_id, 0)))])
    assert store.forks == 1 and store.slot_of(b.user_id) is None
    np.testing.assert_allclose(eng.collect(h_b)[0].scores, want_b, **TOL)


@pytest.mark.parametrize("model", ["paper", "din"])
def test_device_tier_on_earlier_engines(cuda, model):
    """The paper model and DIN under ``tpu`` with the device tier:
    mari_matmul's gather init (and DIN's gather_einsum) index the
    (capacity, ...) slot tables; scores agree with the re-stacking
    engine."""
    if model == "paper":
        graph, _ = build_paper_ranking_model(PaperRankingConfig().scaled(0.1))
    else:
        graph, _ = build_din(embed_dim=8, seq_len=12, attn_mlp=(16, 8),
                             mlp=(24, 12), item_vocab=128)
    params = init_graph_params(graph, seed=0, device=cuda)
    plan = ServePlan.preset("tpu").evolve(batch__max_batch=64,
                                          batch__min_bucket=8)
    ref = ServingEngine(graph, params, plan, device=cuda)
    eng = ServingEngine(graph, params, plan.evolve(
        cache__device_resident=True, cache__device_slots=8), device=cuda)
    reqs = _requests(graph, (11, 70, 5), seed=1)
    mm.reset_launches()
    ge.reset_launches()
    for r, c in zip(reqs, eng.score_coalesced(reqs)):
        np.testing.assert_allclose(c.scores, ref.score(r).scores, **TOL)
    assert eng.device_store.writes == 3
    assert mm.LAUNCHES["gather"] > 0
    if model == "din":
        assert ge.LAUNCHES["bd,uldh->blh"] > 0


def test_hedged_dispatch_on_the_card(cuda):
    """Hedging on (``paper`` + kernels): a policy floor of 0 hedges every
    dispatch after a shape's first; the duplicate runs on a worker thread
    on the engine's stream and the scores equal an unhedged engine's."""
    from repro_torch.serve.hedging import HedgePolicy
    graph, _ = build_paper_ranking_model(PaperRankingConfig().scaled(0.1))
    params = init_graph_params(graph, seed=0, device=cuda)
    plan = ServePlan.preset("paper").evolve(
        kernel__use_pallas=True, batch__max_batch=64, batch__min_bucket=8)
    eng = ServingEngine(graph, params, plan, device=cuda,
                        hedge_policy=HedgePolicy(min_hedge_ms=0.0))
    ref = ServingEngine(graph, params, plan.evolve(batch__hedging=False),
                        device=cuda)
    reqs = _requests(graph, (11, 70, 5), seed=1)
    for _ in range(2):
        for r, c in zip(reqs, eng.score_coalesced(reqs)):
            np.testing.assert_allclose(c.scores, ref.score(r).scores, **TOL)
    assert eng.ft_stats()["hedges_launched"] > 0
    eng.close()
