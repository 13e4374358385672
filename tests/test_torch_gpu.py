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
from repro_torch.kernels import gather_einsum as ge
from repro_torch.kernels import mari_matmul as mm
from repro_torch.models.ranking import (PaperRankingConfig,
                                        build_paper_ranking_model)
from repro_torch.models.recsys import build_din
from repro_torch.serve import ServePlan, ServeRequest, ServingEngine

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
    }


@pytest.mark.parametrize("kernel", ["mari_matmul", "gather_einsum",
                                    "dot_interaction", "din_attention"])
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
