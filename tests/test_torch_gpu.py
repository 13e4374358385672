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
    """bf16 runs only with bf16 on both sides: a bf16 x against an fp32 w
    (or fp16 operands) is refused, not converted."""
    x = torch.zeros(4, 8, device=cuda, dtype=torch.bfloat16)
    u = torch.zeros(1, 4, device=cuda)
    with pytest.raises(TypeError, match="one dtype"):
        mm.mari_matmul(x, x.T.contiguous().float(), u)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mm.mari_matmul(x.half(), x.T.contiguous().half(), u)


# every mari_dense stream of the served models: (stream K, N)
MARI_PATH_SHAPES = [(1064, 512), (1064, 4), (256, 128), (500, 64), (48, 200),
                    (351, 1024), (190, 400)]


def _mari_case(dev, B, K, N, mode, U=8, seed=0, scale=0.05):
    g = _gen(dev, seed + B + K + N)
    x, w = _randn(g, B, K), _randn(g, K, N) * scale
    u = _randn(g, {"broadcast": 1, "rowwise": B, "gather": U}[mode], N)
    idx = (torch.randint(-2, U + 3, (B,), generator=g, device=dev,
                         dtype=torch.int32) if mode == "gather" else None)
    return x, w, u, idx


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("mode", ["broadcast", "rowwise", "gather"])
@pytest.mark.parametrize("K,N", MARI_PATH_SHAPES)
def test_mari_matmul_path_shapes_match_plain(cuda, K, N, mode, activation):
    """Each init mode and epilogue at every mari_dense shape of the served
    models, a full bucket of 4096, the weight prepared once."""
    x, w, u, idx = _mari_case(cuda, 4096, K, N, mode)
    got = mm.mari_matmul(x, mm.prepare_mari_weight(w), u, idx, activation)
    torch.testing.assert_close(got, mm.mari_matmul_plain(x, w, u, idx,
                                                         activation), **TOL)


@pytest.mark.parametrize("mode", ["broadcast", "rowwise", "gather"])
@pytest.mark.parametrize("B,K,N", [(1, 3, 1), (65, 33, 9), (129, 31, 130),
                                   (300, 1, 257), (4097, 37, 129),
                                   (70, 1064, 33), (200, 0, 16)])
def test_mari_matmul_ragged_edges(cuda, mode, B, K, N):
    """Ragged B, K and N (TMA zero-fills, stores masked; K = 0 leaves the
    init), out-of-range and negative gather indices (clamped)."""
    x, w, u, idx = _mari_case(cuda, B, K, N, mode, U=5, scale=1.0)
    got = mm.mari_matmul(x, w, u, idx, "silu")
    torch.testing.assert_close(got, mm.mari_matmul_plain(x, w, u, idx,
                                                         "silu"), **TOL)


@pytest.mark.parametrize("mode", ["broadcast", "rowwise", "gather"])
def test_mari_matmul_row_bit_identical_whatever_the_batch(cuda, mode):
    """A row's output is the same bits at B = 64 (64-row tiles) and inside
    B = 4096 (128-row tiles): no split-K, one k order."""
    x, w, u, idx = _mari_case(cuda, 4096, 1064, 512, mode)
    pw = mm.prepare_mari_weight(w)
    assert mm.ops.tile_config(64, 512)[0] != mm.ops.tile_config(4096, 512)[0]
    full = mm.mari_matmul(x, pw, u, idx, "relu")
    rows = slice(1000, 1064)
    part = mm.mari_matmul(
        x[rows].contiguous(), pw, u[rows].contiguous() if mode == "rowwise"
        else u, None if idx is None else idx[rows].contiguous(), "relu")
    assert torch.equal(full[rows], part)


def test_mari_matmul_prepared_and_raw_weight_agree(cuda):
    """A raw CUDA weight is prepared inside the call (counted in PREPARES);
    a prepared one is not; both give the same bits."""
    x, w, u, _ = _mari_case(cuda, 300, 190, 400, "broadcast")
    pw = mm.prepare_mari_weight(w)
    before = dict(mm.PREPARES)
    raw = mm.mari_matmul(x, w, u, None, "relu")
    assert mm.PREPARES["float32"] == before["float32"] + 1
    prepared = mm.mari_matmul(x, pw, u, None, "relu")
    assert mm.PREPARES == {**before, "float32": before["float32"] + 1}
    assert torch.equal(raw, prepared)
    # a weight prepared on the CPU is refused, not moved
    with pytest.raises(ValueError, match="w on cpu"):
        mm.mari_matmul(x, mm.prepare_mari_weight(w.cpu()), u)


def test_mari_matmul_stride_copies_counted(cuda):
    """An x whose rows TMA cannot read (351 fp32 = 1404 bytes) is copied to
    a padded stride and counted; the same values written into an
    ``empty_stream`` buffer go through as they are."""
    x, w, u, _ = _mari_case(cuda, 500, 351, 1024, "broadcast")
    pw = mm.prepare_mari_weight(w)
    before = mm.STRIDE_COPIES["float32"]
    copied = mm.mari_matmul(x, pw, u, None, "relu")
    assert mm.STRIDE_COPIES["float32"] == before + 1
    xv = mm.empty_stream(500, 351, torch.float32, cuda)
    xv.copy_(x)
    direct = mm.mari_matmul(xv, pw, u, None, "relu")
    assert mm.STRIDE_COPIES["float32"] == before + 1
    assert torch.equal(copied, direct)


@pytest.mark.parametrize("activation", ACTS)
@pytest.mark.parametrize("mode", ["broadcast", "rowwise", "gather"])
@pytest.mark.parametrize("B,K,N", [(4096, 1064, 512), (1000, 333, 65),
                                   (37, 8, 4)])
def test_mari_matmul_bf16_matches_plain(cuda, mode, activation, B, K, N):
    """The bf16 entry: bf16 x and w, the f32 accumulator from the f32 u,
    bf16 out, within the reference's bf16 tolerance."""
    x, w, u, idx = _mari_case(cuda, B, K, N, mode)
    xb, wb = x.bfloat16(), w.bfloat16()
    before = mm.LAUNCHES["bf16"]
    got = mm.mari_matmul(xb, wb, u, idx, activation)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert mm.LAUNCHES["bf16"] == before + 1
    torch.testing.assert_close(
        got.float(), mm.mari_matmul_plain(xb, wb, u, idx, activation).float(),
        rtol=2e-2, atol=2e-2)


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


def _ge_operands(g, spec, B, U, L, D, H):
    x_shape, t_shape = {
        "bd,uldh->blh": ((B, D), (U, L, D, H)),
        "bl,uld->bd": ((B, L), (U, L, D)),
        "blh,uh->bl": ((B, L, H), (U, H)),
    }[spec]
    return _randn(g, *x_shape), _randn(g, *t_shape)


def _ge_index(g, order, B, U):
    """user_index in the engine's layout or another order: "runs" sorts
    random slots (contiguous runs of random length, boundaries anywhere in
    a 64-row tile), "runs_aligned" gives each user B // U rows,
    "short_runs" cycles through the U slots in runs of 3 rows (more than 8
    users a 64-row tile once U > 8), "random" draws each row's slot,
    "clamped" adds out-of-range values."""
    dev = g.device
    if order == "clamped":
        return torch.randint(-3, U + 4, (B,), generator=g, device=dev,
                             dtype=torch.int32)
    idx = torch.randint(0, U, (B,), generator=g, device=dev,
                        dtype=torch.int32)
    if order == "runs":
        return torch.sort(idx).values
    if order == "runs_aligned":
        return (torch.arange(B, device=dev) * U // B).to(torch.int32)
    if order == "short_runs":
        return (torch.arange(B, device=dev) // 3 % U).to(torch.int32)
    return idx


# (order, U, B, L, H): runs inside and across row tiles, random order at U =
# 1, 8, 64, short runs (tiles of more than 8 users, read from L2),
# out-of-range indices, B of 1, 301 and 4096, and L*H that is no multiple
# of the column tile (L*H = 660), of 4 (91) or of 2 (63)
GE_CASES = [("runs", 8, 301, 100, 80), ("runs", 8, 4096, 100, 80),
            ("runs_aligned", 8, 4096, 100, 80), ("runs", 64, 4096, 100, 80),
            ("runs", 3, 130, 33, 20), ("random", 1, 301, 100, 80),
            ("random", 8, 4096, 100, 80), ("random", 64, 301, 100, 80),
            ("random", 64, 4096, 100, 80), ("clamped", 8, 301, 100, 80),
            ("clamped", 64, 1, 100, 80), ("random", 8, 1, 100, 80),
            ("random", 11, 301, 33, 20), ("random", 5, 77, 7, 13),
            ("runs", 9, 200, 9, 7), ("random", 40, 300, 9, 7),
            ("short_runs", 64, 4096, 100, 80), ("short_runs", 9, 301, 33, 20),
            ("short_runs", 64, 200, 9, 7)]


@pytest.mark.parametrize("order,U,B,L,H", GE_CASES)
@pytest.mark.parametrize("spec", ge.KERNEL_SPECS)
def test_gather_einsum_kernel_index_orders(cuda, spec, order, U, B, L, H):
    g = _gen(cuda, U * B + L * H)
    x, table = _ge_operands(g, spec, B, U, L, 18, H)
    idx = _ge_index(g, order, B, U)
    got = ge.gather_einsum(spec, x, table, idx)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ge.gather_einsum_plain(spec, x, table,
                                                           idx), **TOL)


@pytest.mark.parametrize("order,U", [("random", 8), ("runs", 8),
                                     ("random", 64), ("short_runs", 64)])
@pytest.mark.parametrize("spec", ["bd,uldh->blh", "bl,uld->bd"])
def test_gather_einsum_row_bit_identical_whatever_the_batch(cuda, spec,
                                                            order, U):
    """A row's result depends on its own x and user alone: a slice of the
    rows (other tiles, other neighbours) gives the same bits. Over 64 slots
    a full tile holds more than 8 users (slices read from L2) and a short
    slice fewer (staged in shared memory): both routes agree."""
    g = _gen(cuda, 7)
    x, table = _ge_operands(g, spec, 301, U, 100, 18, 80)
    idx = _ge_index(g, order, 301, U)
    full = ge.gather_einsum(spec, x, table, idx)
    for lo, hi in ((117, 203), (0, 1), (250, 301), (250, 255), (64, 70)):
        part = ge.gather_einsum(spec, x[lo:hi].contiguous(), table,
                                idx[lo:hi].contiguous())
        assert torch.equal(full[lo:hi], part)


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


@pytest.mark.parametrize("B", [1, 64, 256])
@pytest.mark.parametrize("keep_self", [False, True])
@pytest.mark.parametrize("shape", ["ragged_d", "shifted_view", "aligned"])
def test_dot_interaction_copy_routes(cuda, shape, keep_self, B):
    """The 4-byte cp.async instance (D = 33; a view starting 4 bytes past
    16-byte alignment) and the TMA instance hold the plain version, and a
    row's bits do not depend on the route."""
    g = _gen(cuda, B)
    if shape == "ragged_d":
        x = _randn(g, B, 7, 33)
    else:
        flat = _randn(g, B * 27 * 128 + 1)
        x = (flat[1:] if shape == "shifted_view" else flat[:-1]).view(
            B, 27, 128)
    want = {"ragged_d": "cp.async", "shifted_view": "cp.async",
            "aligned": "tma"}[shape]
    assert di.copy_route(x) == want
    got = di.dot_interaction(x, keep_self)
    torch.testing.assert_close(got, di.dot_interaction_plain(x, keep_self),
                               **TOL)
    if shape == "shifted_view":
        assert torch.equal(got, di.dot_interaction(x.clone(), keep_self))


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
    assert sum(mm.PREPARES.values()) == 0      # weights prepared at load
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
    assert sum(mm.PREPARES.values()) == 0


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
                                         (2048, 100, 18, 80, 40),
                                         (4, 5, 8, 16, 8),
                                         (33, 20, 18, 16, 8),
                                         (128, 100, 18, 16, 8),
                                         (1, 7, 6, 12, 5),
                                         (300, 37, 33, 128, 64),
                                         (40, 300, 18, 80, 40)])
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


def test_din_attention_kernel_longest_history(cuda):
    """At DIN width a block holds every key, its rows' scores and 112 keys'
    first-layer parts at a time: up to 920 keys. The kernel takes 920 (nine
    chunks) and holds the plain version, a row slice gives the same bits,
    and 921 is refused, so the executor routes it to the plain version."""
    lib = da.ops._lib()
    assert (lib.din_attention_smem_bytes(920, 18, 80, 40)
            <= da.ops.MAX_SMEM_BYTES
            < lib.din_attention_smem_bytes(921, 18, 80, 40))
    args = _din_case(cuda, 64, 920, 18, 80, 40, seed=5)
    assert da.fits(*args)
    full = da.din_attention(*args)
    torch.testing.assert_close(full, da.din_attention_plain(*args), **TOL)
    part = da.din_attention(args[0][21:30].contiguous(), *args[1:])
    assert torch.equal(full[21:30], part)
    longer = _din_case(cuda, 8, 921, 18, 80, 40)
    assert not da.fits(*longer)
    with pytest.raises(ValueError, match="shared memory"):
        da.din_attention(*longer)


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
    # DIN at configs/din.py width stages 106832 bytes: two blocks an SM
    assert da.ops._lib().din_attention_smem_bytes(100, 18, 80, 40) == 106832
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


def _csr_old_prep(table, ids, segs, S, combiner, w):
    """The sort-based preparation (csr_prep_plain) feeding the same bag
    kernel: what the counting sort replaced."""
    order, offsets = eb.csr_prep_plain(segs, S)
    return eb.ops._launch("csr", table, ids[order], offsets,
                          w[order] if w is not None else None, S, 0,
                          combiner)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("seg_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("order", ["sorted", "shuffled", "dropped_empty"])
@pytest.mark.parametrize("S,nnz", [(4096, 409_600), (300, 2000),
                                   (100_000, 300_000), (1, 50)])
def test_embedding_bag_csr_bitwise_old_preparation(cuda, S, nnz, order,
                                                   seg_dtype, combiner):
    """The counting sort puts each bag's ids in input order, as the stable
    sort did, so the CSR entry equals the old preparation feeding the same
    bag kernel bit for bit, with and without weights."""
    g = _gen(cuda, S + nnz)
    table = _randn(g, 3000, 64)
    ids = torch.randint(-2, 3002, (nnz,), generator=g, device=cuda)
    if order == "sorted":
        segs = torch.randint(0, S, (nnz,), generator=g, device=cuda).sort()[0]
    elif order == "shuffled":
        segs = torch.randint(0, S, (nnz,), generator=g, device=cuda)
    else:                                  # out of range, every other bag
        segs = 2 * torch.randint(-1, (S + 3) // 2, (nnz,), generator=g,
                                 device=cuda)
    segs = segs.to(seg_dtype)
    w = torch.rand(nnz, generator=g, device=cuda)
    for weights in (None, w):
        got = eb.embedding_bag(table, ids, segs, S, combiner, weights)
        assert torch.equal(got, _csr_old_prep(table, ids, segs, S, combiner,
                                              weights))
        assert torch.equal(got, eb.embedding_bag(table, ids, segs, S,
                                                 combiner, weights))


def test_kernel_wrappers_do_not_synchronise(cuda):
    """Neither the CSR entry (its counting sort included) nor the
    dot_interaction wrapper makes a host synchronisation."""
    g = _gen(cuda, 5)
    table = _randn(g, 500, 32)
    ids = torch.randint(0, 500, (3000,), generator=g, device=cuda)
    segs = torch.randint(-1, 70, (3000,), generator=g, device=cuda)
    w = torch.rand(3000, generator=g, device=cuda)
    x, xr = _randn(g, 300, 27, 128), _randn(g, 130, 7, 33)
    eb.embedding_bag(table, ids, segs, 64, "mean", w)      # built, loaded
    di.dot_interaction(x)
    di.dot_interaction(xr)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eb.embedding_bag(table, ids, segs, 64, "mean", w)
        eb.embedding_bag(table, ids.int(), segs.int(), 64)
        di.dot_interaction(x)
        di.dot_interaction(xr, keep_self=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


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


# -- compiled stages: captured CUDA graphs ------------------------------------

def _eager_stage2(eng, table, uidx, cand):
    """The stage-2 body run eagerly on the card (what each graph captures)."""
    feeds = {"t:" + k: v for k, v in table.items()}
    feeds.update(("c:" + k, v) for k, v in cand.items())
    feeds["uidx"] = uidx
    with torch.inference_mode():
        return eng._stage2_body(eng.params, feeds)


def _model(name, dev):
    if name == "paper":
        graph, _ = build_paper_ranking_model(PaperRankingConfig().scaled(0.1))
    elif name == "din":
        graph, _ = build_din(embed_dim=8, seq_len=12, attn_mlp=(16, 8),
                             mlp=(24, 12), item_vocab=128)
    else:
        graph = get_config("dlrm-mlperf").smoke_build()()[0]
    return graph, init_graph_params(graph, seed=0, device=dev)


@pytest.mark.parametrize("model", ["paper", "din", "dlrm"])
def test_captured_stages_match_eager_at_every_bucket(cuda, model):
    """Stage 1 replayed against its eager executor, and stage 2 at every
    bucket (8 .. 64) and rep-table size (1, 2, 4 users) replayed against
    the eager body on the same inputs; one graph per signature, and a
    repeated pass captures nothing."""
    graph, params = _model(model, cuda)
    eng = ServingEngine(graph, params, ServePlan.preset("tpu").evolve(
        batch__max_batch=64, batch__min_bucket=8, batch__hedging=False),
        device=cuda)
    reqs = _requests(graph, (5, 9, 17, 33), seed=3)
    reps = []
    for r in reqs:
        feeds = {k: v for k, v in r.user_feeds.items()
                 if k in eng._stage1_inputs}
        got = eng._stage1_run(eng.params, feeds)
        with torch.inference_mode():
            want = eng._stage1.run(eng.params, feeds)
        for k in want:
            torch.testing.assert_close(got[k], want[k], **TOL)
        reps.append(got)
    assert eng.stage1_compilations == 1
    rng = np.random.default_rng(4)
    big = _requests(graph, (64,), seed=5)[0].candidate_feeds
    for _ in range(2):
        for users in (1, 2, 4):
            table = {k: torch.cat([r[k] for r in reps[:users]])
                     for k in reps[0]}
            stack = {k: [r[k] for r in reps[:users]] for k in reps[0]}
            for bucket in (8, 16, 32, 64):
                uidx = torch.as_tensor(rng.integers(0, users, bucket),
                                       dtype=torch.int32, device=cuda)
                cand = {k: torch.as_tensor(v[:bucket], device=cuda)
                        for k, v in big.items()}
                got = eng._stage2(eng.params, stack, {}, uidx, cand)
                want = _eager_stage2(eng, table, uidx, cand)
                for o in eng.outputs:
                    torch.testing.assert_close(got[o], want[o], **TOL)
        if _ == 0:
            built = eng.stage2_compilations
    assert built == eng.stage2_compilations == 12
    assert eng.graph_pool.captures == 13
    eng.close()


def test_compiled_packs_in_flight_at_one_bucket(cuda):
    """Eight groups at one bucket launched before any is collected: each
    replay's outputs are copied out behind it, so no group reads another
    group's scores from the graph's static outputs."""
    graph, params = _model("paper", cuda)
    eng = ServingEngine(graph, params, ServePlan.preset("tpu").evolve(
        batch__max_batch=256, batch__min_bucket=256, batch__hedging=False),
        device=cuda)
    groups = [_requests(graph, (120, 90), seed=20 + s) for s in range(8)]
    for s, g in enumerate(groups):
        for uid, r in enumerate(g):
            r.user_id = 10 * s + uid
    want = [[eng.score(r).scores for r in g] for g in groups]
    n = eng.stage2_compilations
    handles = [eng.begin_coalesced(g) for g in groups]
    for h, w in zip(handles, want):
        for r, expect in zip(eng.collect(h), w):
            np.testing.assert_allclose(r.scores, expect, **TOL)
    assert eng.stage2_compilations == n + 1       # the 2-user table
    eng.close()


def test_device_tier_tables_keep_their_address(cuda):
    """With the clone fork gone and quarantine keeping the allocation, the
    slot tables never move: a write armed under an in-flight launch, a
    quarantine and the rebuild all replay the graphs captured before them
    (no recapture), and every score stays the re-stacking twin's."""
    graph, params = _multihot_problem(cuda)
    plan = ServePlan.preset("tpu").evolve(
        batch__max_batch=256, batch__min_bucket=256,
        cache__device_resident=True, cache__device_slots=2)
    eng = ServingEngine(graph, params, plan, device=cuda)
    twin = ServingEngine(graph, params, plan.evolve(
        cache__device_resident=False), device=cuda)
    a, b, c = _requests(graph, (200, 150, 100), seed=6)
    want = {r.user_id: twin.score(r).scores for r in (a, b, c)}
    eng.score(a)
    eng.score(b)
    store = eng.device_store
    ptrs = {k: t.data_ptr() for k, t in store.tables.items()}
    n = eng.stage2_compilations
    h_a = eng.begin_coalesced([a])
    h_c = eng.begin_coalesced([c])                # steals a slot in flight
    assert eng.pipeline_forks == 1 and store.forks == 1
    for h, r in ((h_a, a), (h_c, c)):
        np.testing.assert_allclose(eng.collect(h)[0].scores,
                                   want[r.user_id], **TOL)
    eng._quarantine_device_tier("test")
    for r in (a, b, c):
        np.testing.assert_allclose(eng.score(r).scores, want[r.user_id],
                                   **TOL)
    assert {k: t.data_ptr() for k, t in store.tables.items()} == ptrs
    assert eng.stage2_compilations == n and store.quarantines == 1
    eng.close()
    twin.close()


def test_hedged_replays_copy_their_own_outputs(cuda):
    """Hedging on with a 0 ms floor: primary and duplicate each copy the
    pack in, replay and copy out under the pool's lock; scores equal an
    unhedged engine's and the hedges added no graph."""
    from repro_torch.serve.hedging import HedgePolicy
    graph, params = _model("paper", cuda)
    plan = ServePlan.preset("paper").evolve(
        kernel__use_pallas=True, batch__max_batch=64, batch__min_bucket=8)
    eng = ServingEngine(graph, params, plan, device=cuda,
                        hedge_policy=HedgePolicy(min_hedge_ms=0.0))
    ref = ServingEngine(graph, params, plan.evolve(batch__hedging=False),
                        device=cuda)
    reqs = _requests(graph, (11, 70, 5), seed=1)
    for _ in range(3):
        for r, c in zip(reqs, eng.score_coalesced(reqs)):
            np.testing.assert_allclose(c.scores, ref.score(r).scores, **TOL)
    assert eng.ft_stats()["hedges_launched"] > 0
    assert eng.stage2_compilations == eng.stage2_shapes
    eng.close()
    ref.close()


def test_three_service_engines_capture_from_their_threads(cuda):
    """A RankingService with three scenarios: each batcher thread captures
    its engine's graphs while the others launch and synchronise; every
    score equals its engine's own per-request score."""
    from repro_torch.serve import RankingService
    svc = RankingService(ServePlan.preset("tpu").evolve(
        batch__hedging=False, batch__max_batch=256, batch__min_bucket=16),
        device=cuda)
    for sc in ("dlrm-mlperf", "deepfm", "fm"):
        svc.register(sc)
    items = []
    for k, sc in enumerate(("dlrm-mlperf", "deepfm", "fm")):
        for r in _requests(svc.source_graph(sc), (40, 300, 7), seed=30 + k):
            items.append((sc, r))
    items = [items[i] for j in range(3) for i in range(j, len(items), 3)]
    for _ in range(2):
        got = svc.score_many(items)
    for (sc, r), g in zip(items, got):
        np.testing.assert_allclose(g.scores, svc.engine(sc).score(r).scores,
                                   **TOL)
    for sc in ("dlrm-mlperf", "deepfm", "fm"):
        eng = svc.engine(sc)
        assert eng.graph_pool.captures > 0
        assert eng.stage2_compilations == eng.stage2_routes
    svc.close()


def test_capture_failure_raises_and_runs_no_eager(cuda):
    """A body that synchronises with the host cannot be captured: the call
    raises ``GraphCaptureError``, caches no entry and never falls back to
    running the body eagerly; the card keeps working afterwards."""
    from repro_torch.graph.compiled import CompiledRun, GraphCaptureError
    runs = []

    def body(params, feeds):
        runs.append(torch.cuda.is_current_stream_capturing())
        return {"y": feeds["x"] * float(feeds["x"].sum().item())}

    run = CompiledRun(body, device=cuda)
    x = torch.ones(8, device=cuda)
    with pytest.raises(GraphCaptureError, match="no|not fall back"):
        run({}, {"x": x})
    assert run.compilations == 0
    assert runs == [False, True]                  # warm-up, then capture
    ok = CompiledRun(lambda p, f: {"y": f["x"] + 1}, device=cuda)
    torch.testing.assert_close(ok({}, {"x": x})["y"], x + 1)


def test_replays_count_launches_and_keep_tma_addresses(cuda):
    """mari_matmul (x's TMA map encoded at capture) and dot_interaction (a
    3-D map of x, its copy route from x's address) captured once and
    replayed on new data: each replay matches the plain version, and each
    counts one launch per kernel (the warm-up counts, the capture not)."""
    from repro_torch.graph.compiled import CompiledRun
    g = _gen(cuda, 7)
    w = mm.prepare_mari_weight(_randn(g, 351, 64))
    u = _randn(g, 1, 64)

    def body(params, feeds):
        return {"m": mm.mari_matmul(feeds["x"], w, u, None, "relu"),
                "d": di.dot_interaction(feeds["z"])}

    run = CompiledRun(body, device=cuda)
    mm.reset_launches()
    di.reset_launches()
    for i in range(4):
        x, z = _randn(g, 300, 351), _randn(g, 300, 27, 32)
        got = run({}, {"x": x, "z": z})
        torch.testing.assert_close(
            got["m"], mm.mari_matmul_plain(x, w, u, None, "relu"), **TOL)
        torch.testing.assert_close(got["d"], di.dot_interaction_plain(z),
                                   **TOL)
    torch.cuda.synchronize()
    assert run.compilations == 1
    assert mm.LAUNCHES["broadcast"] == 5 and di.LAUNCHES["triu"] == 5


# -- the memory tier on the card ----------------------------------------------

def _cold_engine(graph, params, dev, **over):
    plan = ServePlan.preset("tpu").evolve(**{
        "batch__hedging": False, "batch__max_batch": 256,
        "batch__min_bucket": 16, "cache__max_cached_users": 2,
        "mem__cold_tier": True, "mem__cold_bytes": 1 << 26, **over})
    return ServingEngine(graph, params, plan, device=dev)


def test_mem_tier_copies_from_two_threads_while_a_third_captures(cuda):
    """The request thread demotes, the promotion thread promotes (and its
    puts demote), while a third thread builds 40 engines that capture
    their graphs: no capture fails, no promotion fails, and every
    cold-served or promoted score stays the cache-off engine's."""
    import threading
    graph, params = _model("paper", cuda)
    eng = _cold_engine(graph, params, cuda, mem__promote_touches=1)
    off = ServingEngine(graph, params, ServePlan.preset("tpu").evolve(
        batch__hedging=False, batch__max_batch=256, batch__min_bucket=16,
        cache__cache_user_reps=False), device=cuda)
    reqs = _requests(graph, (40, 90, 17, 130, 60, 7), seed=40)
    want = [off.score(r).scores for r in reqs]
    stop, captured, errors, streams = threading.Event(), [], [], set()

    def capture():
        g2, p2 = _model("din", cuda)
        rs = _requests(g2, (9, 33, 120), seed=41)
        try:
            while not stop.is_set():
                e2 = ServingEngine(g2, p2, ServePlan.preset("tpu").evolve(
                    batch__hedging=False, batch__max_batch=256,
                    batch__min_bucket=8), device=cuda)
                for r in rs:
                    e2.score(r)
                captured.append(e2.graph_pool.captures)
                streams.add(e2.graph_pool.capture_stream.cuda_stream)
                e2.close()
        except Exception as e:          # reported by the main thread
            errors.append(e)

    th = threading.Thread(target=capture)
    th.start()
    try:
        i = 0
        while len(captured) < 40 and not errors and i < 20000:
            k = (i * 5) % len(reqs)
            np.testing.assert_allclose(eng.score(reqs[k]).scores, want[k],
                                       **TOL)
            i += 1
    finally:
        stop.set()
        th.join()
    eng.flush_promotions()
    assert errors == [] and captured and min(captured) > 0
    # pool streams are handed out round-robin (32 per priority): past 32
    # engines every default-priority stream has been a capture stream,
    # and the tier's is none of them
    assert len(streams) == 32
    assert eng._mem_stream.cuda_stream not in streams
    ms = eng.mem_stats()
    assert ms["promote"]["errors"] == 0, ms["promote"]["last_error"]
    assert ms["demotions"] > 0 and ms["promote"]["promotions"] > 0
    assert ms["cold_hits"] > 0
    eng.close()
    off.close()


def test_mem_tier_arena_rows_and_promoted_reps(cuda):
    """A demoted user's arena rows equal the device tensors they came from
    bit for bit; a promoted user's reps are tensors on the card again,
    equal to those rows."""
    graph, params = _model("paper", cuda)
    eng = _cold_engine(graph, params, cuda)
    a, b, c = _requests(graph, (20, 30, 40), seed=42)
    eng.score(a)
    hot = {k: v.cpu().numpy() for k, v in eng.cache.get((0, 0)).items()}
    eng.score(b)
    eng.score(c)                              # evicts user 0: demoted
    assert eng.demotions == 1
    rows = eng._cold.peek((0, 0))
    assert set(rows) == set(hot)
    for k in hot:
        assert rows[k].tobytes() == hot[k].tobytes(), k
    for _ in range(2):                        # two touches: promoted
        assert eng.score(a).cold_hit
    eng.flush_promotions()
    reps = eng.cache.get((0, 0))
    assert reps is not None and eng._promoter.promotions == 1
    for k, v in reps.items():
        assert v.device == cuda and v.is_cuda
        assert v.cpu().numpy().tobytes() == hot[k].tobytes(), k
    assert eng.score(a).user_cache_hit
    eng.close()


def test_mem_tier_cold_served_scores_match_cache_off(cuda):
    """With the device tier on, warmed and demoted users served cold (the
    re-stacking route) score as a cache-off engine does; a pack carrying
    a cold-served user takes no device slot."""
    graph, params = _model("paper", cuda)
    eng = _cold_engine(graph, params, cuda, cache__device_resident=True,
                       cache__device_slots=4, mem__promote_touches=3)
    off = ServingEngine(graph, params, ServePlan.preset("tpu").evolve(
        batch__hedging=False, batch__max_batch=256, batch__min_bucket=16,
        cache__cache_user_reps=False), device=cuda)
    reqs = _requests(graph, (50, 80, 120, 33, 200), seed=43)
    eng.warm([(r.user_id, r.user_feeds) for r in reqs[3:]])
    for r in reqs[:3]:
        eng.score(r)                          # user 0 demoted
    writes = eng.device_store.stats()["writes"]
    for r in (reqs[0], reqs[3], reqs[4]):
        res = eng.score(r)
        assert res.cold_hit
        np.testing.assert_allclose(res.scores, off.score(r).scores, **TOL)
    co = eng.score_coalesced([reqs[2], reqs[4], reqs[1]])
    assert [x.cold_hit for x in co] == [False, True, False]
    for r, x in zip((reqs[2], reqs[4], reqs[1]), co):
        np.testing.assert_allclose(x.scores, off.score(r).scores, **TOL)
    assert eng.device_store.stats()["writes"] == writes
    assert eng.stage2_compilations == eng.stage2_routes
    eng.close()
    off.close()


def test_mem_tier_warm_pass_captures_no_new_graph(cuda):
    """A pass of hot, cold and recompute requests builds every graph the
    traffic needs (with the device tier: slot-route graphs for hot and
    recompute, re-stacking graphs for cold); the same traffic again, and
    a second warm, capture nothing."""
    graph, params = _model("paper", cuda)
    eng = _cold_engine(graph, params, cuda, cache__device_resident=True,
                       cache__device_slots=4, cache__max_cached_users=3)
    reqs = _requests(graph, (40, 40, 120, 120, 40, 120, 40, 40), seed=44)
    eng.warm([(r.user_id, r.user_feeds) for r in reqs[4:]])
    order = [0, 1, 2, 3, 4, 5, 0, 6, 7, 1, 2]
    classes = []
    for k in order:
        res = eng.score(reqs[k])
        classes.append("hot" if res.user_cache_hit
                       else "cold" if res.cold_hit else "recompute")
    assert {"hot", "cold", "recompute"} <= set(classes)
    built = (eng.graph_pool.captures, eng.stage2_compilations,
             eng.stage1_compilations)
    assert eng.stage2_compilations == eng.stage2_routes
    eng.warm([(r.user_id, r.user_feeds) for r in reqs[4:]])
    for k in order:
        eng.score(reqs[k])
    assert (eng.graph_pool.captures, eng.stage2_compilations,
            eng.stage1_compilations) == built
    eng.close()


def test_engines_on_one_capture_stream_capture_from_two_threads(cuda):
    """Two engines whose pools drew the same pool stream (torch hands out
    32 per priority, round-robin) capture from two threads at once: the
    process-wide capture lock keeps each warm-up and capture out of the
    other's, so every graph builds and scores as an engine capturing
    alone does."""
    import threading
    graph, params = _model("paper", cuda)
    plan = ServePlan.preset("tpu").evolve(batch__hedging=False,
                                          batch__max_batch=256,
                                          batch__min_bucket=8)
    a = ServingEngine(graph, params, plan, device=cuda)
    # draw pool streams until the round-robin comes back to a's; 31 more
    # bring the next draw, b's capture stream, onto it again
    for _ in range(32):
        if torch.cuda.Stream(cuda).cuda_stream == \
                a.graph_pool.capture_stream.cuda_stream:
            break
    for _ in range(31):
        torch.cuda.Stream(cuda)
    b = ServingEngine(graph, params, plan, device=cuda)
    assert (a.graph_pool.capture_stream.cuda_stream
            == b.graph_pool.capture_stream.cuda_stream)
    reqs = _requests(graph, (5, 9, 17, 33, 65, 129, 250), seed=45)
    got, errors = {}, []

    def serve(name, eng):
        try:
            got[name] = [eng.score(r).scores for r in reqs]
        except Exception as e:          # reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=serve, args=(n, e))
               for n, e in (("a", a), ("b", b))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert a.graph_pool.captures > 5 and b.graph_pool.captures > 5
    ref = ServingEngine(graph, params, plan, device=cuda)   # alone
    for r, x, y in zip(reqs, got["a"], got["b"]):
        want = ref.score(r).scores
        np.testing.assert_allclose(x, want, **TOL)
        np.testing.assert_allclose(y, want, **TOL)
    for eng in (a, b, ref):
        eng.close()


def test_capture_survives_a_collection_of_dead_graphs(cuda):
    """Engines are reference cycles: a dropped engine's graphs are freed by
    the cyclic collector, whenever it runs, in whatever thread allocates
    at that moment — here inside another capture, where the engine's last
    holder lets go of it and the collector would run (it runs
    automatically only while enabled). Freeing a graph inside a capture
    calls ``cudaGraphExecDestroy``, which ends the capture; the collector
    is paused for a capture, so the capture completes and the engine goes
    at the next collection."""
    import gc
    import weakref
    from repro_torch.graph.compiled import CompiledRun
    graph, params = _model("din", cuda)
    dead = ServingEngine(graph, params, ServePlan.preset("tpu").evolve(
        batch__hedging=False), device=cuda)
    for r in _requests(graph, (9, 300), seed=46):
        dead.score(r)
    assert dead.graph_pool.captures == 3
    dead.close()
    holder, alive = [dead], weakref.ref(dead)
    del dead

    in_capture = []

    def body(p, feeds):
        if torch.cuda.is_current_stream_capturing():
            holder.clear()            # the engine's cycle is garbage now
            if gc.isenabled():        # what the collector would do here
                gc.collect()
            in_capture.append(alive() is not None)
        return {"y": feeds["x"] * 2.0}

    run = CompiledRun(body, device=cuda)
    out = run({}, {"x": torch.ones(8, device=cuda)})
    torch.testing.assert_close(out["y"], torch.full((8,), 2.0,
                                                    device=cuda))
    assert run.pool.captures == 1 and holder == []
    assert in_capture == [True]       # not collected inside the capture
    gc.collect()                      # the dead engine goes now
    assert alive() is None
