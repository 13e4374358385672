"""Card-only checks of the port's CUDA kernels and engine (jax-free).

Every test here is marked ``gpu`` and skips without a CUDA device; on the
card run ``python -m pytest -m gpu tests/test_torch_gpu.py``. Kernels are
held against their plain PyTorch versions on the same device at fp32
rtol = atol = 2e-4 (tests/test_kernels.py).
"""
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.mari import apply_mari
from repro_torch.data.features import interleaved_spans, make_recsys_feeds
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


def _bf16_case(dev, B, K, N, mode, U=5, seed=0):
    """bf16 x (rows ``stream_ld`` apart, as the serving path writes them)
    and w, the f32 u, gathered indices out of range."""
    x, w, u, idx = _mari_case(dev, B, K, N, mode, U=U, seed=seed, scale=0.05)
    xb = mm.empty_stream(B, K, torch.bfloat16, dev).copy_(x)
    return xb, w.bfloat16(), u, idx


@pytest.mark.parametrize("mode", ["broadcast", "rowwise", "gather"])
def test_mari_matmul_bf16_row_bit_identical_whatever_the_batch(cuda, mode):
    """The bf16 entry's rows are the same bits at B = 64 (64-row tiles, a
    few CTAs) and inside B = 4096 (128-row tiles, every SM), whatever x's
    row stride: K's chunks and their order are fixed by K alone, and there
    is one route."""
    x, w, u, idx = _bf16_case(cuda, 4096, 1064, 512, mode, U=8)
    pw = mm.prepare_mari_weight(w)
    assert mm.ops.tile_config(64, 512)[0] != mm.ops.tile_config(4096, 512)[0]
    full = mm.mari_matmul(x, pw, u, idx, "relu")
    rows = slice(1000, 1064)
    part = mm.mari_matmul(
        x[rows].contiguous(), pw, u[rows].contiguous() if mode == "rowwise"
        else u, None if idx is None else idx[rows].contiguous(), "relu")
    assert torch.equal(full[rows], part)
    packed = mm.mari_matmul(x.contiguous(), pw, u, idx, "relu")   # ld 1064
    assert torch.equal(full, packed)


@pytest.mark.parametrize("B", [1, 37, 512])
@pytest.mark.parametrize("N", [4, 65, 512])
@pytest.mark.parametrize("K", [8, 40, 333, 1064])
def test_mari_matmul_bf16_ragged_shapes(cuda, K, N, B):
    """Ragged K (one chunk, a short one, five), N (8- and 128-wide tiles,
    element stores where N % 8 != 0) and B, each init mode, gathered
    indices out of range (clamped): within 2e-2 of the plain version, and
    a contiguous x (rows not on lines) gives the same bits."""
    for mode in ("broadcast", "rowwise", "gather"):
        x, w, u, idx = _bf16_case(cuda, B, K, N, mode, seed=7)
        got = mm.mari_matmul(x, w, u, idx, "silu")
        torch.testing.assert_close(
            got.float(), mm.mari_matmul_plain(x, w, u, idx, "silu").float(),
            rtol=2e-2, atol=2e-2)
        assert torch.equal(got, mm.mari_matmul(x.contiguous(), w, u, idx,
                                               "silu"))


@pytest.mark.parametrize("activation", ["identity", "relu"])
@pytest.mark.parametrize("B", [512, 4096])
@pytest.mark.parametrize("K,N", MARI_PATH_SHAPES)
def test_mari_matmul_bf16_is_the_fp64_oracles_rounding(cuda, K, N, B,
                                                       activation):
    """Each element is the bf16 rounding of an fp64 oracle on the widened
    operands, or one bf16 ulp from it; where the sum cancels, within one
    ulp plus 2 K 2^-24 (|u| + |x| |w|): the chunks' f32 sums against the
    exact ones (``chip_smoke.bf16_vs_widened``)."""
    from repro_torch.nn.layers import ACTIVATIONS
    x, w, u, idx = _bf16_case(cuda, B, K, N, "gather", U=8, seed=B)
    ui = u.index_select(0, idx.long().clamp(0, u.shape[0] - 1))
    oracle = ACTIVATIONS[activation](ui.double() + x.double() @ w.double())
    abs_sums = ui.double().abs() + x.double().abs() @ w.double().abs()
    got = mm.mari_matmul(x, mm.prepare_mari_weight(w), u, idx, activation)
    counts = _chip_smoke().bf16_vs_widened(got, oracle, abs_sums, K)
    assert counts["same_bits"] >= 0.99 * counts["elements"]


def test_mari_matmul_bf16_smem_matches_the_plan(cuda):
    """The kernel's shared memory at every tile is ``bf16_plan``'s."""
    lib = mm.ops._lib()
    for B, N in [(1, 4), (1, 32), (1, 64), (512, 512), (4096, 32),
                 (4096, 64), (4096, 512)]:
        p = mm.ops.bf16_plan(B, N)
        assert lib.mari_bf16_smem_bytes(p.bm, p.bn) == p.smem_bytes


@pytest.fixture(scope="module")
def mari_parent_source():
    """``mari_matmul`` as commit c074909 built it (its source under
    tests/data), built with the checkout's flags."""
    from repro_torch.kernels import turns
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lib = turns.load_source(
        "mari_matmul", pathlib.Path(__file__).parent / "data"
        / "mari_matmul_c074909.cu")
    mm.ops.build.bind(lib, {"mari_matmul_f32":
                            mm.ops._SIGNATURES["mari_matmul_f32"]})
    return lib


@pytest.mark.parametrize("mode", ["broadcast", "rowwise", "gather"])
@pytest.mark.parametrize("B", [4096, 2048])
@pytest.mark.parametrize("K,N", MARI_PATH_SHAPES)
def test_mari_matmul_fp32_is_the_parents_bit_for_bit(
        cuda, mari_parent_source, K, N, B, mode):
    """The fp32 entry kept its arithmetic: at every mari_dense stream,
    init mode and epilogue it gives the bits of commit c074909's source."""
    import ctypes
    x, w, u, idx = _mari_case(cuda, B, K, N, mode)
    x, _ = mm.ops.stream_operand(x)
    pw = mm.prepare_mari_weight(w)
    lib = mari_parent_source
    for act in ACTS:
        want = torch.empty(B, N, device=cuda)
        rc = lib.mari_matmul_f32(
            x.data_ptr(), x.stride(0), ctypes.addressof(pw.maps),
            u.data_ptr(), None if idx is None else idx.data_ptr(),
            want.data_ptr(), B, K, N, u.shape[0],
            mm.ops.INIT_MODES.index(mode), mm.ops.EPILOGUES.index(act),
            mm.ops.tile_config(B, N)[0], pw.bn,
            torch.cuda.current_stream(cuda).cuda_stream)
        mm.ops.build.check(lib, rc, "mari_matmul (c074909)")
        assert torch.equal(mm.mari_matmul(x, pw, u, idx, act), want), act


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


# (order, U, B, L, D, H): runs inside and across row tiles, random order at
# U = 1, 8, 64, short runs (tiles of more than 8 users, read from L2),
# out-of-range indices, B of 1, 301 and 4096, L*H that is no multiple of
# the column tile (L*H = 660), of 8 (660), of 4 (91) or of 2 (63), H no
# multiple of 8 (20, 13, 7), and D past one chunk of d (40: two chunks, the
# sums carried across steps) or odd (19), each on both routes (at most 8
# users a row tile, staged; more, read from L2)
GE_CASES = [("runs", 8, 301, 100, 18, 80), ("runs", 8, 4096, 100, 18, 80),
            ("runs_aligned", 8, 4096, 100, 18, 80),
            ("runs", 64, 4096, 100, 18, 80), ("runs", 3, 130, 33, 18, 20),
            ("random", 1, 301, 100, 18, 80), ("random", 8, 4096, 100, 18, 80),
            ("random", 64, 301, 100, 18, 80),
            ("random", 64, 4096, 100, 18, 80),
            ("clamped", 8, 301, 100, 18, 80), ("clamped", 64, 1, 100, 18, 80),
            ("random", 8, 1, 100, 18, 80), ("random", 11, 301, 33, 18, 20),
            ("random", 5, 77, 7, 18, 13), ("runs", 9, 200, 9, 18, 7),
            ("random", 40, 300, 9, 18, 7),
            ("short_runs", 64, 4096, 100, 18, 80),
            ("short_runs", 9, 301, 33, 18, 20),
            ("short_runs", 64, 200, 9, 18, 7),
            ("runs", 8, 301, 100, 40, 80), ("random", 8, 301, 100, 40, 80),
            ("random", 64, 301, 100, 40, 80), ("runs", 3, 130, 33, 40, 20),
            ("short_runs", 64, 301, 33, 40, 20),
            ("runs", 8, 301, 100, 19, 80), ("random", 8, 301, 100, 19, 80),
            ("random", 64, 301, 100, 19, 80), ("runs", 9, 200, 9, 19, 7),
            ("short_runs", 9, 301, 33, 19, 20)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order,U,B,L,D,H", GE_CASES)
@pytest.mark.parametrize("spec", ge.KERNEL_SPECS)
def test_gather_einsum_kernel_index_orders(cuda, spec, order, U, B, L, D, H,
                                           dtype):
    """Every spec, index order and route, in fp32 within 2e-4 of the plain
    version; in bf16 within 2e-2 of it, ``bd,uldh->blh`` (the bf16 tensor
    cores) held to the fp32 kernel on the widened operands by
    ``chip_smoke.bf16_vs_widened`` (depth D), the other two specs bit for
    bit that result, rounded once."""
    g = _gen(cuda, U * B + L * H + D)
    x, table = _ge_operands(g, spec, B, U, L, D, H)
    x, table = x.to(dtype), table.to(dtype)
    idx = _ge_index(g, order, B, U)
    got = ge.gather_einsum(spec, x, table, idx)
    want = ge.gather_einsum_plain(spec, x, table, idx)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
        return
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    widened = ge.gather_einsum(spec, x.float(), table.float(), idx)
    if spec == "bd,uldh->blh":
        _chip_smoke().bf16_vs_widened(
            got, widened, ge.gather_einsum(spec, x.float().abs(),
                                           table.float().abs(), idx), D)
    else:
        assert torch.equal(got, widened.bfloat16())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order,U", [("random", 8), ("runs", 8),
                                     ("random", 64), ("short_runs", 64)])
@pytest.mark.parametrize("spec", ge.KERNEL_SPECS)
def test_gather_einsum_row_bit_identical_whatever_the_batch(cuda, spec,
                                                            order, U, dtype):
    """A row's result depends on its own x and user alone: a slice of the
    rows (other tiles, other neighbours) gives the same bits, in fp32 and
    in bf16. Over 64 slots a full tile holds more than 8 users (slices read
    from L2) and a short slice fewer (staged in shared memory): both routes
    agree, also where bf16 ``bd,uldh->blh`` runs on the tensor cores."""
    g = _gen(cuda, 7)
    x, table = _ge_operands(g, spec, 301, U, 100, 18, 80)
    x, table = x.to(dtype), table.to(dtype)
    idx = _ge_index(g, order, 301, U)
    full = ge.gather_einsum(spec, x, table, idx)
    for lo, hi in ((117, 203), (0, 1), (250, 301), (250, 255), (64, 70)):
        part = ge.gather_einsum(spec, x[lo:hi].contiguous(), table,
                                idx[lo:hi].contiguous())
        assert torch.equal(full[lo:hi], part)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,shift", [
    (301, 100, 1, 0), (301, 100, 3, 0), (301, 100, 81, 0), (77, 9, 257, 0),
    (77, 9, 256, 0), (1000, 1, 80, 0), (1, 1, 80, 0), (301, 100, 80, 1),
    (301, 100, 80, 2), (130, 7, 84, 0)])
def test_gather_einsum_rows_vec_ragged_shapes(cuda, B, L, H, shift, dtype):
    """``blh,uh->bl`` where its 16-byte loads do not fit: H 1, 3 and 81
    (value by value), 257 and 256 (past the 128 whose table chunks a lane
    keeps in registers), L = 1 (a new user every row), x a view 2 or 4
    bytes off alignment (shift 1 / 2 values, 2 / 4 bytes in bf16 and 4 / 8
    in fp32), H 84 (a last chunk of 4 in fp32): within tolerance of the
    plain version, and bf16 bit for bit the fp32 kernel on the widened
    operands."""
    g = _gen(cuda, B + L + H)
    U = 5
    base = _randn(g, B * L * H + shift).to(dtype)
    x = base[shift:].view(B, L, H)
    table = _randn(g, U, H).to(dtype)
    idx = torch.randint(-2, U + 2, (B,), generator=g, device=cuda,
                        dtype=torch.int32)
    got = ge.gather_einsum("blh,uh->bl", x, table, idx)
    want = ge.gather_einsum_plain("blh,uh->bl", x, table, idx)
    torch.cuda.synchronize()
    tol = TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)
    if dtype == torch.bfloat16:
        assert torch.equal(got, ge.gather_einsum(
            "blh,uh->bl", x.float(), table.float(), idx).bfloat16())
    if shift:     # the same rows aligned: the same bits
        assert torch.equal(got, ge.gather_einsum(
            "blh,uh->bl", x.contiguous().clone(), table, idx))


@pytest.fixture(scope="module")
def ge_parent_source():
    """``gather_einsum`` as commit 5cd8cdc built it (its source under
    tests/data), built with the checkout's flags."""
    from repro_torch.kernels import turns
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lib = turns.load_source(
        "gather_einsum", pathlib.Path(__file__).parent / "data"
        / "gather_einsum_5cd8cdc.cu")
    ge.ops.build.bind(lib, ge.ops._SIGNATURES)
    return lib


def _ge_run(lib, entry, spec, x, table, idx):
    shape = ge.ops.out_shape(spec, x, table, idx)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    dims = list(table.shape[1:]) + [0] * (4 - table.ndim)
    if spec == "blh,uh->bl":
        dims[1] = x.shape[1]
    rc = getattr(lib, entry)(
        ge.KERNEL_SPECS.index(spec), x.data_ptr(), table.data_ptr(),
        idx.data_ptr(), out.data_ptr(), x.shape[0], table.shape[0], *dims,
        torch.cuda.current_stream(x.device).cuda_stream)
    ge.ops.build.check(lib, rc, f"gather_einsum {spec!r} (5cd8cdc)")
    return out


# (order, U, B, L, D, H): both routes of each spec, D of one chunk, of two
# (40) and odd (19)
GE_PARENT_CASES = [
    ("runs", 8, 4096, 100, 18, 80), ("random", 8, 1000, 100, 18, 80),
    ("random", 64, 1000, 100, 18, 80), ("short_runs", 64, 301, 100, 18, 80),
    ("random", 11, 301, 33, 18, 20), ("runs", 9, 200, 9, 18, 7),
    ("clamped", 5, 77, 7, 18, 13), ("runs", 8, 301, 100, 40, 80),
    ("random", 64, 301, 100, 40, 80), ("random", 8, 301, 33, 19, 20),
    ("short_runs", 64, 301, 100, 19, 80)]


@pytest.mark.parametrize("order,U,B,L,D,H", GE_PARENT_CASES)
@pytest.mark.parametrize("spec", ["bd,uldh->blh", "bl,uld->bd"])
def test_gather_einsum_fp32_is_the_parents_bit_for_bit(
        cuda, ge_parent_source, spec, order, U, B, L, D, H):
    """The fp32 ``bd,uldh->blh`` and ``bl,uld->bd`` kept their arithmetic:
    every index order and both routes give the bits of commit 5cd8cdc's
    source."""
    g = _gen(cuda, U + B + L)
    x, table = _ge_operands(g, spec, B, U, L, D, H)
    idx = _ge_index(g, order, B, U).contiguous()
    want = _ge_run(ge_parent_source, "gather_einsum_f32", spec, x, table,
                   idx)
    assert torch.equal(ge.gather_einsum(spec, x, table, idx), want)


@pytest.mark.parametrize("order,U,B,L,D,H", GE_PARENT_CASES)
def test_gather_einsum_bf16_w_keys_is_the_parents_bf16_entry(
        cuda, ge_parent_source, order, U, B, L, D, H):
    """bf16 ``bl,uld->bd`` now stages keys and weights as bf16 by cp.async
    and widens them where the FMAs read them: still the bits of commit
    5cd8cdc's bf16 entry, which widened them into fp32 buffers."""
    spec = "bl,uld->bd"
    g = _gen(cuda, U + B + 3)
    x, table = _ge_operands(g, spec, B, U, L, D, H)
    x, table = x.bfloat16(), table.bfloat16()
    idx = _ge_index(g, order, B, U).contiguous()
    want = _ge_run(ge_parent_source, "gather_einsum_bf16", spec, x, table,
                   idx)
    assert torch.equal(ge.gather_einsum(spec, x, table, idx), want)


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
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        di.dot_interaction(torch.zeros(4, 3, 8, device=cuda,
                                       dtype=torch.float16))
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


@pytest.mark.parametrize("L", [921, 2048, 4000, 10_000])
def test_din_attention_kernel_longest_history(cuda, L):
    """The keys stream through shared memory in chunks of 112 at DIN width
    (an online softmax carries each row across them), so a block's shared
    memory no longer grows with L: 921 keys (one past what a block once
    held), 2048, 4000 and 10,000 hold the plain version, and a row slice
    gives the same bits."""
    lib = da.ops._lib()
    assert lib.din_attention_chunk_keys(18, 80, 40) == 112
    assert (lib.din_attention_smem_bytes(L, 18, 80, 40)
            == lib.din_attention_smem_bytes(112, 18, 80, 40) == 112832)
    args = _din_case(cuda, 64, L, 18, 80, 40, seed=L)
    full = da.din_attention(*args)
    torch.testing.assert_close(full, da.din_attention_plain(*args), **TOL)
    part = da.din_attention(args[0][21:30].contiguous(), *args[1:])
    assert torch.equal(full[21:30], part)


def test_din_attention_kernel_refuses_what_it_cannot_take(cuda):
    """bf16 is taken, mixed dtypes are not; units wider than the register
    tiles raise on CUDA, naming the tiles the library reports (the
    executor never sends them to the plain version); the widest unit
    within the tiles takes 32-key chunks and 10,000 keys."""
    args = _din_case(cuda, 8, 10, 6, 16, 8)
    with pytest.raises(TypeError, match="query bfloat16, keys float32"):
        da.din_attention(args[0].bfloat16(), *args[1:])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        da.din_attention(*(a.half() if a.is_floating_point() else a
                           for a in args))
    lib = da.ops._lib()
    for h1, h2, D in ((200, 8, 6), (16, 65, 6), (16, 8, 65)):
        wide = _din_case(cuda, 8, 10, D, h1, h2)
        assert lib.din_attention_smem_bytes(10, D, h1, h2) == -1
        assert lib.din_attention_chunk_keys(D, h1, h2) == -1
        with pytest.raises(ValueError, match=r"register tiles \(D <= 64, "
                                             r"h1 <= 128, h2 <= 64\)"):
            da.din_attention(*wide)
    assert lib.din_attention_chunk_keys(64, 128, 64) == 32
    assert lib.din_attention_smem_bytes(10_000, 64, 128, 64) <= 232448
    widest = _din_case(cuda, 20, 10_000, 64, 128, 64, seed=2)
    torch.testing.assert_close(da.din_attention(*widest),
                               da.din_attention_plain(*widest), **TOL)
    # DIN at configs/din.py width stages 106832 bytes: two blocks an SM
    assert lib.din_attention_smem_bytes(100, 18, 80, 40) == 106832
    with pytest.raises(ValueError, match="4D -> h1 -> h2 -> 1"):
        da.din_attention(args[0], args[1], args[2], args[3][:-1], *args[4:])


BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _bf16(args):
    return tuple(a.bfloat16() if a.is_floating_point() else a for a in args)


@pytest.mark.parametrize("B,L,D,h1,h2", [(2048, 100, 18, 80, 40),
                                         (64, 921, 18, 80, 40),
                                         (8, 2048, 18, 80, 40),
                                         (300, 37, 33, 128, 64),
                                         (1, 7, 6, 12, 5),
                                         (40, 300, 64, 128, 64)])
def test_din_attention_bf16_kernel_matches_plain(cuda, B, L, D, h1, h2):
    """The bf16 entry on the bf16 tensor cores: bf16 in and out, f32
    inside (k*q rounded to bf16 as the TPU kernel forms it, h1 as two
    bf16 halves in the second layer), within the reference's bf16
    tolerance of the plain version, and of the fp32 kernel on the same
    (widened) values, up to the register tiles' widest unit; a row's
    bits do not depend on B."""
    args = _bf16(_din_case(cuda, B, L, D, h1, h2, seed=B + L))
    before = da.LAUNCHES["bf16"]
    got = da.din_attention(*args)
    torch.cuda.synchronize()
    assert da.LAUNCHES["bf16"] == before + 1 and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(),
                               da.din_attention_plain(*args).float(),
                               **BF16_TOL)
    wide = tuple(a.float() if a.is_floating_point() else a for a in args)
    torch.testing.assert_close(got.float(), da.din_attention(*wide),
                               **BF16_TOL)
    if B > 1:
        part = da.din_attention(args[0][B // 2:].contiguous(), *args[1:])
        assert torch.equal(got[B // 2:], part)


@pytest.fixture(scope="module")
def din_bf16_widened_source():
    """The bf16 entry as commit 38d4546 built it (widened into the 3xTF32
    pipeline, every product kept; its source under tests/data), built
    with the checkout's flags."""
    from repro_torch.kernels import turns
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lib = turns.load_source(
        "din_attention", pathlib.Path(__file__).parent / "data"
        / "din_attention_38d4546.cu")
    build_mod = da.ops.build
    build_mod.bind(lib, {"din_attention_bf16":
                         da.ops._SIGNATURES["din_attention_bf16"]})
    return lib


@pytest.mark.parametrize("B,L,D,h1,h2", [(2048, 100, 18, 80, 40),
                                         (512, 921, 18, 80, 40),
                                         (300, 37, 33, 128, 64),
                                         (20, 3000, 64, 128, 64),
                                         (1, 7, 6, 12, 5)])
def test_din_attention_bf16_tf32_build_is_the_widened_run_bit_for_bit(
        cuda, din_bf16_widened_source, B, L, D, h1, h2):
    """The DIN_ATTENTION_BF16_TF32 build leaves out the products that are
    exact zeros in bf16 (the lo halves of bf16(k*q), W1d and W2): adding
    an exact 0 to an f32 sum changes nothing, so its bf16 entry gives the
    bits of the widened run it replaced (commit 38d4546's source)."""
    args = _bf16(_din_case(cuda, B, L, D, h1, h2, seed=B + L))
    q, keys, mask, *w = args
    mask_i = mask.to(torch.int32)
    want = torch.empty(B, D, dtype=torch.bfloat16, device=cuda)
    lib = din_bf16_widened_source
    rc = lib.din_attention_bf16(
        q.data_ptr(), keys.data_ptr(), mask_i.data_ptr(),
        *(t.data_ptr() for t in w), want.data_ptr(), B, L, D, h1, h2,
        torch.cuda.current_stream(cuda).cuda_stream)
    da.ops.build.check(lib, rc, "din_attention (38d4546)")
    saved = da.ops._lib
    da.ops._lib = lambda: saved(("DIN_ATTENTION_BF16_TF32",))
    try:
        got = da.din_attention(*args)
    finally:
        da.ops._lib = saved
    assert torch.equal(got, want)


def test_din_attention_bf16_layout(cuda):
    """The bf16 instance's shared memory, worked out by hand: at DIN's
    width (L 100, D 18 -> 24 with key rows of 24 bf16, h1 80, h2 40) the
    fragments of W1's four blocks 4 x 3 x 10 x 128 B, W2's 5 x 5 x 256,
    K1 100 x 88 x 4, Q1 8 x 88 x 4, keys 4800 B, queries 384, b1 320, b2
    and w3 160 each, scores 3200, mask 400: 69,200 bytes (106,832 in
    fp32); the widest unit (D 64 -> rows of 72 bf16, h1 128 -> K1 rows of
    136 floats, h2 64) keeps 112-key chunks: 65,536 + 16,384 + 60,928 +
    4352 + 16,128 + 1152 + 512 + 256 + 256 + 3584 + 448 = 169,536."""
    lib = da.ops._lib()
    assert lib.din_attention_bf16_smem_bytes(100, 18, 80, 40) == 69200
    assert lib.din_attention_bf16_chunk_keys(18, 80, 40) == 112
    assert lib.din_attention_bf16_chunk_keys(64, 128, 64) == 112
    assert lib.din_attention_bf16_smem_bytes(10_000, 64, 128, 64) == 169536
    assert lib.din_attention_bf16_smem_bytes(10, 65, 16, 8) == -1


@pytest.mark.parametrize("keep_self", [False, True])
@pytest.mark.parametrize("B,F,D,shift,route", [
    (4096, 27, 128, 0, "tma"), (1000, 5, 16, 0, "cp.async"),
    (130, 7, 33, 0, "sync"), (64, 27, 128, 1, "sync"),
    (1, 27, 16, 0, "cp.async"), (257, 40, 64, 0, "tma"),
    (100, 40, 48, 0, "cp.async")])
def test_dot_interaction_bf16_kernel_matches_plain(cuda, B, F, D, shift,
                                                   route, keep_self):
    """The bf16 entry on the bf16 tensor cores, each copy route (TMA where
    D % 64 == 0; cp.async where D is even and x 4-byte aligned; the
    producer's 2-byte copies for D = 33 and a view 2 bytes in), F = 40
    (three m16 tiles): within 2e-2 of the plain version; against the fp32
    kernel on the widened x, its rounding or one bf16 ulp from it, and
    where a sum cancels within the f32 reordering bound (the order of the
    sums is the mma's, ``chip_smoke.bf16_vs_widened``); a row's bits do
    not depend on B."""
    base = _randn(_gen(cuda, B + F), B * F * D + shift).bfloat16()
    x = base[shift:].view(B, F, D)
    before = di.LAUNCHES["bf16"]
    got = di.dot_interaction(x, keep_self)
    torch.cuda.synchronize()
    assert di.LAUNCHES["bf16"] == before + 1 and got.dtype == torch.bfloat16
    assert di.copy_route(x) == route
    _chip_smoke().bf16_vs_widened(
        got, di.dot_interaction(x.float(), keep_self),
        di.dot_interaction(x.float().abs(), keep_self), D)
    torch.testing.assert_close(got.float(),
                               di.dot_interaction_plain(x, keep_self).float(),
                               **BF16_TOL)
    if B > 1:
        assert torch.equal(di.dot_interaction(x[B // 2:], keep_self),
                           got[B // 2:])


@pytest.mark.parametrize("order", ["random", "runs", "random64"])
@pytest.mark.parametrize("spec", ge.KERNEL_SPECS)
def test_gather_einsum_bf16_kernel_matches_plain(cuda, spec, order):
    """The bf16 entry: each spec, user_index in random order over 8 and 64
    slots (the L2 route) and in runs (the staged route), clamped ids:
    within 2e-2 of the plain version; ``bl,uld->bd`` and ``blh,uh->bl``
    bit for bit the fp32 kernel on the widened operands, rounded once;
    ``bd,uldh->blh`` (bf16 tensor cores, the f32 sums in the mma's order)
    that result's rounding or one bf16 ulp from it, and where a sum
    cancels within the f32 reordering bound (``chip_smoke.bf16_vs_widened``,
    depth D)."""
    g = _gen(cuda, len(spec))
    U = 64 if order == "random64" else 8
    x, table = _ge_operands(g, spec, 301, U, 100, 18, 80)
    x, table = x.bfloat16(), table.bfloat16()
    idx = torch.randint(-3, U + 3, (301,), generator=g, device=cuda,
                        dtype=torch.int32)
    if order == "runs":
        idx = torch.sort(idx).values
    before = ge.LAUNCHES[f"{spec}/bf16"]
    got = ge.gather_einsum(spec, x, table, idx)
    torch.cuda.synchronize()
    assert ge.LAUNCHES[f"{spec}/bf16"] == before + 1
    assert got.dtype == torch.bfloat16
    widened = ge.gather_einsum(spec, x.float(), table.float(), idx)
    if spec == "bd,uldh->blh":
        _chip_smoke().bf16_vs_widened(
            got, widened, ge.gather_einsum(spec, x.float().abs(),
                                           table.float().abs(), idx), 18)
    else:
        assert torch.equal(got, widened.bfloat16())
    torch.testing.assert_close(
        got.float(), ge.gather_einsum_plain(spec, x, table, idx).float(),
        **BF16_TOL)
    with pytest.raises(TypeError, match="x bfloat16, table float32"):
        ge.gather_einsum(spec, x, table.float(), idx)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("V,D,S,H", [(2_564_352, 128, 4096, 100),
                                     (1000, 18, 97, 7), (500, 130, 33, 1)])
def test_embedding_bag_bf16_kernel_matches_plain(cuda, V, D, S, H, combiner):
    """Both bf16 entries (fixed hotness and CSR, fp32 weights or none):
    bit for bit the fp32 kernel on the widened table, rounded once, and
    within 2e-2 of the plain versions (f32 sums, one rounding)."""
    g = _gen(cuda, V + H)
    table = (_randn(g, V, D) * V ** -0.5).bfloat16()
    ids = torch.randint(0, V, (S, H), generator=g, device=cuda,
                        dtype=torch.int32)
    w = torch.rand(S, H, generator=g, device=cuda)
    flat, segs = ids.reshape(-1), torch.arange(S, device=cuda
                                               ).repeat_interleave(H)
    before = (eb.LAUNCHES["fixed/bf16"], eb.LAUNCHES["csr/bf16"])
    for weights in (None, w):
        got = eb.embedding_bag_fixed(table, ids, combiner, weights)
        got_csr = eb.embedding_bag(table, flat, segs, S, combiner,
                                   None if weights is None
                                   else weights.reshape(-1))
        assert got.dtype == got_csr.dtype == torch.bfloat16
        want = eb.embedding_bag_fixed(table.float(), ids, combiner, weights)
        assert torch.equal(got, want.bfloat16())
        assert torch.equal(got_csr, got)
        torch.testing.assert_close(
            got.float(),
            eb.embedding_bag_fixed_plain(table, ids, combiner, weights)
            .float(), **BF16_TOL)
    torch.cuda.synchronize()
    assert (eb.LAUNCHES["fixed/bf16"], eb.LAUNCHES["csr/bf16"]) == (
        before[0] + 2, before[1] + 2)
    with pytest.raises(TypeError, match="float32 weights"):
        eb.embedding_bag_fixed(table, ids, combiner, w.bfloat16())


@pytest.mark.parametrize("arch", ["paper-ranking", "din", "dlrm-mlperf"])
def test_serve_bf16_programs_run_through_the_kernels(cuda, arch):
    """The recsys ``serve_bf16`` program (smoke build) through the kernels
    on the card against the same program with ``use_pallas=False``, at
    the reference's bf16 tolerance, captured and eager; each arch launches
    the bf16 entries on its path (mari_matmul; DIN's unit over batch-1
    keys; DLRM's interaction)."""
    import types

    from repro_torch.data.features import _vocab_for_input
    from repro_torch.kernels import read_launches, reset_launches
    from repro_torch.launch.steps import _recsys_serve

    mod = types.SimpleNamespace(BUILD=get_config(arch).smoke_build(),
                                FAMILY="recsys")
    prog = _recsys_serve(mod, 48, opts=frozenset({"serve_bf16"}))
    params = prog.init(seed=0, device=cuda)
    graph = mod.BUILD()[0]
    g = _gen(cuda, 5)
    feeds = {}
    for name, m in prog.args[1].items():
        if m.dtype.is_floating_point:
            feeds[name] = torch.randn(m.shape, generator=g, device=cuda,
                                      dtype=m.dtype)
        else:
            feeds[name] = torch.randint(
                0, _vocab_for_input(graph, name) or 1000, m.shape,
                generator=g, device=cuda, dtype=m.dtype)
    want = prog.compiled(cuda, use_pallas=False)(params, feeds)
    reset_launches()
    serve = prog.compiled(cuda)
    got = serve(params, feeds)
    out = Executor(serve.graph, "uoi", use_pallas=True, device=cuda).run(
        mm.prepare_mari_params(serve.graph, params), feeds)
    eager = torch.cat([out[o] for o in serve.graph.outputs], dim=-1)
    torch.cuda.synchronize()
    launched = read_launches()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    for x in (got, eager):
        torch.testing.assert_close(x.float(), want.float(), **BF16_TOL)
    assert launched["mari_matmul/bf16"] > 0
    if arch == "din":
        assert launched["din_attention/bf16"] > 0
    if arch == "dlrm-mlperf":
        assert launched["dot_interaction/bf16"] > 0
    assert not any(n for k, n in launched.items() if not k.endswith("bf16"))


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
    """A bag's result does not depend on B; tables other than fp32 and
    bf16 are refused; ``EmbeddingBag`` and ``embedding_bag_lookup`` launch
    the kernel."""
    g = _gen(cuda, 3)
    table = _randn(g, 5000, 128)
    ids = torch.randint(0, 5000, (300, 27), generator=g, device=cuda)
    full = eb.embedding_bag_fixed(table, ids)
    assert torch.equal(full[100:140],
                       eb.embedding_bag_fixed(table, ids[100:140]))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        eb.embedding_bag_fixed(table.half(), ids)
    bag = EmbeddingBag(vocab=5000, dim=128, combiner="mean")
    params = {"table": table}
    flat, segs = ids.reshape(-1), torch.arange(300, device=cuda
                                               ).repeat_interleave(27)
    eb.reset_launches()
    a = bag.apply(params, flat, segs, 300)
    b = bag.apply_dense(params, ids)
    c = embedding_bag_lookup(table, flat, segs, 300, combiner="mean")
    torch.cuda.synchronize()
    assert eb.LAUNCHES == {"csr": 2, "fixed": 1, "csr/bf16": 0,
                           "fixed/bf16": 0}
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


# -- distributed serving: a one-rank NCCL group ------------------------------

@pytest.fixture
def one_rank_nccl(cuda):
    """A one-rank NCCL group in this process (no coordinator), left at the
    end of the test."""
    from repro_torch.dist.topology import Topology
    topo = Topology()
    assert topo.backend(cuda) == "nccl"
    topo.initialize(cuda, timeout_s=120)
    yield cuda
    Topology.shutdown()


def test_one_rank_nccl_engine_matches_local(one_rank_nccl):
    dev = one_rank_nccl
    graph, _ = build_paper_ranking_model(PaperRankingConfig().scaled(0.25))
    params = init_graph_params(graph, seed=0, device=dev)
    rng = np.random.default_rng(0)
    reqs = []
    for u, n in enumerate((300, 1700, 2900)):
        feeds = make_recsys_feeds(graph, n, rng)
        user = {k: v for k, v in feeds.items() if v.shape[0] == 1}
        reqs.append(ServeRequest(u, user, {k: v for k, v in feeds.items()
                                           if k not in user}))
    tpu = ServePlan.preset("tpu").evolve(batch__hedging=False)
    local = ServingEngine(graph, params, tpu, device=dev)
    want = [r.scores for r in local.score_coalesced(reqs)]
    sharded = ServingEngine(graph, params,
                            tpu.evolve(shard__shard_candidates=True),
                            device=dev)
    assert sharded._collective and sharded._n_shards == 1
    mm.reset_launches()
    got = sharded.score_coalesced(reqs)
    torch.cuda.synchronize()
    assert mm.LAUNCHES["gather"] > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.scores, w, **TOL)
    prof = sharded.profiler.snapshot()
    assert prof["gather"]["calls"] == sharded.stage2_calls > 0
    # a second pass replays: no new graph, the gather stays outside it
    graphs = sharded.stage2_compilations
    again = sharded.score_coalesced(reqs)
    assert sharded.stage2_compilations == graphs
    for g, w in zip(again, want):
        np.testing.assert_allclose(g.scores, w, **TOL)
    int8 = ServingEngine(graph, params, tpu.evolve(
        shard__shard_candidates=True, shard__compress_scores=True),
        device=dev)
    tol = max(float(np.abs(w).max()) for w in want) / 127.0 / 2.0 + 1e-6
    for g, w in zip(int8.score_coalesced(reqs), want):
        np.testing.assert_allclose(g.scores, w, atol=tol)
    for eng in (local, sharded, int8):
        eng.close()


def test_int8_gather_bound_on_cuda_tensors(one_rank_nccl):
    from repro_torch.dist.compress import (compressed_all_gather,
                                           compressed_psum, dequantize_int8,
                                           quantize_int8)
    from repro_torch.dist.sharding import gather_rows
    dev = one_rank_nccl
    g = _gen(dev, 3)
    x = _randn(g, 4096, 2) * 3
    q, s = quantize_int8(x)
    qc, sc = quantize_int8(x.cpu())
    assert q.is_cuda and torch.equal(q.cpu(), qc)
    assert abs(s.item() - sc.item()) <= np.spacing(np.float32(sc.item()))
    got = compressed_all_gather(x)
    assert got.is_cuda and got.shape == x.shape
    assert float((got - x).abs().max()) <= s.item() / 2 + 1e-6
    torch.testing.assert_close(got, dequantize_int8(q, s))
    assert torch.equal(gather_rows(x), x)
    mean, err = compressed_psum({"x": x})
    torch.testing.assert_close(mean["x"] + err["x"], x, rtol=0, atol=1e-6)
    torch.testing.assert_close(mean["x"], dequantize_int8(q, s))


# -- distributed serving: two gloo ranks on one card -------------------------

GLOO_CUDA_WORKER = r'''
import sys
import torch
import torch.distributed as dist
from repro_torch.dist.compress import compressed_all_gather, compressed_psum
from repro_torch.dist.sharding import gather_rows
from repro_torch.dist.topology import Topology

topo = Topology.from_env()
dev = topo.device("cuda")
topo.initialize(dev, timeout_s=120)
assert dist.get_backend() == "gloo", dist.get_backend()
rank = topo.process_id
x = torch.full((3, 2), float(rank + 1), device=dev)
r = x.clone()
dist.all_reduce(r)
b = x.clone()
dist.broadcast(b, src=0)
parts = [torch.empty_like(x) for _ in range(2)]
dist.all_gather(parts, x)
flat = torch.empty((6, 2), device=dev)
dist.all_gather_into_tensor(flat, x)
rows = gather_rows(x)
q = compressed_all_gather(x)
mean, err = compressed_psum({"x": x})
torch.cuda.synchronize(dev)
want = torch.cat([torch.full((3, 2), 1.0), torch.full((3, 2), 2.0)])
assert torch.equal(r.cpu(), torch.full((3, 2), 3.0))
assert torch.equal(b.cpu(), torch.ones(3, 2))
assert torch.equal(torch.cat(parts).cpu(), want)
assert torch.equal(flat.cpu(), want)
assert rows.is_cuda and torch.equal(rows.cpu(), want)
assert q.is_cuda and torch.allclose(q.cpu(), want)
# one scale, 2 / 127: codes 64 (63.5 rounded half to even) and 127
assert mean["x"].is_cuda and torch.allclose(mean["x"].cpu(),
                                            torch.full((3, 2), 191 / 127))
Topology.shutdown()
print("ok", rank)
'''


def test_gloo_takes_cuda_tensors_in_the_gathers(cuda, tmp_path):
    """Two gloo ranks on the one card: every collective the serving path
    calls (and broadcast) takes CUDA tensors, so ``gather_rows`` and the
    int8 collectives hand their results back on the card."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = str(Path(__file__).resolve().parents[1] / "src")
    script = tmp_path / "worker.py"
    script.write_text(GLOO_CUDA_WORKER)
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=src + os.pathsep
                   + os.environ.get("PYTHONPATH", ""),
                   REPRO_NUM_PROCESSES="2", REPRO_PROCESS_ID=str(rank),
                   REPRO_COORDINATOR=f"file://{tmp_path}/rendezvous")
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=150)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"ok {rank}" in out, out[-3000:]


# -- slice 11: the reorganized path, Table 2's columns, fx-GCA on CUDA ---------

def _interleaved_graph(d_user=400, d_item=100, chunk=50):
    """User / item chunks alternating (bench_table3's layout), one concat
    that also feeds a non-matmul consumer, dense(64, relu), dense(1)."""
    b = GraphBuilder()
    names = [b.input(f"{dom}_{k}", (w,), dom) for k, (dom, _, w)
             in enumerate(interleaved_spans(d_user, d_item, chunk))]
    c = b.concat("fusion", names)
    h = b.dense("fc", c, 64, activation="relu")
    side = b.dense("side_out", b.act("side", c, "relu"), 1)
    b.output(b.dense("logit", h, 1), side)
    return b.graph


def test_reorganized_tpu_engine_matches_plain_twin(cuda):
    from repro_torch.core import convert_params_reorg, reorganize
    graph = _interleaved_graph()
    params = init_graph_params(graph, seed=0, device=cuda)
    g2, plans = reorganize(graph)
    assert plans[0].restored_consumers == ("side",)
    p2 = convert_params_reorg(plans, params)
    tpu = ServePlan.preset("tpu").evolve(batch__hedging=False,
                                         batch__max_batch=512)
    eng = ServingEngine(g2, p2, tpu, device=cuda)
    twin = ServingEngine(g2, p2, tpu.evolve(kernel__use_pallas=False,
                                            kernel__kernel_gather=False),
                         device=cuda)
    rng = np.random.default_rng(3)
    reqs = []
    for uid, n in enumerate((37, 700, 1200)):
        f = make_recsys_feeds(graph, n, rng)
        reqs.append(ServeRequest(
            user_id=uid,
            user_feeds={k: v for k, v in f.items() if k.startswith("user")},
            candidate_feeds={k: v for k, v in f.items()
                             if k.startswith("item")}))
    mm.reset_launches()
    per = [eng.score(r) for r in reqs]
    co = eng.score_coalesced(reqs)
    torch.cuda.synchronize()
    assert mm.LAUNCHES["gather"] > 0 and sum(mm.PREPARES.values()) == 0
    for r, p, c in zip(reqs, per, co):
        want = twin.score(r).scores
        assert p.scores.shape == want.shape == (want.shape[0], 2)
        np.testing.assert_allclose(p.scores, want, **TOL)
        np.testing.assert_allclose(c.scores, want, **TOL)
    eng.close()
    twin.close()


@pytest.mark.parametrize("kw", [dict(graph__fragment=True), {}],
                         ids=["fragment", "neat"])
def test_single_stage_tpu_engine_matches_plain_twin(cuda, kw):
    """A single-stage ``tpu`` engine (user features row-wise in each pack)
    over the interleaved layout: its prepared stream goes through the
    kernel with the row-wise user products as the init block, and the
    scores match the use_pallas=False twin."""
    graph = _interleaved_graph()
    params = init_graph_params(graph, seed=1, device=cuda)
    tpu = ServePlan.preset("tpu").evolve(
        batch__hedging=False, batch__max_batch=512, graph__two_stage=False,
        **kw)
    eng = ServingEngine(graph, params, tpu, device=cuda)
    twin = ServingEngine(graph, params, tpu.evolve(
        kernel__use_pallas=False, kernel__kernel_gather=False), device=cuda)
    assert not eng.two_stage and "w_prep" in eng.params["fc"]
    rng = np.random.default_rng(4)
    reqs = []
    for uid, n in enumerate((37, 700)):
        f = make_recsys_feeds(graph, n, rng)
        reqs.append(ServeRequest(
            user_id=uid,
            user_feeds={k: v for k, v in f.items() if k.startswith("user")},
            candidate_feeds={k: v for k, v in f.items()
                             if k.startswith("item")}))
    mm.reset_launches()
    got = [eng.score(r).scores for r in reqs]
    torch.cuda.synchronize()
    assert mm.LAUNCHES["rowwise"] > 0 and sum(mm.PREPARES.values()) == 0
    for r, g in zip(reqs, got):
        np.testing.assert_allclose(g, twin.score(r).scores, **TOL)
    eng.close()
    twin.close()


@pytest.mark.parametrize("B,Du,Dr,d", [(100, 4000, 2000, 512),
                                       (300, 400, 150, 64),
                                       (2000, 500, 1000, 128)])
def test_table2_kernel_columns_match_their_plain_versions(cuda, B, Du, Dr,
                                                          d):
    """Table 2's kernel columns: the broadcast entry on the tiled input with
    a zero init row (kernel vanilla) against ``torch.addmm``, and on x_rest
    with u = x_u W_u (kernel MaRI) against the plain ``matmul_mari``."""
    from repro_torch.core.mari import matmul_mari
    g = _gen(cuda, B + Du)
    xu, xr = _randn(g, 1, Du), _randn(g, B, Dr)
    wu, wr = _randn(g, Du, d), _randn(g, Dr, d)
    x_tiled = torch.cat([xu.expand(B, Du), xr], -1)
    w = torch.cat([wu, wr], 0)
    zero = torch.zeros(1, d, device=cuda)
    got = mm.mari_matmul(x_tiled, mm.prepare_mari_weight(w), zero)
    torch.testing.assert_close(got, torch.addmm(zero, x_tiled, w), **TOL)
    got = mm.mari_matmul(xr, mm.prepare_mari_weight(wr), xu @ wu)
    torch.testing.assert_close(got, matmul_mari(xu, xr, wu, wr), **TOL)


def test_detect_in_fx_same_report_on_cuda_and_cpu(cuda):
    from repro_torch.core import detect_in_fx
    from repro_torch.examples.gca_demo import my_model
    shapes = {"wu": (32, 16), "w1": (48, 64), "w2": (64, 1)}
    doms = {"user_vec": "user", "item_vec": "item"}
    reports = []
    for dev in (torch.device("cpu"), cuda):
        params = {k: torch.zeros(s, device=dev) for k, s in shapes.items()}
        feeds = {"user_vec": torch.zeros(1, 32, device=dev),
                 "item_vec": torch.zeros(100, 32, device=dev)}
        reports.append(detect_in_fx(my_model, doms, params, feeds))
    graph, _ = build_paper_ranking_model(PaperRankingConfig().scaled(0.05))
    pdoms = {f"['{n.name}']": n.attrs["domain"] for n in graph.input_nodes()}
    feeds = make_recsys_feeds(graph, 16, np.random.default_rng(0))
    for dev in (torch.device("cpu"), cuda):
        params = init_graph_params(graph, seed=0, device=dev)
        reports.append(detect_in_fx(
            Executor(graph, "vani", device=dev).run, pdoms, params,
            {k: torch.as_tensor(v, device=dev) for k, v in feeds.items()}))
    assert reports[0] == reports[1] and len(reports[0].eligible) == 1
    assert reports[2] == reports[3] and len(reports[2].eligible) == 9


# -- the LM family's serving path --------------------------------------------

LM_ARCHS = ("mixtral-8x7b", "granite-moe-3b-a800m", "deepseek-67b",
            "qwen3-14b", "yi-9b")
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _chip_smoke():
    """chip_smoke.py as a module (its phase-10 oracles; importing it runs
    nothing)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lm_smoke(arch, dtype="float32"):
    import dataclasses
    return dataclasses.replace(get_config(arch).smoke_config(), dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mixtral-8x7b"])
def test_lm_decode_captured_matches_eager(cuda, arch, dtype):
    """One graph captured for the decode step (tokens and pos fed, the
    cache by address) replays at every position, across the ring's wrap
    for Mixtral's window, and equals the eager step from the same cache."""
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    cfg = _lm_smoke(arch, dtype)
    params = tfm.init_lm_params(cfg, seed=0, device=cuda)
    cache = tfm.init_kv_cache(cfg, 2, 128, device=cuda)
    g = _gen(cuda, 1)
    for t in cache.values():
        t.copy_(torch.randn(t.shape, generator=g, device=cuda))
    positions = list(range(58, 70))
    toks = torch.randint(0, cfg.vocab, (2, len(positions)), generator=g,
                         device=cuda, dtype=torch.int32)
    slots = torch.tensor(positions, device=cuda) % cache["k"].shape[2]
    saved = {n: t[:, :, slots].clone() for n, t in cache.items()}
    decode = steps._lm_decode(cfg, 128, 2).compiled(cuda)
    got = [decode(params, cache, toks[:, i:i + 1],
                  torch.tensor(p, dtype=torch.int32, device=cuda))[0]
           for i, p in enumerate(positions)]
    for n, t in cache.items():
        t[:, :, slots] = saved[n]
    with torch.inference_mode():
        want = [tfm.lm_decode_step(params, cfg, cache, toks[:, i:i + 1],
                                   torch.tensor(p, dtype=torch.int32,
                                                device=cuda))[0]
                for i, p in enumerate(positions)]
    assert decode.compilations == 1
    tol = TOL if dtype == "float32" else BF16_TOL
    torch.testing.assert_close(torch.stack(got), torch.stack(want), **tol)


def test_lm_decode_step_reads_nothing_back(cuda):
    """No host synchronisation anywhere on the decode path (what a
    capture needs), MoE dispatch included."""
    from repro_torch.models import transformer as tfm
    cfg = _lm_smoke("granite-moe-3b-a800m")
    params = tfm.init_lm_params(cfg, seed=0, device=cuda)
    cache = tfm.init_kv_cache(cfg, 2, 32, device=cuda)
    tok = torch.zeros((2, 1), dtype=torch.int32, device=cuda)
    pos = torch.tensor(5, dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            tfm.lm_decode_step(params, cfg, cache, tok, pos)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_logits_on_the_card_match_the_cpu(cuda, arch):
    from repro_torch.common import tree_map
    from repro_torch.models import transformer as tfm
    cfg = _lm_smoke(arch)
    params = tfm.init_lm_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator()
                         .manual_seed(1), dtype=torch.int32)
    with torch.inference_mode():
        want = tfm.lm_logits(params, cfg, toks)
        got = tfm.lm_logits(tree_map(lambda t: t.to(cuda), params), cfg,
                            toks.to(cuda))
    torch.testing.assert_close(got.cpu(), want, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,window", [(4, 4, None), (8, 2, 16),
                                           (6, 2, None)])
def test_flash_attention_on_the_card_matches_naive(cuda, hq, hkv, window,
                                                   dtype):
    from repro_torch.models.transformer import flash_attention
    naive = _chip_smoke().naive_attention
    g = _gen(cuda, hq + hkv)
    S, hd = 64, 32
    q = torch.randn((2, S, hq, hd), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((2, S, hkv, hd), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    pos = torch.arange(S, dtype=torch.int32, device=cuda)[None].expand(2, S)
    got = flash_attention(q, k, v, pos, pos, window=window, q_chunk=16,
                          kv_chunk=32)
    want = naive(q, k, v, pos, pos, window)
    tol = TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_on_the_card_matches_the_loop_oracle(cuda, dtype):
    import dataclasses
    from repro_torch.models import transformer as tfm
    oracle = _chip_smoke().moe_loop_oracle
    cfg = dataclasses.replace(_lm_smoke("granite-moe-3b-a800m", dtype),
                              moe_experts=8, moe_top_k=4)
    ffn = {n: w[0] for n, w in tfm.init_lm_params(
        cfg, seed=2, device=cuda)["layers"]["ffn"].items()}
    g = _gen(cuda, 3)
    x = (torch.randn((96, cfg.d_model), generator=g, device=cuda)
         + 2 * torch.randn((cfg.d_model,), generator=g, device=cuda)
         ).to(cfg.torch_dtype)
    with torch.inference_mode():
        got = tfm.moe_ffn(x, ffn, cfg)
    want, dropped = oracle(x, ffn, cfg)
    assert dropped > 0
    tol = TOL if dtype == "float32" else BF16_TOL
    torch.testing.assert_close(got.float(), want, **tol)


def test_moe_ffn_is_deterministic_on_the_card(cuda):
    """Same inputs, same bits: the combine sums each token's k choices in
    order (atomics would not), so a captured decode step and an eager one
    route every later layer alike."""
    import dataclasses
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(_lm_smoke("granite-moe-3b-a800m", "bfloat16"),
                              moe_experts=16, moe_top_k=8)
    ffn = {n: w[0] for n, w in tfm.init_lm_params(
        cfg, seed=4, device=cuda)["layers"]["ffn"].items()}
    x = torch.randn((512, cfg.d_model), generator=_gen(cuda, 5),
                    device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        runs = [tfm.moe_ffn(x, ffn, cfg) for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])


# -- captured training steps ----------------------------------------------------

def _clone_tree(tree):
    from repro_torch.common import tree_map
    return tree_map(torch.clone, tree)


def _assert_states_close(a, b, tol=TOL):
    from repro_torch.common import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        torch.testing.assert_close(x.float(), y.float(), **tol)


def _din_train_setup(cuda, bsz=48):
    """The smoke DIN with Adam, its captured step and 6 batches."""
    from repro_torch.launch.train import recsys_step
    from repro_torch.train.optim import adam
    from repro_torch.data.features import make_labels
    graph, *_ = get_config("din").smoke_build()()
    ex = Executor(graph, "vani", device=cuda)
    opt = adam(1e-2)
    params = init_graph_params(graph, seed=0, device=cuda)
    state = {"params": params, "opt": opt.init(params)}
    rng = np.random.default_rng(7)
    batches = [(make_recsys_feeds(graph, bsz, rng, tile_user=True),
                torch.as_tensor(make_labels(bsz, rng, 1), device=cuda))
               for _ in range(6)]
    return recsys_step(ex, list(graph.outputs), opt), state, \
        batches


def test_captured_train_step_matches_eager_din(cuda):
    """The DIN step behind one graph: the same states as the eager body
    from the same state and batches, one optimizer step per call (the
    first call's warm-up is its step), one graph."""
    step, state, batches = _din_train_setup(cuda)
    twin = _clone_tree(state)
    for i, b in enumerate(batches):
        out, m = step(state, b)
        assert out is state
        assert int(state["opt"]["step"]) == i + 1
        _, me = step.eager(twin, b)
        torch.testing.assert_close(m["loss"], me["loss"], **TOL)
    assert step.compilations == 1
    _assert_states_close(state, twin)


def test_captured_train_step_matches_eager_lm(cuda):
    """A 2-layer granite (remat on, so the capture records the
    checkpointed recompute; fp32) through ``_lm_train``'s compiled step
    against its eager ``step_fn``."""
    import dataclasses
    from repro_torch.data.lm import token_batch
    from repro_torch.launch import steps
    cfg = dataclasses.replace(_lm_smoke("granite-moe-3b-a800m"), n_layers=2,
                              remat=True)
    prog = steps._lm_train(cfg, 32, 4)
    state = prog.init(seed=3, device=cuda)
    twin = _clone_tree(state)
    step = prog.compiled(cuda)
    g = _gen(cuda, 9)
    for i in range(4):
        batch = token_batch(g, 4, 32, cfg.vocab)
        _, m = step(state, batch)
        _, me = prog.step_fn(twin, batch)
        torch.testing.assert_close(m["loss"], me["loss"], **TOL)
        assert int(state["opt"]["step"]) == i + 1
    assert step.compilations == 1
    _assert_states_close(state, twin)


def test_captured_step_one_graph_across_a_restore(cuda, tmp_path):
    """A crash after a checkpoint and a resume through ``train_loop``: the
    restored state (new tensors) is copied into the captured state, so
    one graph serves both runs, and the step count is the loop's."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.train.loop import LoopConfig, train_loop
    step, state0, batches = _din_train_setup(cuda)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    cfg = LoopConfig(total_steps=12, ckpt_every=4, log_every=100)
    with pytest.raises(RuntimeError, match="injected failure"):
        train_loop(step, state0, iter(batches * 2), mgr, cfg, fail_at=6,
                   log=lambda *_: None)
    assert mgr.latest_step() == 4 and step.compilations == 1
    logs = []
    state, _ = train_loop(step, state0, iter(batches * 2), mgr, cfg,
                          log=logs.append)
    assert logs[0] == "[loop] resumed from step 4"
    assert state is step.state and step.compilations == 1
    assert int(state["opt"]["step"]) == 12


@pytest.mark.parametrize("master", [False, True])
def test_inplace_update_extra_peak_within_two_leaves(cuda, master):
    """The in-place AdamW's own allocations stay within 2 x the largest
    leaf's f32 size, as the caching allocator sizes a block (rounded up to
    2 MiB; the step's scalars take 512-byte blocks): it walks leaves in
    slices and reuses the f32 gradient's memory. It reads nothing back."""
    from repro_torch.common import tree_map
    from repro_torch.train import optim
    g = _gen(cuda, 11)
    dt = torch.bfloat16 if master else torch.float32
    params = {"big": _randn(g, 3000, 2048).to(dt),
              "small": {"w": _randn(g, 64, 32).to(dt),
                        "b": _randn(g, 32).to(dt)}}
    opt = optim.adamw(1e-3, master_weights=master)
    state = opt.init(params)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=g,
                                           device=cuda).to(p.dtype), params)
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        opt.update_(grads, state, params)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(cuda) - live
    block = -(-3000 * 2048 * 4 // (2 << 20)) * (2 << 20)
    assert extra <= 2 * block + 64 * 512
    assert int(state["step"]) == 1


# -- SchNet: the GNN family's training cells ------------------------------

# small shape specs of the three regimes (``_gnn_train`` pads edges to 1024)
SMALL_GNN_SPECS = {
    "full": {"kind": "train", "n_nodes": 50, "n_edges": 300, "d_feat": 12,
             "n_classes": 6, "mode": "full"},
    "sampled": {"kind": "train", "n_nodes": 120, "n_edges": 700,
                "d_feat": 10, "n_classes": 5, "mode": "sampled",
                "batch_nodes": 8, "fanout": (4, 3)},
    "molecule": {"kind": "train", "n_nodes": 10, "n_edges": 20, "batch": 4,
                 "mode": "molecule"},
}


def small_gnn_batch(spec, n_edges, seed):
    """One numpy batch of a small GNN shape spec, its edges padded to
    ``n_edges`` (jax-free: tests/test_torch_schnet.py takes it too)."""
    from repro_torch.data import sampler
    mode = spec["mode"]
    if mode == "molecule":
        return sampler.pad_edges(sampler.batched_molecules(
            spec["batch"], spec["n_nodes"], spec["n_edges"], seed), n_edges)
    g = sampler.random_graph(spec["n_nodes"], spec["n_edges"],
                             spec["d_feat"], seed, spec["n_classes"])
    if mode == "full":
        return sampler.pad_edges(g, n_edges)
    s = sampler.NeighborSampler(g["senders"], g["receivers"],
                                spec["n_nodes"], spec["fanout"])
    rng = np.random.default_rng(seed)
    seeds = rng.choice(spec["n_nodes"], spec["batch_nodes"], replace=False)
    return sampler.pad_edges(sampler.sampled_batch(g, s.sample(seeds, rng)),
                             n_edges)


def _schnet_cell(mode, dev, n_batches=4):
    """``_gnn_train`` over the smoke config and a small spec: the program,
    a state on ``dev`` and ``n_batches`` batches on ``dev``."""
    from repro_torch.launch import steps
    prog = steps._gnn_train(get_config("schnet").smoke_config(),
                            SMALL_GNN_SPECS[mode])
    n_edges = prog.args[1]["senders"].shape[0]
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                small_gnn_batch(SMALL_GNN_SPECS[mode], n_edges, 40 + i
                                ).items()} for i in range(n_batches)]
    return prog, prog.init(seed=2, device=dev), batches


@pytest.mark.parametrize("mode", ["full", "sampled", "molecule"])
def test_schnet_captured_step_matches_eager(cuda, mode):
    """The GNN step behind one captured graph against the eager
    ``step_fn`` from the same state and batches: losses and states at
    TOL, one optimizer step per call, one graph."""
    prog, state, batches = _schnet_cell(mode, cuda)
    twin = _clone_tree(state)
    step = prog.compiled(cuda)
    for i, b in enumerate(batches):
        _, m = step(state, b)
        _, me = prog.step_fn(twin, b)
        torch.testing.assert_close(m["loss"], me["loss"], **TOL)
        assert int(state["opt"]["step"]) == i + 1
    assert step.compilations == 1
    _assert_states_close(state, twin)


@pytest.mark.parametrize("mode", ["full", "sampled", "molecule"])
def test_schnet_step_repeats_bit_for_bit_on_the_card(cuda, mode):
    """Two eager steps from one saved state give the same loss and state
    bit for bit: the gathers' backward and the segment sums reduce in a
    fixed order (no fp32 atomics)."""
    prog, state, batches = _schnet_cell(mode, cuda, n_batches=1)
    runs = []
    for _ in range(2):
        s = _clone_tree(state)
        _, m = prog.step_fn(s, batches[0])
        runs.append((m["loss"], s))
    from repro_torch.common import tree_leaves
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(tree_leaves(runs[0][1]), tree_leaves(runs[1][1])):
        assert torch.equal(a, b)


def test_schnet_scatter_and_gather_repeat_bit_for_bit(cuda):
    """``segment_sum`` of 200,000 rows into 37 segments (heavy
    duplication, ids out of range among them) and the backward of
    ``take_rows`` over as many indices repeat bit for bit, and match the
    CPU within TOL."""
    from repro_torch.models import schnet as ts
    g = _gen(cuda, 21)
    data = _randn(g, 200_000, 64)
    ids = torch.randint(-3, 40, (200_000,), generator=g, device=cuda,
                        dtype=torch.int32)
    outs = [ts.segment_sum(data, ids, 37) for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    torch.testing.assert_close(outs[0].cpu(), ts.segment_sum(
        data.cpu(), ids.cpu(), 37), **TOL)
    grads = []
    for _ in range(2):
        x = _randn(_gen(cuda, 5), 37, 64).requires_grad_(True)
        (ts.take_rows(x, ids) * data).sum().backward()
        grads.append(x.grad)
    assert torch.equal(grads[0], grads[1])


def test_schnet_padded_edges_change_nothing(cuda):
    """The full regime's graph with its 300 edges as they are, and padded
    to 1024 with ``edge_mask`` False: the same loss and gradients at
    TOL."""
    import dataclasses
    from repro_torch.common import value_and_grad
    from repro_torch.data import sampler
    from repro_torch.models import schnet as ts
    from repro_torch.train.losses import softmax_xent
    spec = SMALL_GNN_SPECS["full"]
    cfg = dataclasses.replace(get_config("schnet").smoke_config(),
                              d_feat=spec["d_feat"], n_out=spec["n_classes"])
    params = ts.init_schnet_params(cfg, seed=4, device=cuda)
    g = sampler.random_graph(50, 300, spec["d_feat"], 3, spec["n_classes"])
    outs = []
    for b in (sampler.pad_edges(g, 300), sampler.pad_edges(g, 1024)):
        t = {k: torch.as_tensor(v, device=cuda) for k, v in b.items()}
        outs.append(value_and_grad(lambda p: softmax_xent(ts.schnet_forward(
            p, cfg, t["features"], t["positions"], t["senders"],
            t["receivers"], t["edge_mask"]), t["labels"]), params))
    torch.testing.assert_close(outs[0][0], outs[1][0], **TOL)
    _assert_states_close(outs[0][1], outs[1][1])


@pytest.mark.parametrize("mode", ["full", "molecule"])
def test_schnet_on_the_card_matches_the_cpu(cuda, mode):
    """One eager step on the card and on the CPU from the same state and
    batch, out-of-range ids among the edges and atom types (dropped,
    clamped, NaN-filled as the reference does; no device assert): the
    loss and the state at TOL, NaN where the CPU has NaN."""
    from repro_torch.common import tree_map
    prog, state, batches = _schnet_cell(mode, cuda, n_batches=1)
    b = dict(batches[0])
    b["senders"] = b["senders"].clone()
    b["receivers"] = b["receivers"].clone()
    b["senders"][:3] = torch.tensor([-1, 10_000, -10_000], device=cuda)
    b["receivers"][3:6] = torch.tensor([-1, 10_000, 7], device=cuda)
    cpu_state = tree_map(lambda t: t.to("cpu", copy=True), state)
    _, m = prog.step_fn(state, b)
    _, mc = prog.step_fn(cpu_state, {k: v.cpu() for k, v in b.items()})
    torch.testing.assert_close(m["loss"].cpu(), mc["loss"], **TOL)
    _assert_states_close(tree_map(lambda t: t.cpu(), state), cpu_state)
    if mode == "molecule":
        from repro_torch.models import schnet as ts
        at = b["atom_types"].clone()
        at[:2] = torch.tensor([-1, 1000], device=cuda)
        p = prog.init(seed=3, device=cuda)["params"]
        cfg = get_config("schnet").smoke_config().scaled_down(d_feat=0,
                                                              n_out=1)
        got = ts.schnet_forward(p, cfg, at, b["positions"], b["senders"],
                                b["receivers"], b["edge_mask"]).cpu()
        want = ts.schnet_forward(tree_map(lambda t: t.cpu(), p), cfg,
                                 at.cpu(), b["positions"].cpu(),
                                 b["senders"].cpu(), b["receivers"].cpu(),
                                 b["edge_mask"].cpu())
        assert torch.equal(got.isnan(), want.isnan()) and got.isnan().any()
        torch.testing.assert_close(got, want, equal_nan=True, **TOL)
