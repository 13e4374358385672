"""The bf16 entries of the port's kernels, and ``din_attention`` at any
history length, on the CPU.

Each kernel wrapper on CPU tensors runs its plain PyTorch version; in bf16
those are held against the reference's Pallas kernels run in interpret
mode on the same bf16 inputs (numpy draws rounded to bf16 once, by both
packages). Tolerance: the reference's bf16 rtol = atol = 2e-2
(tests/test_kernels.py). The TPU kernels take bf16 in, accumulate in f32
and write bf16 (``embedding_bag``'s accumulates in bf16, a row at a
time); the port's plain versions accumulate in f32 and round once.

Also here: ``din_attention``'s plain version at 2000 keys in fp32 (2e-4),
the executor sending a DIN unit to ``din_attention`` whatever its
history length, the wrappers' one-dtype rule, and the ``ctypes``
signatures of every wrapper against the C entry points of its source.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gather_einsum as jax_gather_einsum
from repro.kernels.din_attention import din_attention as jax_din_attention
from repro.kernels.din_attention.ref import din_attention_ref
from repro.kernels.dot_interaction import dot_interaction as jax_dot
from repro.kernels.embedding_bag import embedding_bag as jax_embedding_bag
from repro_torch.kernels import build
from repro_torch.kernels import din_attention as da
from repro_torch.kernels import dot_interaction as di
from repro_torch.kernels import embedding_bag as eb
from repro_torch.kernels import gather_einsum as ge
from repro_torch.kernels import mari_matmul as mm

TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _bf16(*arrays):
    """(jax bf16 arrays, torch bf16 tensors) of float32 numpy arrays; other
    arrays (masks, ids) handed over as they are."""
    jx, tt = [], []
    for a in arrays:
        if a.dtype == np.float32:
            jx.append(jnp.asarray(a).astype(jnp.bfloat16))
            tt.append(torch.from_numpy(np.ascontiguousarray(a)).bfloat16())
        else:
            jx.append(jnp.asarray(a))
            tt.append(torch.from_numpy(np.ascontiguousarray(a)))
    return jx, tt


def _close(got: torch.Tensor, want, tol=BF16_TOL):
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32), **tol)


def _din_case(B, L, D, h1=16, h2=8, seed=0):
    """tests/test_kernels.py::TestDinAttention's inputs, from numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    mask = rng.random(L) < 0.8
    mask[0] = True
    return (f(B, D), f(L, D), mask, f(4 * D, h1) * 0.2, f(h1) * 0.1,
            f(h1, h2) * 0.2, f(h2) * 0.1, f(h2, 1) * 0.2, f(1) * 0.1)


@pytest.mark.parametrize("B,L,D,h1,h2", [(4, 5, 8, 16, 8), (33, 20, 18, 16, 8),
                                         (64, 100, 18, 80, 40),
                                         (16, 300, 18, 80, 40)])
def test_din_attention_bf16_matches_reference_kernel(B, L, D, h1, h2):
    jx, tt = _bf16(*_din_case(B, L, D, h1, h2, seed=B + L))
    want = jax_din_attention(*jx, interpret=True)
    assert want.dtype == jnp.bfloat16
    _close(da.din_attention(*tt), want)


def _rb(a):
    """float32 values rounded to bf16 (returned as float32)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16(
    ).float().numpy()


def din_bf16_tensor_core_numerics(q, keys, mask, w1, b1, w2, b2, w3, b3):
    """The bf16 kernel's numerics on numpy float32 arrays of bf16 values:
    K1 = k (W1a + W1c) + b1 and Q1 = q (W1b - W1c) in f32 (the folded
    blocks in f32), bf16(k*q) W1d with exact products and f32 sums; h1 =
    relu(K1 + Q1 + that), split into hi = bf16(h1) and lo = bf16(h1 -
    hi); layer 2 as b2 + hi W2 and lo W2 (bf16 W2, f32 sums), added, then
    relu; layer 3, the masked softmax and the pool in f32, the output
    rounded to bf16 once. Returns (out, the GEMM-2 products (hi + lo) W2
    and h1 W2 in fp64, for their gap)."""
    D = q.shape[1]
    f64 = np.float64
    wa, wb, wc, wd = (w1[i * D:(i + 1) * D] for i in range(4))
    k1 = (keys @ (wa + wc) + b1).astype(np.float32)
    q1 = (q @ (wb - wc)).astype(np.float32)
    kq = _rb(keys[None] * q[:, None])                       # (B, L, D)
    h1 = np.maximum(k1[None] + q1[:, None] + kq @ wd, 0).astype(np.float32)
    hi = _rb(h1)
    lo = _rb(h1 - hi)
    c2 = b2 + hi @ w2
    c2s = lo @ w2
    h2 = np.maximum(c2 + c2s, 0)
    s = (h2 @ w3)[..., 0] + b3[0]
    s = np.where(mask[None], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    out = (p @ keys) / p.sum(-1, keepdims=True)
    w2d = w2.astype(f64)
    return (_rb(out), (hi.astype(f64) + lo) @ w2d, h1.astype(f64) @ w2d,
            np.abs(h1.astype(f64)) @ np.abs(w2d))


@pytest.mark.parametrize("B,L,D,h1,h2", [(4, 5, 8, 16, 8), (33, 20, 18, 16, 8),
                                         (64, 100, 18, 80, 40),
                                         (16, 300, 18, 80, 40)])
def test_din_bf16_tensor_core_numerics_match_reference_kernel(B, L, D, h1,
                                                              h2):
    """The bf16 kernel's numerics (``din_bf16_tensor_core_numerics``: h1
    as two bf16 halves times bf16 W2 in layer 2) within the reference's
    bf16 tolerance of the TPU kernel in interpret mode, on the widths of
    ``test_din_attention_bf16_matches_reference_kernel``. The two halves
    keep h1 to 2^-16 of itself (each bf16 rounding to 2^-8), so layer 2's
    product lies within 2^-16 of the sum of its terms' magnitudes of the
    product h1 W2 (largest |d| at these widths 4.2e-5, at 64 rows of 100
    keys, D 18, 80-40: 3.0e-6 of that sum there, 5.3e-6 at most)."""
    args = _din_case(B, L, D, h1, h2, seed=B + L)
    jx, tt = _bf16(*args)
    want = jax_din_attention(*jx, interpret=True)
    rounded = [t.float().numpy() if t.is_floating_point() else t.numpy()
               for t in tt]
    got, split, full, terms = din_bf16_tensor_core_numerics(*rounded)
    np.testing.assert_allclose(got, np.asarray(want).astype(np.float32),
                               **BF16_TOL)
    assert (np.abs(split - full) <= 2.0 ** -16 * terms).all()


@pytest.mark.parametrize("keep_self", [False, True])
@pytest.mark.parametrize("B,F,D", [(8, 27, 128), (5, 7, 33), (130, 4, 16)])
def test_dot_interaction_bf16_matches_reference_kernel(B, F, D, keep_self):
    x = np.random.default_rng(B + F).standard_normal((B, F, D)).astype(
        np.float32)
    (jx,), (tx,) = _bf16(x)
    want = jax_dot(jx, keep_self=keep_self, interpret=True)
    assert want.dtype == jnp.bfloat16
    _close(di.dot_interaction(tx, keep_self), want)


@pytest.mark.parametrize("spec", ge.KERNEL_SPECS)
def test_gather_einsum_bf16_matches_reference_kernel(spec):
    rng = np.random.default_rng(len(spec))
    B, U, L, D, H = 23, 4, 7, 6, 5
    shapes = {"bd,uldh->blh": ((B, D), (U, L, D, H)),
              "bl,uld->bd": ((B, L), (U, L, D)),
              "blh,uh->bl": ((B, L, H), (U, H))}[spec]
    x, table = (rng.standard_normal(s).astype(np.float32) for s in shapes)
    uidx = rng.integers(-2, U + 3, (B,)).astype(np.int32)   # clamped
    (jx, jt, ji), (tx, tt, ti) = _bf16(x, table, uidx)
    want = jax_gather_einsum(spec, jx, jt, ji, interpret=True)
    assert want.dtype == jnp.bfloat16
    _close(ge.gather_einsum(spec, tx, tt, ti), want)


def _bags(hot, scale, seed):
    rng = np.random.default_rng(seed)
    V, D, S = 500, 128, 16
    table = (rng.standard_normal((V, D)) * scale).astype(np.float32)
    ids = rng.integers(0, V, (S, hot)).astype(np.int32)
    segs = np.repeat(np.arange(S, dtype=np.int32), hot)
    return _bf16(table, ids.reshape(-1), segs), S


@pytest.mark.parametrize("hot", [1, 8, 27])
def test_embedding_bag_bf16_matches_reference_kernel(hot):
    """Both entries on the same bags, the table at the models' embedding
    init (normal, stddev 1 / sqrt(V): ``init_graph_params``). Longer bags:
    the next test."""
    ((jt, jids, jsegs), (tt, tids, tsegs)), S = _bags(hot, 500 ** -0.5, hot)
    want = jax_embedding_bag(jt, jids, jsegs, num_segments=S,
                             interpret=True)
    assert want.dtype == jnp.bfloat16
    _close(eb.embedding_bag(tt, tids, tsegs, S), want)
    _close(eb.embedding_bag_fixed(tt, tids.reshape(S, hot)), want)


@pytest.mark.parametrize("hot,scale", [(27, 1.0), (100, 500 ** -0.5)])
def test_embedding_bag_bf16_sums_in_f32_where_the_reference_rounds_rows(
        hot, scale):
    """Rows of N(0, 1) 27 a bag, or at the init scale 100 a bag (the
    multi-hot DLRM's largest). The reference's kernel adds each row in
    bf16 (``o_ref += row_ref``), so its error grows with the bag's length
    and partial sums, not with its result: it lies beyond 2e-2 of the
    exact sum. The port's entries sum in f32 and round each bag once:
    within one bf16 rounding (2^-8 relative) of the exact sum, and nearer
    it than the reference everywhere."""
    ((jt, jids, jsegs), (tt, tids, tsegs)), S = _bags(hot, scale, hot)
    exact = np.zeros((S, tt.shape[1]))
    np.add.at(exact, tsegs.numpy(), tt.double().numpy()[tids.numpy()])
    ref = np.asarray(jax_embedding_bag(jt, jids, jsegs, num_segments=S,
                                       interpret=True)).astype(np.float64)
    for got in (eb.embedding_bag(tt, tids, tsegs, S),
                eb.embedding_bag_fixed(tt, tids.reshape(S, hot))):
        err = np.abs(got.double().numpy() - exact)
        assert (err <= 2 ** -8 * np.abs(exact) + 1e-6).all()
        assert (err <= np.abs(ref - exact) + 1e-6).all()
    assert not np.allclose(ref, exact, **BF16_TOL)


def test_embedding_bag_bf16_keeps_f32_weights_and_mean():
    """Per-id weights stay f32 beside a bf16 table; the plain versions sum
    in f32 and round each bag once (mean: after the division)."""
    rng = np.random.default_rng(7)
    table = torch.from_numpy(rng.standard_normal((50, 16)).astype(
        np.float32)).bfloat16()
    ids = torch.from_numpy(rng.integers(0, 50, (6, 5)))
    w = torch.from_numpy(rng.random((6, 5)).astype(np.float32))
    want = (table.float()[ids] * w[..., None]).sum(1)
    for got in (eb.embedding_bag_fixed(table, ids, "sum", w),
                eb.embedding_bag(table, ids.reshape(-1),
                                 torch.arange(6).repeat_interleave(5), 6,
                                 "sum", w.reshape(-1))):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, want.bfloat16())
    mean = eb.embedding_bag_fixed(table, ids, "mean", w)
    assert torch.equal(mean, (want / 5).bfloat16())


def test_din_attention_plain_takes_any_history_length():
    """2000 keys, 18 chunks of the kernel's 112: the plain version (what a
    CPU tensor runs) within fp32 2e-4 of the reference's oracle."""
    args = _din_case(16, 2000, 18, 80, 40, seed=11)
    got = da.din_attention(*(torch.from_numpy(np.ascontiguousarray(a))
                             for a in args))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(din_attention_ref(*args)), **TOL)


@pytest.mark.parametrize("L", [100, 921, 4000])
def test_executor_sends_din_unit_to_kernel_at_any_length(monkeypatch, L):
    """The single-call executor hands a whole DIN unit over batch-1 keys to
    ``din_attention`` whatever its history length (no capacity check sends
    a long one to the plain path), and the result is the plain unit's."""
    from repro_torch.graph.executor import Executor, init_graph_params
    from repro_torch.graph.ir import GraphBuilder

    g = GraphBuilder()
    q = g.input("q", (18,), "item")
    k = g.input("keys", (L, 18), "user")
    m = g.input("mask", (L,), "user", dtype="bool")
    g.output(g.target_attention("att", q, k, m, mlp_hidden=(80, 40)))
    graph = g.graph
    params = init_graph_params(graph, seed=3, device="cpu")
    rng = np.random.default_rng(L)
    feeds = {"q": torch.from_numpy(rng.standard_normal((5, 18)).astype(
                 np.float32)),
             "keys": torch.from_numpy(rng.standard_normal((1, L, 18)).astype(
                 np.float32)),
             "mask": torch.from_numpy(rng.random((1, L)) < 0.9)}
    calls = []
    real = da.din_attention

    def recorder(*args):
        calls.append(tuple(args[1].shape))
        return real(*args)

    monkeypatch.setattr(da, "din_attention", recorder)
    got = Executor(graph, "uoi", use_pallas=True, device="cpu").run(
        params, feeds)["att"]
    want = Executor(graph, "uoi", device="cpu").run(params, feeds)["att"]
    assert calls == [(L, 18)]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_one_dtype_rule():
    f32, bf = torch.zeros(2), torch.zeros(2, dtype=torch.bfloat16)
    assert build.one_dtype("k", a=f32, b=f32, c=None) == torch.float32
    assert build.one_dtype("k", a=bf, b=bf) == torch.bfloat16
    with pytest.raises(TypeError, match="a float32, b bfloat16"):
        build.one_dtype("k", a=f32, b=bf)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        build.one_dtype("k", a=f32.half())


def _c_entries(name: str) -> dict[str, list[str]]:
    """The parameter types of each ``extern "C"`` function of
    ``csrc/<name>.cu``."""
    src = (build.CSRC / f"{name}.cu").read_text()
    body = src[src.index('extern "C" {'):]
    out = {}
    for ret, fn, params in re.findall(
            r"^(int|long|const char\*) (\w+)\(([^)]*)\)", body, re.M):
        out[fn] = [p.strip() for p in params.split(",")]
    return out


def _ctype(param: str):
    if "*" in param:
        return build.ctypes.c_void_p
    kind = param.rsplit(" ", 1)[0]
    return {"int": build.ctypes.c_int, "int64_t": build.ctypes.c_int64,
            "long long": build.ctypes.c_longlong}[kind]


@pytest.mark.parametrize("mod,name", [(mm.ops, "mari_matmul"),
                                      (ge.ops, "gather_einsum"),
                                      (di.ops, "dot_interaction"),
                                      (da.ops, "din_attention"),
                                      (eb.ops, "embedding_bag")])
def test_ctypes_signatures_match_the_sources(mod, name):
    """Every entry a wrapper binds exists in its source with one ``ctypes``
    type per C parameter (pointers and the stream as ``c_void_p``): a
    mismatch would show only on the card, as a cut pointer."""
    entries = _c_entries(name)
    assert set(mod._SIGNATURES) <= set(entries)
    for fn, (argtypes, _) in mod._SIGNATURES.items():
        assert [_ctype(p) for p in entries[fn]] == list(argtypes), fn
    assert {f for f in entries if f.endswith("_bf16")} <= set(mod._SIGNATURES)


def test_compare_tools_read_each_sources_entry():
    """The kernels' ``compare`` tools call an entry whose parameters
    changed between sources by reading them from each source: this
    checkout's bf16 ``dot_interaction`` entry takes a copy route (8
    parameters, as its ``ctypes`` signature), and commit 38d4546's
    ``din_attention`` (tests/data) the same 16 as this checkout's."""
    from pathlib import Path

    from repro_torch.kernels import turns
    dot = (build.CSRC / "dot_interaction.cu").read_text()
    params = turns.c_params(dot, "dot_interaction_bf16")
    assert len(params) == len(di.ops._SIGNATURES["dot_interaction_bf16"][0])
    assert params[6] == "int route"
    old = (Path(__file__).parent / "data"
           / "din_attention_38d4546.cu").read_text()
    new = (build.CSRC / "din_attention.cu").read_text()
    for fn in ("din_attention_f32", "din_attention_bf16"):
        assert len(turns.c_params(old, fn)) == len(turns.c_params(new, fn)) \
            == 16
    with pytest.raises(ValueError, match="no extern"):
        turns.c_params(old, "din_attention_bf16_smem_bytes")


def test_gather_einsum_compare_tool_calls_the_parents_entries_alike():
    """``gather_einsum.compare`` binds this checkout's ``ctypes``
    signatures to every source it builds: commit 5cd8cdc's (tests/data)
    has the same two entries with the same 11 parameters."""
    from pathlib import Path

    from repro_torch.kernels import turns
    old = (Path(__file__).parent / "data"
           / "gather_einsum_5cd8cdc.cu").read_text()
    new = (build.CSRC / "gather_einsum.cu").read_text()
    for fn in ("gather_einsum_f32", "gather_einsum_bf16"):
        assert turns.c_params(old, fn) == turns.c_params(new, fn)
        assert len(turns.c_params(new, fn)) \
            == len(ge.ops._SIGNATURES[fn][0]) == 11
