"""The plan of ``mari_matmul``'s bf16 entry, on the CPU: its k chunks (a
function of K alone), a model of its arithmetic (each chunk summed on its
own, the chunks added to the f32 init in order) against the reference's
Pallas op run in interpret mode, its tiles and the shared-memory and
register budgets they promise, the staged tile's bank map, the prepared
weight's layout and descriptor box, and the row stride of the serving
path's bf16 streams.

Inputs are made from a seed with numpy and handed to both packages; bf16
results are held at the reference's bf16 tolerance, 2e-2.
"""
import inspect

import numpy as np
import pytest
import torch

from repro.kernels import mari_matmul_fused_groups as jax_fused_groups
from repro_torch.graph.executor import _concat_xs
from repro_torch.kernels import mari_matmul as mm
from repro_torch.kernels.mari_matmul import ops
from repro_torch.nn.layers import ACTIVATIONS

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
SMEM_LIMIT = 232_448      # dynamic shared memory a block may take (H100)
STATIC_SMEM = 128         # the kernel's 16 mbarriers
MAX_REGISTERS = 232       # a consumer thread's registers (setmaxnreg.inc)
OTHER_REGISTERS = 40      # addresses, counters, the ring position


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def chunked_bf16(x, w, u, user_index=None, activation="identity"):
    """The bf16 entry's arithmetic on the CPU: each of ``bf16_chunks(K)``
    summed on its own (in fp64 and rounded to f32 once: the tensor cores'
    chain to within its rounding), the chunks added to the f32 init in
    chunk order with f32 adds, the activation in f32, bf16 once."""
    if user_index is not None:
        u = u[user_index.long().clamp(0, u.shape[0] - 1)]
    acc = u.float().expand(x.shape[0], -1).clone()
    xd, wd = x.double(), w.double()
    for k0, k1 in ops.bf16_chunks(x.shape[1]):
        acc += (xd[:, k0:k1] @ wd[k0:k1]).float()
    return ACTIVATIONS[activation](acc).bfloat16()


@pytest.mark.parametrize("K", [0, 1, 48, 190, 255, 256, 257, 351, 500, 1064,
                               4096])
def test_chunks_depend_on_k_alone(K):
    """Chunks of 256 from k = 0, the last one short: they tile [0, K) in
    order, and nothing but K enters (no batch, width, tile or route)."""
    assert list(inspect.signature(ops.bf16_chunks).parameters) == ["K"]
    chunks = ops.bf16_chunks(K)
    assert len(chunks) == -(-K // ops.CHUNK_K)
    assert [k0 for k0, _ in chunks] == list(range(0, K, 256))
    assert all(k1 - k0 == 256 for k0, k1 in chunks[:-1])
    if chunks:
        assert chunks[-1][1] == K and 0 < K - chunks[-1][0] <= 256
    assert ops.CHUNK_K == 4 * 64          # csrc CHUNK_TILES k tiles of 64


@pytest.mark.parametrize("activation", ["identity", "relu", "silu"])
@pytest.mark.parametrize("mode", ["broadcast", "rowwise", "gather"])
@pytest.mark.parametrize("K", [48, 351, 1064])
def test_chunk_model_matches_reference(K, mode, activation):
    """The chunked association against the reference's Pallas op (bf16
    operands, interpret mode) and the port's plain version: within the
    reference's bf16 tolerance."""
    rng = np.random.default_rng(K)
    B, N, U = 37, 40, 5
    x = rng.standard_normal((B, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    xb, wb = _t(x).bfloat16(), _t(w).bfloat16()
    acc0 = idx = None
    if mode == "rowwise":
        acc0 = rng.standard_normal((B, N)).astype(np.float32)
    elif mode == "gather":
        acc0 = rng.standard_normal((U, N)).astype(np.float32)
        idx = rng.integers(-2, U + 3, B).astype(np.int32)
    import jax.numpy as jnp
    want = jax_fused_groups(
        [(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
          jnp.asarray(wb.float().numpy(), jnp.bfloat16))],
        acc0=None if acc0 is None else jnp.asarray(acc0),
        user_index=None if idx is None else jnp.asarray(idx),
        activation=activation, interpret=True)
    want = torch.from_numpy(np.asarray(want, np.float32))
    u = torch.zeros(1, N) if acc0 is None else _t(acc0)
    ui = None if idx is None else _t(idx)
    got = chunked_bf16(xb, wb, u, ui, activation)
    plain = mm.mari_matmul_fused_groups(
        [(xb, wb)], acc0=None if acc0 is None else _t(acc0), user_index=ui,
        activation=activation)
    assert got.dtype == plain.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, **BF16_TOL)
    torch.testing.assert_close(got.float(), plain.float(), **BF16_TOL)


def test_chunk_model_row_independent_of_batch():
    """A row's chunked sums read only its own x and u rows: the rows of a
    slice give the bits of the same rows in the whole batch."""
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((300, 1064)).astype(np.float32)).bfloat16()
    w = _t((rng.standard_normal((1064, 64)) * 0.05).astype(np.float32))
    u = _t(rng.standard_normal((300, 64)).astype(np.float32))
    full = chunked_bf16(x, w.bfloat16(), u, activation="relu")
    part = chunked_bf16(x[123:200], w.bfloat16(), u[123:200],
                        activation="relu")
    assert torch.equal(full[123:200], part)


PLAN_CASES = [(1, 1), (37, 4), (512, 4), (512, 64), (512, 128), (512, 200),
              (512, 512), (2048, 512), (4096, 512), (4096, 1024),
              (262_144, 512), (1_000_000, 1024), (5000, 9)]


@pytest.mark.parametrize("B,N", PLAN_CASES)
def test_bf16_plan_budgets(B, N):
    """The tile is fp32's (bm from (B, N), bn from N); one persistent CTA
    per SM at most and per tile; the ring (2 .. 8 stages of bm + bn rows
    of 128 bytes) and the staged tile fit in shared memory beside the
    kernel's barriers; a consumer thread's accumulator and two chunk
    partials leave room for its other registers."""
    p = ops.bf16_plan(B, N)
    assert (p.bm, p.bn) == ops.tile_config(B, N)
    tiles = -(-B // p.bm) * -(-N // p.bn)
    assert p.grid == min(tiles, 132)
    assert ops.bf16_plan(B, N, sms=66).grid == min(tiles, 66)
    assert p.stage_bytes == (p.bm + p.bn) * 128
    assert 2 <= p.stages <= 8
    assert p.staged_bytes == p.bm * (2 * p.bn + 16)
    assert p.smem_bytes == p.stages * p.stage_bytes + p.staged_bytes + 1024
    assert p.smem_bytes + STATIC_SMEM <= SMEM_LIMIT
    assert p.stages * p.stage_bytes + p.staged_bytes <= 200 * 1024 or \
        p.stages == 2
    assert p.accumulators == 3 * p.bn // 2
    assert p.accumulators + OTHER_REGISTERS <= MAX_REGISTERS


def test_bf16_plan_at_the_paper_shapes():
    """The expert fc0 stream at a full bucket: two consumers, 128 x 128
    tiles, 128 CTAs, 5 stages of 32 KB beside a 34,816-byte staged tile;
    at the serve cells' 512 rows one consumer, 32 CTAs, 7 stages."""
    p = ops.bf16_plan(4096, 512)
    assert (p.bm, p.bn, p.grid, p.stages) == (128, 128, 128, 5)
    assert (p.staged_bytes, p.smem_bytes) == (34_816, 199_680)
    assert p.accumulators == 192
    q = ops.bf16_plan(512, 512)
    assert (q.bm, q.bn, q.grid, q.stages) == (64, 128, 32, 7)
    assert ops.bf16_plan(262_144, 512).grid == 132


def test_bf16_tile_width_depends_on_n_alone():
    for N in (1, 4, 8, 9, 32, 33, 64, 65, 128, 200, 400, 512, 1024):
        widths = {ops.bf16_plan(B, N).bn for B in (1, 64, 512, 2048, 4096,
                                                   262_144)}
        assert len(widths) == 1 and widths.pop() == ops.tile_config(1, N)[1]


@pytest.mark.parametrize("bn", [8, 32, 64, 128])
def test_staged_tile_rows_are_bank_conflict_free(bn):
    """A warp's fragment write (lane 4g + t: row g, bf16 pair 2t of one 8
    column group) lands on 32 distinct 4-byte banks with rows 2 bn + 16
    bytes apart (two lanes a bank at bn = 8, where a row holds 4 pairs)."""
    pitch = 2 * bn + 16
    for j in range(bn // 8):
        banks = {((g * pitch + (8 * j + 2 * t) * 2) // 4) % 32
                 for g in range(8) for t in range(4)}
        assert len(banks) == (16 if bn == 8 else 32)


@pytest.mark.parametrize("K,N", [(1064, 512), (37, 20), (351, 1024),
                                 (48, 200), (64, 4)])
def test_bf16_weight_layout_and_descriptor_box(K, N, monkeypatch):
    """The bf16 weight is w^T with rows padded to 64 bf16 (128 bytes, one
    L2 line a k tile), its tile width from N alone; its one descriptor
    has box (bn rows, 64); fp32's two keep (bn, 32)."""
    boxes = []
    monkeypatch.setattr(ops, "encode_map", lambda addr, t, bi, bo:
                        boxes.append((t.dtype, bi, bo)))
    w = torch.randn(K, N).bfloat16()
    mw = mm.prepare_mari_weight(w)
    assert mw.bn == ops.tile_config(1, N)[1] == ops.bf16_plan(4096, N).bn
    assert mw.hi.shape == (N, -(-K // 64) * 64) and mw.lo is None
    assert torch.equal(mw.hi[:, :K], w.t()) and not mw.hi[:, K:].any()
    ops._encode_weight_maps(mw)
    assert boxes == [(torch.bfloat16, 64, mw.bn)]
    boxes.clear()
    ops._encode_weight_maps(mm.prepare_mari_weight(w.float()))
    assert boxes == [(torch.float32, 32, mw.bn)] * 2


def test_bf16_streams_are_written_on_lines():
    """A producer writes a bf16 stream at a row stride of 128-byte
    multiples (``stream_ld``); fp32 keeps TMA's 16-byte rule. The
    executor's concatenated stream takes it: paper's expert fc0 (64 + 500
    + 500 = 1064 wide) is written 1088 wide in bf16 and 1064 in fp32."""
    for K in (1, 48, 190, 351, 500, 1064):
        assert ops.stream_ld(K, torch.bfloat16) % 64 == 0
        assert 0 <= ops.stream_ld(K, torch.bfloat16) - K < 64
        assert ops.stream_ld(K, torch.float32) == ops.aligned_ld(
            K, torch.float32)
    v = mm.empty_stream(7, 351, torch.bfloat16, torch.device("cpu"))
    assert v.stride() == (384, 1) and ops.tma_ready(v)
    parts = [torch.randn(5, 64), torch.randn(5, 500), torch.randn(5, 500)]
    for dtype, ld in ((torch.bfloat16, 1088), (torch.float32, 1064)):
        xs = [p.to(dtype) for p in parts]
        s = _concat_xs(xs, aligned=True)
        assert s.shape == (5, 1064) and s.stride() == (ld, 1)
        assert torch.equal(s, torch.cat(xs, dim=-1))
