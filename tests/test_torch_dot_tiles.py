"""The ``dot_interaction`` CUDA kernel's index arithmetic, modelled in numpy.

The kernel (``src/repro_torch/csrc/dot_interaction.cu``) runs on the card
only; these tests repeat its integer arithmetic on the CPU: the lane-to-tile
map (lane t of a consumer warp owns tile (ti, tj) of the T x T tile
triangle, features dealt to T = ceil(F / 4) classes c, c + T, c + 2T,
c + 3T), the triangle write-out (every pair of ``np.triu_indices(F, k)``
written exactly once, at its place in the output row), the slot layout
(D / 32 column chunks of F rows of 128 bytes with the 128-byte swizzle:
16-byte word w of slot row R lies at word w ^ (R % 8)) and the bank map of
each shared-memory access of one warp instruction against the conflict
degree the kernel's note states. Last, the kernel's arithmetic (fmaf over d
in order, per pair) is emulated and held against the JAX reference.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dot_interaction.ref import dot_interaction_ref
from repro_torch.kernels import dot_interaction as di

TOL = dict(rtol=2e-4, atol=2e-4)
FS = (1, 2, 5, 7, 27, 40)


def _classes(f):
    return (f + 3) // 4


def _lane_tile(t, T):
    """The kernel's walk from lane t to its tile (ti, tj)."""
    ti, rem, length = 0, t, T
    while rem >= length:
        rem -= length
        ti += 1
        length -= 1
    return ti, ti + rem


def _pair_index(i, j, f, keep_self):
    return (i * (2 * f - i + 1) // 2 + (j - i) if keep_self
            else i * (2 * f - i - 1) // 2 + (j - i - 1))


def _rounds(f):
    """Lanes of each round of 32 tiles: [(lane, ti, tj), ...]."""
    T = _classes(f)
    n = T * (T + 1) // 2
    return [[(t - t0, *_lane_tile(t, T)) for t in range(t0, min(n, t0 + 32))]
            for t0 in range(0, n, 32)]


def _writes(f, keep_self):
    """Every staging store of the kernel: (round, r, s, lane, i, j, p)."""
    T = _classes(f)
    out = []
    for rnd, lanes in enumerate(_rounds(f)):
        for r in range(4):
            for s in range(4):
                for lane, ti, tj in lanes:
                    i, j = ti + T * r, tj + T * s
                    keep = ti != tj or (r <= s if keep_self else r < s)
                    if i < f and j < f and keep:
                        lo, hi = min(i, j), max(i, j)
                        out.append((rnd, r, s, lane, lo, hi,
                                    _pair_index(lo, hi, f, keep_self)))
    return out


def _slot_byte(f, d, F):
    """Byte offset of x[f][d] in a slot (``slot_offset`` in the kernel)."""
    R = (d // 32) * F + f
    return R * 128 + ((((d % 32) // 4) ^ (R % 8)) << 4) + (d % 4) * 4


def _degree(byte_addrs, width):
    """Bank-conflict degree of one warp access: the most distinct
    ``width``-byte words that fall on one bank (4 bytes) or bank quad
    (16 bytes); 1 is conflict-free (a repeated word is a broadcast)."""
    words = {a // width for a in byte_addrs}
    groups = {}
    for w in words:
        groups.setdefault(w % (128 // width), set()).add(w)
    return max(len(g) for g in groups.values()) if groups else 0


@pytest.mark.parametrize("f", FS)
def test_lanes_walk_the_tile_triangle_row_major(f):
    T = _classes(f)
    want = [(ti, tj) for ti in range(T) for tj in range(ti, T)]
    assert [_lane_tile(t, T) for t in range(len(want))] == want
    assert all(len(r) <= 32 for r in _rounds(f))


@pytest.mark.parametrize("keep_self", [False, True])
@pytest.mark.parametrize("f", FS)
def test_every_pair_is_written_once_at_its_place(f, keep_self):
    writes = _writes(f, keep_self)
    iu, ju = np.triu_indices(f, k=0 if keep_self else 1)
    got = sorted((p, i, j) for *_, i, j, p in writes)
    assert got == [(p, int(i), int(j)) for p, (i, j) in
                   enumerate(zip(iu, ju))]
    assert di.n_pairs(f, keep_self) == len(iu)


@pytest.mark.parametrize("keep_self", [False, True])
@pytest.mark.parametrize("f", FS)
def test_staging_stores_at_most_ceil_t_over_2_way(f, keep_self):
    """One scalar store instruction: (round, r, s) over the lanes."""
    by_instr = {}
    for rnd, r, s, lane, i, j, p in _writes(f, keep_self):
        by_instr.setdefault((rnd, r, s), []).append(4 * p)
    bound = max(1, math.ceil(_classes(f) / 2))
    assert max((_degree(a, 4) for a in by_instr.values()), default=0) <= bound


@pytest.mark.parametrize("d", [16, 33, 128, 130])
@pytest.mark.parametrize("f", FS)
def test_tile_loads_conflict_free_up_to_8_classes(f, d):
    """One 16-byte load instruction: side a (features ti + T r) or b
    (tj + T r), r, the column chunk q and word w, over a round's lanes."""
    T = _classes(f)
    worst = 0
    for lanes in _rounds(f):
        for side in (0, 1):
            for r in range(4):
                for q in range(-(-d // 32)):
                    for w in range(8):
                        addrs = [_slot_byte((tj if side else ti) + T * r,
                                            32 * q + 4 * w, f)
                                 for _, ti, tj in lanes]
                        worst = max(worst, _degree(addrs, 16))
    assert worst <= max(1, math.ceil(T / 8))
    if T <= 8:
        assert worst == 1


@pytest.mark.parametrize("d", [1, 5, 16, 33, 100, 128, 130])
@pytest.mark.parametrize("f", FS)
def test_cp_async_copy_stores_at_most_4_way(f, d):
    """The producer's 4-byte copies: element e = lane + 32 k of the row."""
    worst = 0
    for e0 in range(0, f * d, 32):
        addrs = [_slot_byte(e // d, e % d, f)
                 for e in range(e0, min(e0 + 32, f * d))]
        worst = max(worst, _degree(addrs, 4))
    assert worst <= 4


@pytest.mark.parametrize("d", [16, 33, 128])
@pytest.mark.parametrize("f", FS)
def test_slot_layout_is_one_to_one_inside_the_slot(f, d):
    nq = -(-d // 32)
    offs = {_slot_byte(i, k, f) for i in range(f) for k in range(32 * nq)}
    assert len(offs) == f * 32 * nq
    # the rows padding features read stay inside the slot the plan sizes
    slot = -(-(nq * f + 3) * 128 // 1024) * 1024
    pad_rows = [q * f + c + _classes(f) * r for q in range(nq)
                for c in range(_classes(f)) for r in range(4)]
    assert max(offs) < slot and max(pad_rows) * 128 + 127 < slot


def test_copy_route_by_shape_and_address():
    x = torch.zeros(4, 27, 128)
    assert di.copy_route(x) == "tma"
    assert di.copy_route(torch.zeros(2, 7, 33)) == "cp.async"
    assert di.copy_route(torch.zeros(2, 5, 16)) == "cp.async"
    assert di.copy_route(torch.zeros(2, 257, 32)) == "cp.async"
    shifted = x.reshape(-1)[1:1 + 3 * 27 * 128].view(3, 27, 128)
    assert shifted.data_ptr() % 16 == 4
    assert di.copy_route(shifted) == "cp.async"


def test_shared_memory_plans_and_refusal():
    cap = di.ops.MAX_SMEM_BYTES
    assert di.smem_bytes(27, 128, consumers=7, slots_per_warp=2) <= cap
    assert di.smem_bytes(27, 128, consumers=11) <= cap
    assert di.smem_bytes(64, 1024) > cap          # the refused shape
    assert di.smem_bytes(40, 64) <= cap


def _kernel_emulation(x, keep_self):
    """The kernel's arithmetic: each staged pair an fmaf sum over d in
    order (fp32 products exact in fp64, each sum rounded to fp32)."""
    B, f, d = x.shape
    out = np.zeros((B, di.n_pairs(f, keep_self)), np.float32)
    for *_, i, j, p in _writes(f, keep_self):
        acc = np.zeros(B, np.float32)
        for k in range(d):
            acc = (x[:, i, k].astype(np.float64) * x[:, j, k]
                   + acc).astype(np.float32)
        out[:, p] = acc
    return out


@pytest.mark.parametrize("keep_self", [False, True])
@pytest.mark.parametrize("f,d", [(5, 16), (7, 33), (27, 32)])
def test_emulated_kernel_matches_reference(f, d, keep_self):
    x = np.random.default_rng(f + d).standard_normal((3, f, d)).astype(
        np.float32)
    got = _kernel_emulation(x, keep_self)
    np.testing.assert_allclose(
        got, np.asarray(dot_interaction_ref(jnp.asarray(x), keep_self)), **TOL)
    np.testing.assert_allclose(
        got, di.dot_interaction_plain(torch.from_numpy(x), keep_self).numpy(),
        **TOL)


# ---- the bf16 instance: mma.sync m16n8k16 over tiles touching the triangle

def _bf16_slot_byte(f, d, F):
    """Byte offset of x[f][d] in a bf16 slot (``slot_offset_bf16``): chunk
    q = d / 64 holds slot rows R = q F + f of 128 bytes, 16-byte word
    (d % 64) / 8 of row R at word ((d % 64) / 8) ^ (R % 8)."""
    R = (d // 64) * F + f
    return R * 128 + ((((d % 64) // 8) ^ (R % 8)) << 4) + (d % 8) * 2


def _frag_byte(m, ks, F, lane):
    """The kernel's ``frag_addr``: the 16-byte row this lane hands
    ldmatrix.x4 for rows 16 m .. 16 m + 15 (clamped to F - 1) at columns
    16 ks (lanes 0-15) or 16 ks + 8 (lanes 16-31)."""
    return _bf16_slot_byte(min(16 * m + (lane & 15), F - 1),
                           16 * ks + ((lane >> 4) << 3), F)


def _bf16_writes(f, keep_self, pairs=4):
    """Every staging store of a consumer's passes: (mi, nj, i, j, p). A
    pass is m16 tile mi against the n8 tiles of row groups p0 .. p0 + 3
    (p0 = mi, mi + 4, ...); lane g8 * 4 + t4 holds C rows g8, g8 + 8 at
    columns 2 t4, 2 t4 + 1."""
    MT = -(-f // 16)
    out = []
    for mi in range(MT):
        for p0 in range(mi, MT, pairs):
            for p in range(p0, min(p0 + pairs, MT)):
                for u in (0, 1):
                    if u == 1 and 16 * p + 8 >= f:
                        continue            # a tile of padding rows only
                    nj = 2 * p + u
                    for lane in range(32):
                        g8, t4 = lane >> 2, lane & 3
                        for e in range(4):
                            i = 16 * mi + g8 + 8 * (e >> 1)
                            j = 8 * nj + 2 * t4 + (e & 1)
                            if j < f and (i <= j if keep_self else i < j):
                                out.append((mi, nj, i, j, _pair_index(
                                    i, j, f, keep_self)))
    return out


FS_BF16 = (1, 2, 5, 7, 16, 27, 40, 100)


@pytest.mark.parametrize("keep_self", [False, True])
@pytest.mark.parametrize("f", FS_BF16)
def test_bf16_passes_write_every_pair_once(f, keep_self):
    """The m16 x n8 tiles with n tile >= 2 m tile cover the triangle, and
    each pair is stored once at its place (F = 27: 6 of 8 tiles)."""
    writes = _bf16_writes(f, keep_self)
    iu, ju = np.triu_indices(f, k=0 if keep_self else 1)
    got = sorted((p, i, j) for *_, i, j, p in writes)
    assert got == [(p, int(i), int(j)) for p, (i, j) in
                   enumerate(zip(iu, ju))]
    if f == 27:
        assert len({(mi, nj) for mi, nj, *_ in writes}) == 6


@pytest.mark.parametrize("d", [16, 33, 64, 128, 130])
@pytest.mark.parametrize("f", FS_BF16)
def test_bf16_ldmatrix_rows_conflict_free(f, d):
    """Each 8-lane phase of an ldmatrix.x4 (one 8 x 8 matrix) reads 8
    16-byte rows on distinct bank quads, clamped rows repeating a row
    (a broadcast); every address lies inside the slot's nq F rows."""
    nq, kt = -(-d // 64), -(-d // 16)
    for m in range(-(-f // 16)):
        for ks in range(kt):
            addrs = [_frag_byte(m, ks, f, lane) for lane in range(32)]
            assert max(addrs) + 16 <= nq * f * 128
            for phase in range(4):
                assert _degree(addrs[8 * phase:8 * phase + 8], 16) == 1


@pytest.mark.parametrize("d", [16, 33, 64, 128])
@pytest.mark.parametrize("f", FS_BF16)
def test_bf16_slot_layout_is_one_to_one_inside_the_slot(f, d):
    nq = -(-d // 64)
    offs = {_bf16_slot_byte(i, k, f) for i in range(f)
            for k in range(64 * nq)}
    assert len(offs) == f * 64 * nq
    assert max(offs) < nq * f * 128


@pytest.mark.parametrize("f,d", [(27, 128), (40, 48), (7, 33), (256, 64)])
def test_bf16_ldmatrix_fragments_form_the_gram(f, d):
    """The fragments ldmatrix gives (lane l, register r: row l / 4 of
    matrix r, columns 2 (l % 4), + 1), read from a bf16 slot image, make
    A of m tile mi and B of n tiles 2p, 2p + 1 as the kernel pairs them
    (B of 2p = (r0, r2), of 2p + 1 = (r1, r3) of row group p's x4): their
    products over the k steps are the gram's tiles (fp64, no rounding:
    this checks indices, not arithmetic)."""
    rng = np.random.default_rng(f + d)
    x = rng.standard_normal((f, d))
    kt = -(-d // 16)
    slot = np.zeros(-(-d // 64) * f * 128 // 2)      # bf16 elements
    for i in range(f):
        for k in range(d):
            slot[_bf16_slot_byte(i, k, f) // 2] = x[i, k]
    gram = x @ x.T
    G, T = np.arange(32) // 4, np.arange(32) % 4

    def x4(m, ks):
        rows = np.array([_frag_byte(m, ks, f, lane) // 2 for lane in range(32)])
        # register r of lane l: matrix r's row l // 4, columns 2 (l % 4) + e
        return np.array([[slot[rows[8 * r + G] + 2 * T + e] for e in (0, 1)]
                         for r in range(4)]).transpose(2, 0, 1)  # (32, 4, 2)

    for mi in range(-(-f // 16)):
        for p in range(mi, -(-f // 16)):
            for u in (0, 1):
                C = np.zeros((16, 8))
                for ks in range(kt):
                    a, b = x4(mi, ks), x4(p, ks)
                    A = np.zeros((16, 16))
                    for r in range(4):
                        for e in (0, 1):
                            A[G + 8 * (r % 2), 2 * T + e + 8 * (r // 2)] = \
                                a[:, r, e]
                    Bm = np.zeros((16, 8))
                    for h, r in enumerate((u, u + 2)):
                        for e in (0, 1):
                            Bm[2 * T + e + 8 * h, G] = b[:, r, e]
                    C += A @ Bm
                i = np.arange(16 * mi, 16 * mi + 16)
                j = np.arange(8 * (2 * p + u), 8 * (2 * p + u) + 8)
                ok = (i[:, None] < f) & (j[None, :] < f)
                want = gram[np.minimum(i, f - 1)][:, np.minimum(j, f - 1)]
                np.testing.assert_allclose(C[ok], want[ok], rtol=1e-12,
                                           atol=1e-12)


def test_bf16_copy_route_by_shape_and_address():
    x = torch.zeros(4, 27, 128, dtype=torch.bfloat16)
    assert x.data_ptr() % 16 == 0 and di.copy_route(x) == "tma"
    assert di.copy_route(torch.zeros(2, 27, 32, dtype=torch.bfloat16)) \
        == "cp.async"                           # D % 64 != 0
    assert di.copy_route(torch.zeros(2, 257, 64, dtype=torch.bfloat16)) \
        == "cp.async"                           # F > 256
    assert di.copy_route(torch.zeros(2, 7, 33, dtype=torch.bfloat16)) \
        == "sync"                               # odd D
    flat = x.reshape(-1)
    assert di.copy_route(flat[1:1 + 3 * 27 * 128].view(3, 27, 128)) == "sync"
    assert di.copy_route(flat[2:2 + 3 * 27 * 128].view(3, 27, 128)) \
        == "cp.async"                           # 4 bytes past alignment
    assert di.ops.ROUTES == ("tma", "cp.async", "sync")


def test_bf16_shared_memory_plans_worked_by_hand():
    """F = 27, D = 128, bf16: a slot is 2 chunks x 27 rows x 128 bytes =
    6912, rounded to 7168 (an fp32 slot: 4 x 27 + 3 rows, 14,336); a
    staging row 2 x 352 bytes. The ring plan (7 consumers x 2 slots):
    1024-rounded head of 14 x 16 + 7 x 704 = 5152 -> 6144, 14 slots,
    1008 to align: 107,504 bytes; the bf16 plan's 15 consumers x 2
    slots: 11,040 -> 11,264, 30 slots, 227,312 bytes, within a block's
    232,448; one consumer of one slot: 9,200."""
    bf = torch.bfloat16
    assert di.smem_bytes(27, 128, consumers=7, slots_per_warp=2,
                         dtype=bf) == 107504
    assert di.smem_bytes(27, 128, consumers=15, slots_per_warp=2,
                         dtype=bf) == 227312 <= di.ops.MAX_SMEM_BYTES
    assert di.smem_bytes(27, 128, dtype=bf) == 1024 + 7168 + 1008
    assert di.smem_bytes(27, 128) == 2048 + 14336 + 1008
    # F = 256, D = 64: P = 32,640 pairs staged (65,280 bytes; with the
    # mbarriers 65,296 -> 65,536), one slot of 256 rows: 65,536 + 32,768
    # + 1008, within one block
    assert di.smem_bytes(256, 64, dtype=bf) == 99312 <= di.ops.MAX_SMEM_BYTES
    assert di.smem_bytes(64, 2048, dtype=bf) > di.ops.MAX_SMEM_BYTES
