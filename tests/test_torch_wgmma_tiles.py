"""The two ``wgmma`` routes' index arithmetic and numerics, modelled on the
CPU (no nvcc here): ``csrc/gather_einsum.cu``'s fp32 ``bd,uldh->blh`` past
D = 40 (``q_t_tc_kernel``: the stable counting sort by user and its row
tiles, the staged A fragment, x's swizzled hi / lo rows, the output
staging, the 3xTF32 sum over d by 32-deep k tiles) and
``csrc/din_attention.cu``'s wide route (the prepared weights' tile plan
and layout, W2's rows permuted against GEMM 1's accumulator, GEMM 1's A
fragment). Each map is held to the PTX ISA's ``wgmma`` fragment layouts
(A from registers: warp w of the warpgroup rows 16 w .., lane (g, t) =
(lane / 4, lane % 4); accumulator register 4j + 2h + e at row 16 w + g +
8 h, column 8 j + 2 t + e) and to shared-memory banks. Layout constants
are read from the sources."""
from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import din_attention as da
from repro_torch.kernels import gather_einsum as ge
from repro_torch.kernels.din_attention import ops as dops
from repro_torch.kernels.mari_matmul.ops import split_tf32, tf32_round

GE_SRC = (build.CSRC / "gather_einsum.cu").read_text()
DIN_SRC = (build.CSRC / "din_attention.cu").read_text()
SMEM = 232448                      # a Hopper block's dynamic shared memory


def _const(src: str, name: str) -> int:
    expr = re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
    names = {n: _const(src, n) for n in re.findall(r"[A-Z][A-Z_0-9]+", expr)}
    return int(eval(expr, {}, names))


TC = {n: _const(GE_SRC, n) for n in (
    "TC_MIN_D", "TC_COLS", "TC_KT", "TC_KS", "TC_AS", "TC_OS", "TC_STAGES",
    "TC_WG", "TC_X_BYTES", "GS_TILE")}


# ---- gather_einsum: the route's plan ----------------------------------------
def tc_rows(D: int) -> int:
    """csrc ``tc_rows``: x rows a warpgroup holds (wgmma's N)."""
    dp = -(-D // TC["TC_KT"]) * TC["TC_KT"]
    for nr in (64, 32, 16, 8):
        if TC["TC_WG"] * nr * dp * 8 <= TC["TC_X_BYTES"]:
            return nr
    return 0


def tc_smem_bytes(D: int, nr: int) -> int:
    """csrc ``tc_smem_bytes``."""
    kt = -(-D // TC["TC_KT"])
    return (1024 + 2 * kt * TC["TC_WG"] * nr * TC["TC_KT"] * 4
            + TC["TC_STAGES"] * TC["TC_KT"] * TC["TC_AS"] * 4
            + TC["TC_WG"] * nr * TC["TC_OS"] * 4)


def test_tc_constants_and_plan_fit_the_card():
    """The route starts past D = 40 (the wrapper's threshold too); a tile
    is wgmma's M of 64 columns by 32-deep k tiles (one 128-byte row of x,
    4 k steps); staged rows stay 16-byte aligned; every D it takes fits a
    block's shared memory, with N a multiple of 8 whose warpgroup rows
    start on the 1024-byte swizzle atom; past D = 1024 the CUDA-core
    kernel keeps it."""
    assert TC["TC_MIN_D"] == ge.ops.TC_MIN_D == 41
    assert TC["TC_COLS"] == 64 and TC["TC_KT"] == 32 and TC["TC_KS"] == 4
    assert (TC["TC_AS"] * 4) % 16 == 0 and (TC["TC_OS"] * 4) % 16 == 0
    for D in (41, 48, 64, 100, 128, 130, 256, 300, 512, 1000, 1024):
        nr = tc_rows(D)
        assert nr in (64, 32, 16, 8) and (nr * 128) % 1024 == 0
        assert tc_smem_bytes(D, nr) <= SMEM
    assert tc_rows(128) == 64 and tc_rows(1025) == 0


# ---- gather_einsum: the stable counting sort --------------------------------
def counting_sort(idx: np.ndarray, U: int, rows_per_tile: int):
    """The three sort launches (``ge_sort_hist``, ``ge_sort_scan``,
    ``ge_sort_scatter``) in numpy: (perm, tiles) with perm[position] = row
    and tiles[i] = (start, rows, user)."""
    G = TC["GS_TILE"]
    key = np.clip(idx, 0, U - 1)
    B = len(key)
    n_t = -(-B // G)
    counts = np.zeros((n_t, U), np.int64)
    for t in range(n_t):                              # ge_sort_hist
        np.add.at(counts[t], key[t * G:(t + 1) * G], 1)
    totals = counts.sum(0)
    before = np.cumsum(counts, 0) - counts            # ge_sort_scan
    off = np.cumsum(totals) - totals
    first = before + off[None]
    tiles = []
    for u in range(U):
        for i in range(-(-int(totals[u]) // rows_per_tile)):
            tiles.append((int(off[u]) + i * rows_per_tile,
                          min(rows_per_tile, int(totals[u]) - i * rows_per_tile),
                          u))
    perm = np.empty(B, np.int64)
    for b in range(B):                                # ge_sort_scatter
        t, j = divmod(b, G)
        rank = int(np.sum(key[t * G:b] == key[b]))
        perm[first[t, key[b]] + rank] = b
    return perm, tiles


@pytest.mark.parametrize("B,U,order", [(1, 1, "random"), (300, 8, "random"),
                                       (4096, 8, "random"), (4096, 8, "runs"),
                                       (1000, 64, "random"), (257, 3, "runs"),
                                       (513, 600, "random")])
def test_counting_sort_is_the_stable_argsort(B, U, order):
    """The permutation is ``np.argsort(clamped index, stable)``, whatever
    the order and however many sort tiles; the row tiles cut each user's
    rows into runs of at most TC_WG x 64, in user order, within the
    workspace's ``max_tiles``."""
    rng = np.random.default_rng(B + U)
    idx = rng.integers(-2, U + 3, B)
    if order == "runs":
        idx = np.sort(idx)
    nr = TC["TC_WG"] * 64
    perm, tiles = counting_sort(idx, U, nr)
    key = np.clip(idx, 0, U - 1)
    np.testing.assert_array_equal(perm, np.argsort(key, kind="stable"))
    assert len(tiles) <= -(-B // nr) + min(U, B)
    pos = 0
    for start, rows, u in tiles:
        assert start == pos and 0 < rows <= nr
        assert (key[perm[start:start + rows]] == u).all()
        pos += rows
    assert pos == B


# ---- gather_einsum: the tile's fragments and stagings -----------------------
def test_tc_a_fragment_is_the_staged_slice_transposed():
    """From the staged A k tile S[d][column] (row stride TC_AS), thread
    (warp, g, t)'s registers for k step kk are A[m][k] = S[k][m] in
    wgmma's tf32 order a0 (16w + g, t), a1 (+8, t), a2 (g, t + 4), a3 (+8,
    t + 4); each register's 32 lanes fall in 32 distinct banks."""
    AS, KT = TC["TC_AS"], TC["TC_KT"]
    rng = np.random.default_rng(0)
    S = rng.standard_normal((KT, AS))
    mem = S.reshape(-1)
    for warp in range(4):
        for kk in range(TC["TC_KS"]):
            addrs = np.zeros((32, 4), np.int64)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                ml = warp * 16 + g
                a0 = (8 * kk + t) * AS + ml          # the kernel's addresses
                a1 = a0 + 4 * AS
                addrs[lane] = (a0, a0 + 8, a1, a1 + 8)
                m, k = warp * 16 + g, 8 * kk + t
                want = (S[k, m], S[k, m + 8], S[k + 4, m], S[k + 4, m + 8])
                assert tuple(mem[addrs[lane]]) == want
            for r in range(4):
                assert len(set(addrs[:, r] % 32)) == 32


def _swizzled_offset(r: int, d: int, rows: int) -> int:
    """The kernel's float offset of x value (row r, d) in its hi / lo
    array: k tile d / 32, row r, 16-byte chunk (d % 32 / 4) ^ (r % 8)."""
    c = (d % 32) >> 2
    return ((d // 32) * rows + r) * 32 + ((c ^ (r & 7)) << 2) + (d & 3)


@pytest.mark.parametrize("D", [41, 128, 130])
def test_tc_x_rows_in_wgmmas_k_major_swizzle(D):
    """x's staged rows are wgmma's K-major B with the 128-byte swizzle, one
    k tile of (TC_WG nr rows x 128 bytes) after another: the kernel's
    offsets equal ``din_attention``'s ``swizzle_128`` layout of each k
    tile, each warpgroup's rows start on a 1024-byte atom, and hi + lo is
    x to ~2^-22 with hi = tf32(x)."""
    nr = tc_rows(D)
    rows, kt_n = TC["TC_WG"] * nr, -(-D // 32)
    rng = np.random.default_rng(D)
    x = np.zeros((rows, kt_n * 32), np.float32)
    x[:, :D] = rng.standard_normal((rows, D))
    mem = np.zeros(kt_n * rows * 32, np.float32)
    for r in range(rows):
        for d in range(kt_n * 32):
            mem[_swizzled_offset(r, d, rows)] = x[r, d]
    tiles = torch.from_numpy(x).reshape(rows, kt_n, 32).permute(1, 0, 2)
    want = dops.swizzle_128(tiles.contiguous()).reshape(-1).numpy()
    np.testing.assert_array_equal(mem, want)
    assert (nr * 128) % 1024 == 0
    hi, lo = split_tf32(torch.from_numpy(x))
    torch.testing.assert_close(hi + lo, torch.from_numpy(x), rtol=2 ** -21,
                               atol=0)
    assert torch.equal(hi, tf32_round(torch.from_numpy(x)))


def test_tc_out_staging_is_the_transpose():
    """The accumulator (64 columns x nr rows) staged at sO[row * TC_OS +
    column] from register 4j + 2h + c = (column 16w + g + 8h, row 8j + 2t +
    c) reads back row by row as the tile transposed; each store of a
    register hits 32 distinct banks."""
    OS, nr = TC["TC_OS"], 64
    rng = np.random.default_rng(1)
    C = rng.standard_normal((64, nr))                # (column, row)
    sO = np.full(nr * OS, np.nan)
    for warp in range(4):
        for j in range(nr // 8):
            for h in range(2):
                for c in range(2):
                    banks = set()
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        m, n = warp * 16 + g + 8 * h, 8 * j + 2 * t + c
                        a = n * OS + warp * 16 + g + 8 * h
                        sO[a] = C[m, n]
                        banks.add(a % 32)
                    assert len(banks) == 32
    np.testing.assert_array_equal(sO.reshape(nr, OS)[:, :64], C.T)


def _tc_route(x, table, idx):
    """The route's arithmetic in numpy for fp32 ``bd,uldh->blh``: rows
    grouped by user (the counting sort), per row tile and 32-deep k tile
    the three products of tf32 parts (lo(T) hi(x) + hi(T) lo(x) + hi(T)
    hi(x), in fp64, rounded to fp32 once: a chain from zero) added to the
    fp32 sum, in k-tile order; each row stored at its own place."""
    B, D = x.shape
    U, L, _, H = table.shape
    perm, tiles = counting_sort(idx, U, TC["TC_WG"] * tc_rows(D))
    xh, xl = (p.numpy().astype(np.float64)
              for p in split_tf32(torch.from_numpy(x)))
    out = np.empty((B, L * H), np.float32)
    for start, rows, u in tiles:
        sel = perm[start:start + rows]
        A = table[u].transpose(1, 0, 2).reshape(D, L * H)     # (d, column)
        ah, al = (p.numpy().astype(np.float64)
                  for p in split_tf32(torch.from_numpy(A)))
        acc = np.zeros((rows, L * H), np.float32)
        for d0 in range(0, D, 32):
            k = slice(d0, d0 + 32)
            part = (xh[sel, k] @ al[k] + xl[sel, k] @ ah[k]
                    + xh[sel, k] @ ah[k]).astype(np.float32)
            acc = (acc + part).astype(np.float32)
        out[sel] = acc
    return out.reshape(B, L, H)


@pytest.mark.parametrize("D", [48, 128])
def test_tc_route_is_within_2e4_of_fp64_and_free_of_row_order(D):
    """The route's sum order (by 32-deep k tiles, fixed by D alone) is held
    within 2e-4 of a float64 einsum; rows in another order give each row
    the same bits."""
    rng = np.random.default_rng(D)
    B, U, L, H = 157, 5, 3, 24
    x = rng.standard_normal((B, D)).astype(np.float32)
    table = rng.standard_normal((U, L, D, H)).astype(np.float32)
    idx = rng.integers(-1, U + 2, B)
    got = _tc_route(x, table, idx)
    want = np.einsum("bd,bldh->blh", x.astype(np.float64),
                     table[np.clip(idx, 0, U - 1)].astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    p = rng.permutation(B)
    np.testing.assert_array_equal(_tc_route(x[p], table, idx[p]), got[p])


# ---- din_attention: the wide route's prepared weights -----------------------
def test_din_plan_mirrors_the_source():
    """``din_plan`` is csrc ``wide_plan``: DIN's 73..80 x 33..40 in one
    group of 80 and one slice of 40, else 64 and 64; 32 fp32 (64 bf16)
    values a 128-byte row; an even count of W1d k tiles; tiles laid W1d
    first, then W2."""
    assert "p.n1 = din ? 80 : 64;" in DIN_SRC
    assert "p.n2 = din ? 40 : 64;" in DIN_SRC
    assert "p.kk = bf16 ? 64 : 32;" in DIN_SRC
    assert "return h1 > 72 && h1 <= 80 && h2 > 32 && h2 <= 40;" in DIN_SRC
    for D, h1, h2 in ((128, 80, 40), (65, 129, 65), (18, 2048, 1024),
                      (1024, 80, 40), (72, 136, 9)):
        for bf16 in (False, True):
            p = dops.din_plan(D, h1, h2, bf16)
            din = 72 < h1 <= 80 and 32 < h2 <= 40
            assert (p["n1"], p["n2"]) == ((80, 40) if din else (64, 64))
            assert p["kt1"] % 2 == 0 and p["kt1"] * p["kk"] >= D
            assert p["ng"] * p["n1"] >= h1 and p["ns"] * p["n2"] >= h2
            assert p["t1"] % 1024 == 0 and p["t2"] % 1024 == 0
            assert p["total"] == (p["t1"] * p["ng"] * p["kt1"]
                                  + p["t2"] * p["ns"] * p["ng"] * p["kt2"])
    p = dops.din_plan(128, 80, 40, False)
    assert (p["kt1"], p["kt2"], p["per_round"], p["total"]) \
        == (4, 3, 7, 4 * 20480 + 3 * 10240)


def _unswizzle(tile: np.ndarray) -> np.ndarray:
    """(n, kk) swizzled rows back to their values (the swizzle is its own
    inverse); bf16 bits as uint16."""
    if tile.dtype == np.uint16:
        t = torch.from_numpy(np.ascontiguousarray(tile).view(np.int16))
        return dops.swizzle_128(t).numpy().view(np.uint16)
    return dops.swizzle_128(torch.from_numpy(np.ascontiguousarray(tile))
                            ).numpy()


def _tiles(pw, bf16):
    """The prepared buffer as (W1 tiles (ng, kt1, parts, n1, kk), W2 tiles
    (ns, ng, kt2, parts, n2, kk))."""
    p = pw.plan
    dt = np.uint16 if bf16 else np.float32
    buf = pw.buf.numpy()
    w1 = buf[:p["w2_off"]].view(dt).reshape(p["ng"], p["kt1"], p["parts"],
                                            p["n1"], p["kk"])
    w2 = buf[p["w2_off"]:].view(dt).reshape(p["ns"], p["ng"], p["kt2"],
                                            p["parts"], p["n2"], p["kk"])
    return w1, w2


def _bf16_bits(a: torch.Tensor) -> np.ndarray:
    return a.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("D,h1,h2", [(128, 80, 40), (65, 129, 65),
                                     (18, 150, 70)])
def test_prepared_w1d_tiles_are_its_transpose_split(D, h1, h2, bf16):
    """W1d^T tile (g, kt), unswizzled: row n = hidden unit g n1 + n, column
    k = d = kt kk + k; fp32 as tf32 hi and lo with hi + lo = w to ~2^-22,
    bf16 the bits as they are; zeros past D and h1."""
    rng = np.random.default_rng(D + h1)
    w1 = torch.from_numpy(rng.standard_normal((4 * D, h1)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((h1, h2)).astype(np.float32))
    if bf16:
        w1, w2 = w1.bfloat16(), w2.bfloat16()
    pw = da.prepare_din_weights(w1, w2)
    p = pw.plan
    t1, _ = _tiles(pw, bf16)
    n1, kk = p["n1"], p["kk"]
    wdt = np.zeros((p["ng"] * n1, p["kt1"] * kk), np.float64)
    wd = w1[3 * D:].float().numpy().T
    wdt[:h1, :D] = wd
    for g in range(p["ng"]):
        for kt in range(p["kt1"]):
            want = wdt[g * n1:(g + 1) * n1, kt * kk:(kt + 1) * kk]
            parts = [_unswizzle(t1[g, kt, i]) for i in range(p["parts"])]
            if bf16:
                ref = torch.from_numpy(want.astype(np.float32)).bfloat16()
                np.testing.assert_array_equal(parts[0], _bf16_bits(ref))
            else:
                hi, lo = parts
                np.testing.assert_array_equal(
                    hi, tf32_round(torch.from_numpy(
                        want.astype(np.float32))).numpy())
                np.testing.assert_allclose(hi.astype(np.float64) + lo, want,
                                           rtol=2 ** -21, atol=0)


def _gemm2_by_fragments(c1: np.ndarray, tiles: np.ndarray, p: dict,
                        bf16: bool) -> np.ndarray:
    """GEMM 2 of one m64 tile and one (slice, group) as the kernel feeds
    it: each thread's A registers taken from GEMM 1's accumulator as it
    lies (fp32: k step j = n tile j, registers 4j, 4j + 2, 4j + 1, 4j + 3
    at k t, t (row + 8), t + 4, t + 4 (row + 8); bf16: k16 step p = n tiles
    2p and 2p + 1 as they lie), the B rows from the unswizzled W2 tiles;
    returns the (64, n2) product."""
    n1, n2, kk = p["n1"], p["n2"], p["kk"]
    B = np.concatenate([_unswizzle(tiles[kt, 0]).astype(np.float64)
                        if not bf16 else
                        torch.from_numpy(_unswizzle(tiles[kt, 0]).view(
                            np.int16)).view(torch.bfloat16).float().numpy()
                        for kt in range(tiles.shape[0])], axis=1)  # (n2, k)
    out = np.zeros((64, n2))
    for warp in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            r0 = warp * 16 + g
            # accumulator register 4j + 2h + e = C1[r0 + 8h, 8j + 2t + e]
            acc = {4 * j + 2 * h + e: c1[r0 + 8 * h, 8 * j + 2 * t + e]
                   for j in range(n1 // 8) for h in range(2)
                   for e in range(2)}
            for r, h in ((r0, 0), (r0 + 8, 1)):
                if not bf16:
                    for j in range(n1 // 8):
                        # A (row, k) of k step j: a0 (g, t), a1 (g + 8, t),
                        # a2 (g, t + 4), a3 (g + 8, t + 4)
                        a_kt = acc[4 * j + 2 * h]          # k = 8j + t
                        a_kt4 = acc[4 * j + 2 * h + 1]     # k = 8j + t + 4
                        out[r] += a_kt * B[:, 8 * j + t] \
                            + a_kt4 * B[:, 8 * j + t + 4]
                else:
                    for pp in range(n1 // 16):
                        # a0 (g, 2t..2t+1), a1 (g + 8, ..), a2 (g, 2t + 8..),
                        # a3 (g + 8, 2t + 8..) from n tiles 2pp, 2pp + 1
                        for half in range(2):
                            for e in range(2):
                                v = acc[4 * (2 * pp + half) + 2 * h + e]
                                k = 16 * pp + 8 * half + 2 * t + e
                                out[r] += v * B[:, k]
    # each (row, k) above is counted once per thread that holds it: the
    # four lanes t of a row each add their own k columns
    return out


@pytest.mark.parametrize("bf16", [False, True])
def test_prepared_w2_rows_meet_gemm1s_accumulator(bf16):
    """GEMM 2 fed from GEMM 1's accumulator registers as they lie, against
    the prepared W2 tiles of a (slice, group), is relu(C1) W2: fp32 needs
    W2's rows permuted inside each 8 (k t <- 2t, k t + 4 <- 2t + 1), bf16
    none (two n8 columns of C1 are a k16 step)."""
    rng = np.random.default_rng(7)
    D, h1, h2 = 64, 80, 40                   # DIN's instance: n1 80, n2 40
    w1 = torch.from_numpy(rng.standard_normal((4 * D, h1)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((h1, h2)).astype(np.float32))
    c1 = np.maximum(rng.standard_normal((64, h1)), 0)
    if bf16:
        w1, w2 = w1.bfloat16(), w2.bfloat16()
    pw = da.prepare_din_weights(w1, w2)
    _, t2 = _tiles(pw, bf16)
    got = _gemm2_by_fragments(c1, t2[0, 0], pw.plan, bf16)
    if bf16:
        want = c1 @ w2.float().numpy()
    else:
        hi = tf32_round(w2).numpy().astype(np.float64)
        want = c1 @ hi                       # the hi part the model reads
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    assert dops.w2_k_rows(80, 32, 3, False)[:8].tolist() \
        == [0, 2, 4, 6, 1, 3, 5, 7]
    assert (dops.w2_k_rows(80, 32, 3, False)[80:] == -1).all()


def test_din_gemm1_a_fragment_and_banks():
    """GEMM 1's A of k step kk: warp w's pairs (its query row against keys
    l0 + g and l0 + g + 8) as a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3
    (g + 8, t + 4) with d = 8 kk + t: the staged keys (row stride dk + 4)
    are read at 32 distinct banks per register."""
    D = 128
    ks = (D + 7) // 8 * 8 + 4
    assert re.search(r"o\.ks = bf16 \? .* : o\.dk \+ 4;", DIN_SRC)
    for kk in range(4):
        for r in range(4):
            banks = set()
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                key = g + 8 * (r & 1)
                d = 8 * kk + t + 4 * (r >> 1)
                banks.add((key * ks + d) % 32)
            assert len(banks) == 32
