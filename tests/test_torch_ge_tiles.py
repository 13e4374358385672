"""The index arithmetic of ``csrc/gather_einsum.cu``'s bf16 tensor-core
``bd,uldh->blh`` (``q_t_mma_kernel``) and of ``blh,uh->bl``'s sum order,
modelled on the CPU (no nvcc here): the ``ldmatrix.trans`` addresses of
``qm_mma``, the B fragments of ``qm_b`` and the C staging of ``qm_store``
against the ``mma.sync`` fragment layouts of the PTX ISA, their shared
memory banks, and ``rows_vec_kernel``'s order of sums (which depends on H
alone). The layout constants are read from the source."""
from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import gather_einsum as ge

SRC = (build.CSRC / "gather_einsum.cu").read_text()


def _const(name: str) -> int:
    expr = re.search(rf"constexpr int {name} = ([^;]+);", SRC).group(1)
    names = {n: _const(n) for n in re.findall(r"[A-Z][A-Z_0-9]+", expr)}
    return int(eval(expr, {}, names))


KC, TS, XS, OS = (_const(n) for n in ("QM_KC", "QM_TS", "QM_XS", "QM_OS"))
COLS, RPW = _const("QT_COLS"), _const("QT_RPW")
RV_G, RV_V = _const("RV_G"), _const("RV_V")


def _a_addresses(lane: int, mt: int) -> tuple[int, int]:
    """``qm_mma``'s ldmatrix row addresses (bf16 elements from the slice)
    of ``lane`` for m16 tile ``mt``: the x4 (k16) and the x2 (k8)."""
    col = ((lane >> 3) & 1) * 8
    a16 = (((lane >> 4) << 3) + (lane & 7)) * TS + col + 16 * mt
    a8 = (16 + (lane & 7)) * TS + col + 16 * mt
    return a16, a8


def _ldsm_trans(mem: np.ndarray, addrs: list[int], nmat: int):
    """``ldmatrix.m8n8.trans``: lane l's registers, each the pair (M[2t][g],
    M[2t + 1][g]) of matrix i (rows from lanes 8 i .. 8 i + 7), t = l % 4,
    g = l / 4."""
    regs = []
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        regs.append([(mem[addrs[8 * i + 2 * t] + g],
                      mem[addrs[8 * i + 2 * t + 1] + g])
                     for i in range(nmat)])
    return regs


def test_qm_constants_fit_the_mma_shapes():
    """A chunk is one k16 and one k8 step; a tile is 4 m16 tiles of the
    warp's n8 rows; the padded strides keep 16-byte rows."""
    assert KC == 16 + 8 and COLS == 4 * 16 and RPW == 8
    assert (2 * TS) % 16 == 0 and (2 * OS) % 16 == 0 and (2 * XS) % 4 == 0


@pytest.mark.parametrize("mt", range(4))
def test_qm_a_fragments_are_the_slice_transposed(mt):
    """From a staged slice S[d, column] (row stride QM_TS), the x4.trans
    registers are A[m][k] = S[k][16 mt + m] in the m16n8k16 order a0 (g,
    2t), a1 (g + 8, 2t), a2 (g, 2t + 8), a3 (g + 8, 2t + 8), and the
    x2.trans registers the m16n8k8 A of k = 16 .. 23."""
    rng = np.random.default_rng(mt)
    S = rng.integers(0, 1 << 15, size=(KC, TS))
    mem = S.reshape(-1)
    r16 = _ldsm_trans(mem, [_a_addresses(l, mt)[0] for l in range(32)], 4)
    r8 = _ldsm_trans(mem, [_a_addresses(l, mt)[1] for l in range(32)], 2)
    A = S[:, 16 * mt:16 * mt + 16].T            # (m16, k24)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        want16 = [(A[g, 2 * t], A[g, 2 * t + 1]),
                  (A[g + 8, 2 * t], A[g + 8, 2 * t + 1]),
                  (A[g, 2 * t + 8], A[g, 2 * t + 9]),
                  (A[g + 8, 2 * t + 8], A[g + 8, 2 * t + 9])]
        want8 = [(A[g, 16 + 2 * t], A[g, 17 + 2 * t]),
                 (A[g + 8, 16 + 2 * t], A[g + 8, 17 + 2 * t])]
        assert r16[lane] == want16 and r8[lane][:2] == want8


def test_qm_ldmatrix_rows_fall_in_distinct_banks():
    """Each 8 x 8 matrix's 8 row addresses (16 bytes each) cover all 32
    banks once: the QM_TS padding."""
    for mt in range(4):
        for which in (0, 1):
            addrs = [_a_addresses(l, mt)[which] for l in range(32)]
            for i in range(4 if which == 0 else 2):
                banks = {((2 * addrs[8 * i + r]) // 4 + w) % 32
                         for r in range(8) for w in range(4)}
                assert len(banks) == 32


def test_qm_b_fragments_and_banks():
    """``qm_b``: lane (g, t) reads the warp's row g of the staged x at k =
    2t (b0), 2t + 8 (b1) and 16 + 2t (the k8 b0), the m16n8k16 / m16n8k8 B
    layouts; for 8 consecutive rows the 32 lanes' words fall in distinct
    banks (QM_XS)."""
    for k0 in (0, 8, 16):
        banks = set()
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            elem = g * XS + 2 * t + k0            # row g's x, k = k0 + 2t
            assert elem % 2 == 0                  # a 4-byte aligned pair
            banks.add((elem // 2) % 32)
        assert len(banks) == 32


def test_qm_store_staging_puts_c_at_row_column():
    """``qm_store``: C register e of lane (g, t) in m16 tile mt is (column
    16 mt + g + 8 (e >= 2), row 2t + (e & 1)) of the warp's 8 x 64 tile
    (the m16n8 C layout with m the column, n the row); the staging holds
    every element once, and each lane then copies 16 bytes of one row."""
    seen = {}
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for mt in range(4):
            base = 2 * t * OS + 16 * mt + g
            for e, off in enumerate((0, OS, 8, OS + 8)):
                pos = base + off
                row, col = divmod(pos, OS)
                assert (row, col) == (2 * t + (e & 1),
                                      16 * mt + g + 8 * (e >> 1))
                assert pos not in seen
                seen[pos] = (lane, mt, e)
    assert len(seen) == RPW * COLS
    reads = sorted((lane >> 3) + 4 * h for lane in range(32) for h in (0, 1))
    assert reads == sorted(list(range(RPW)) * 8)


def _rows_vec_order(x: np.ndarray, t: np.ndarray) -> np.float32:
    """``rows_vec_kernel``'s sum of one row in float32: lane j takes
    chunks c = j, j + 8, ... of 8 values (zeros past H), fmaf from 0,
    then the tree ((0+4)+(2+6)) + ((1+5)+(3+7))."""
    H = x.shape[0]
    nchunk = -(-H // RV_V)
    pad = np.zeros(nchunk * RV_V, np.float32)
    xp, tp = pad.copy(), pad.copy()
    xp[:H], tp[:H] = x, t
    part = []
    for j in range(RV_G):
        acc = np.float32(0)
        for c in range(j, nchunk, RV_G):
            for i in range(RV_V):     # fmaf, modelled in float64
                acc = np.float32(np.float64(xp[c * RV_V + i])
                                 * np.float64(tp[c * RV_V + i])
                                 + np.float64(acc))
        part.append(acc)
    for w in (4, 2, 1):
        part = [np.float32(part[j] + part[j ^ w]) for j in range(RV_G)]
    assert len({float(p) for p in part}) == 1   # every lane the same sum
    return part[0]


@pytest.mark.parametrize("H", [1, 3, 80, 81, 128, 257])
def test_rows_vec_order_is_within_tolerance_of_einsum(H):
    """The order the kernel sums in (a function of H alone) against the
    plain version: fp32 2e-4 holds, and the tree leaves every lane of a
    row the same bits (each level's two partners add the same two
    values)."""
    rng = np.random.default_rng(H)
    B, L, U = 3, 5, 4
    x = rng.standard_normal((B, L, H)).astype(np.float32)
    t = rng.standard_normal((U, H)).astype(np.float32)
    idx = np.array([0, 3, 7], np.int32)
    want = ge.gather_einsum_plain("blh,uh->bl", torch.from_numpy(x),
                                  torch.from_numpy(t),
                                  torch.from_numpy(idx)).numpy()
    got = np.array([[_rows_vec_order(x[b, l], t[min(idx[b], U - 1)])
                     for l in range(L)] for b in range(B)])
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
