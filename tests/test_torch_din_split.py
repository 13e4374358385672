"""The arithmetic of the ``din_attention`` CUDA kernel, emulated on the CPU.

The kernel splits DIN's first layer,
``[k, q, k-q, k*q] W1 = k (W1a + W1c) + q (W1b - W1c) + (k*q) W1d``, and runs
the two per-pair products ((k*q) W1d and layer 2) on the tensor cores as
3xTF32 (``split_tf32``: hi = tf32(a), lo = tf32(a - hi); lo*hi + hi*lo +
hi*hi). ``_emulate`` repeats that arithmetic with CPU matmuls; it is a test
helper, nothing on the main path calls it. It is held against the JAX
reference's ``din_attention_ref`` at fp32 rtol = atol = 2e-4, and a single
TF32 pass is shown to miss that tolerance at DIN width. A numpy model of
``mma.sync.m16n8k8`` tf32 fragments (the PTX ISA's layouts) checks the
kernel's fragment indexing: GEMM 1's A fragment formed from k and q, the B
fragments' order in shared memory, and GEMM 1's C fragment reused as GEMM
2's A fragment against W2's permuted rows. ``_online`` repeats the
kernel's chunked online softmax (keys streamed in chunks, a running max,
sum and pooled sum rescaled as the max rises), held against
``din_attention_ref`` past the 920 keys one block once held. The bf16
instance's fragments (``mma.sync`` m16n8k8 and m16n8k16 bf16: two of
GEMM 1's C fragments as GEMM 2's A, W2 unpermuted) are modelled the same
way.
"""
import numpy as np
import pytest
import torch

from repro.kernels.din_attention.ref import din_attention_ref
from repro_torch.kernels import din_attention as da
from repro_torch.kernels.mari_matmul.ops import split_tf32, tf32_round

TOL = dict(rtol=2e-4, atol=2e-4)
DIN_WIDTH = (256, 100, 18, 80, 40)      # B, L, D, h1, h2 (configs/din.py)


def _case(B, L, D, h1=16, h2=8, seed=0):
    """tests/test_kernels.py::TestDinAttention's inputs, from numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    mask = rng.random(L) < 0.8
    mask[0] = True
    return (f(B, D), f(L, D), mask, f(4 * D, h1) * 0.2, f(h1) * 0.1,
            f(h1, h2) * 0.2, f(h2) * 0.1, f(h2, 1) * 0.2, f(1) * 0.1)


def _product(a, w, passes):
    """a @ w as the tensor cores run it: one TF32 pass, or 3xTF32."""
    if passes == 1:
        return tf32_round(a) @ tf32_round(w)
    ah, al = split_tf32(a)
    wh, wl = split_tf32(w)
    return al @ wh + ah @ wl + ah @ wh


def _emulate(query, keys, mask, w1, b1, w2, b2, w3, b3, passes=3):
    """The kernel's arithmetic on CPU tensors: (scores (B, L), out (B, D))."""
    D = query.shape[1]
    wa, wb, wc, wd = (w1[i * D:(i + 1) * D] for i in range(4))
    k1 = keys @ (wa + wc) + b1                   # once per key
    q1 = query @ (wb - wc)                       # once per query row
    kq = keys[None] * query[:, None]             # (B, L, D)
    h = torch.relu(k1[None] + q1[:, None] + _product(kq, wd, passes))
    h = torch.relu(b2 + _product(h, w2, passes))
    scores = (h @ w3)[..., 0] + b3
    masked = torch.where(mask[None], scores, torch.full_like(scores, -1e30))
    return scores, torch.softmax(masked, -1) @ keys


def _online(scores, mask, keys, chunk):
    """The kernel's softmax and pool over chunks of ``chunk`` keys, in its
    order: per chunk the masked scores' max m, the running sum and pooled
    keys rescaled by exp(m_old - m), then the chunk's exp(score - m) and
    their pooled keys; the output is pooled / sum."""
    s = torch.where(mask[None], scores, torch.full_like(scores, -1e30))
    B, L = s.shape
    m = torch.full((B, 1), float("-inf"))
    total = torch.zeros(B, 1)
    acc = torch.zeros(B, keys.shape[1])
    for c0 in range(0, L, chunk):
        sc = s[:, c0:c0 + chunk]
        m_new = torch.maximum(m, sc.max(1, keepdim=True).values)
        scale = torch.exp(m - m_new)        # 0 for the first chunk
        e = torch.exp(sc - m_new)
        total = total * scale + e.sum(1, keepdim=True)
        acc = acc * scale + e @ keys[c0:c0 + chunk]
        m = m_new
    return acc / total


def _torch(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


def _scores_fp64(query, keys, mask, w1, b1, w2, b2, w3, b3):
    """The unsplit unit in fp64: the oracle of the scores."""
    q, k, w1, b1, w2, b2, w3, b3 = (t.double() for t in
                                    (query, keys, w1, b1, w2, b2, w3, b3))
    B, L = q.shape[0], k.shape[0]
    kk, qq = k[None].expand(B, L, -1), q[:, None].expand(B, L, -1)
    feats = torch.cat([kk, qq, kk - qq, kk * qq], -1)
    h = torch.relu(torch.relu(feats @ w1 + b1) @ w2 + b2)
    return (h @ w3)[..., 0] + b3


def test_split_first_layer_equals_the_full_first_layer():
    q, k, _, w1, b1, *_ = (t.double() if t.dtype == torch.float32 else t
                           for t in _torch(_case(7, 11, 18, 80, 40, seed=5)))
    D = q.shape[1]
    kk, qq = k[None].expand(7, 11, D), q[:, None].expand(7, 11, D)
    full = torch.cat([kk, qq, kk - qq, kk * qq], -1) @ w1 + b1
    wa, wb, wc, wd = (w1[i * D:(i + 1) * D] for i in range(4))
    split = ((k @ (wa + wc) + b1)[None] + (q @ (wb - wc))[:, None]
             + (kk * qq) @ wd)
    np.testing.assert_allclose(split.numpy(), full.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("B,L,D,h1,h2", [(4, 5, 8, 16, 8), (33, 20, 18, 16, 8),
                                         (128, 100, 18, 16, 8), DIN_WIDTH,
                                         (40, 37, 33, 128, 64)])
def test_emulation_matches_reference(B, L, D, h1, h2):
    """The split layer and 3xTF32 products hold the JAX reference's oracle
    and the port's plain version within fp32 2e-4."""
    args = _case(B, L, D, h1, h2, seed=B + L)
    _, got = _emulate(*_torch(args))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(din_attention_ref(*args)), **TOL)
    np.testing.assert_allclose(got.numpy(),
                               da.din_attention_plain(*_torch(args)).numpy(),
                               **TOL)


def test_3xtf32_keeps_fp32_tolerance_one_tf32_pass_does_not():
    """At DIN width the 3xTF32 scores are within 2e-4 of an fp64 oracle and
    the pooled output within it of the reference; one TF32 pass misses
    both — which is why the kernel splits."""
    args = _case(*DIN_WIDTH, seed=1)
    t = _torch(args)
    oracle = _scores_fp64(*t)
    ref = torch.from_numpy(np.array(din_attention_ref(*args)))

    def worst(got, want):        # max |d| / (atol + rtol |want|)
        return float(((got.double() - want.double()).abs()
                      / (TOL["atol"] + TOL["rtol"] * want.double().abs()))
                     .max())

    s3, o3 = _emulate(*t, passes=3)
    s1, o1 = _emulate(*t, passes=1)
    assert worst(s3, oracle) <= 0.05 and worst(o3, ref) <= 0.05
    assert worst(s1, oracle) > 1.0 and worst(o1, ref) > 1.0


# -- mma.sync.m16n8k8 tf32 fragments (PTX ISA), lane = 4 g + t ---------------
G, T = np.arange(32) // 4, np.arange(32) % 4


def _mma(c, a, b):
    """c (32, 4) += a (32, 4) x b (32, 2), each a lane's fragment."""
    A = np.zeros((16, 8))
    A[G, T], A[G + 8, T], A[G, T + 4], A[G + 8, T + 4] = a.T
    Bm = np.zeros((8, 8))
    Bm[T, G], Bm[T + 4, G] = b.T
    C = np.zeros((16, 8))
    C[G, 2 * T], C[G, 2 * T + 1], C[G + 8, 2 * T], C[G + 8, 2 * T + 1] = c.T
    C = C + A @ Bm
    return np.stack([C[G, 2 * T], C[G, 2 * T + 1], C[G + 8, 2 * T],
                     C[G + 8, 2 * T + 1]], 1)


@pytest.mark.parametrize("L,D,h1,h2,l0", [(100, 18, 80, 40, 96),
                                          (37, 33, 128, 64, 16),
                                          (5, 8, 16, 8, 0)])
def test_mma_fragments_compute_the_two_products(L, D, h1, h2, l0):
    """One warp task (a query row against keys l0..l0+15, rows past L
    clamped) through the kernel's fragment indexing gives the unit's scores
    (fp64, no split: this checks indices, not rounding)."""
    q, k, _, w1, b1, w2, b2, w3, b3 = (a.astype(np.float64)
                                       for a in _case(1, L, D, h1, h2))
    dk, nt1, nt2 = -(-D // 8) * 8, -(-h1 // 8), -(-h2 // 8)
    kp = np.zeros((L, dk))
    kp[:, :D] = k
    qp = np.zeros(dk)
    qp[:D] = q[0]
    wd = np.zeros((dk, nt1 * 8))
    wd[:D, :h1] = w1[3 * D:]
    w2p = np.zeros((nt1 * 8, nt2 * 8))
    w2p[:h1, :h2] = w2
    k1 = np.zeros((L, nt1 * 8))
    k1[:, :h1] = k @ (w1[:D] + w1[2 * D:3 * D]) + b1
    q1 = np.zeros(nt1 * 8)
    q1[:h1] = q[0] @ (w1[D:2 * D] - w1[2 * D:3 * D])
    la, lb = np.minimum(l0 + G, L - 1), np.minimum(l0 + G + 8, L - 1)

    c1 = []
    for j in range(nt1):
        col = j * 8 + 2 * T
        c1.append(np.stack([k1[la, col] + q1[col], k1[la, col + 1] + q1[col + 1],
                            k1[lb, col] + q1[col], k1[lb, col + 1] + q1[col + 1]],
                           1))
    for kt in range(dk // 8):
        d0, d1 = kt * 8 + T, kt * 8 + T + 4
        a = np.stack([kp[la, d0] * qp[d0], kp[lb, d0] * qp[d0],
                      kp[la, d1] * qp[d1], kp[lb, d1] * qp[d1]], 1)
        for j in range(nt1):                  # sB1[(kt nt1 + j) 32 + lane]
            n = j * 8 + G
            c1[j] = _mma(c1[j], a, np.stack([wd[d0, n], wd[d1, n]], 1))
    c2 = [np.stack([np.r_[b2, np.zeros(nt2 * 8 - h2)][j * 8 + 2 * T + i]
                    for i in (0, 1, 0, 1)], 1) for j in range(nt2)]
    for kt in range(nt1):
        h = np.maximum(c1[kt], 0.0)
        a = h[:, [0, 2, 1, 3]]                # C fragment as the A fragment
        r0 = kt * 8 + 2 * T
        for j in range(nt2):                  # W2's rows permuted: 2t, 2t+1
            n = j * 8 + G
            c2[j] = _mma(c2[j], a, np.stack([w2p[r0, n], w2p[r0 + 1, n]], 1))
    w3p = np.r_[w3[:, 0], np.zeros(nt2 * 8 - h2)]
    sa = sum(np.maximum(c2[j][:, i], 0) * w3p[j * 8 + 2 * T + i % 2]
             for j in range(nt2) for i in (0, 1))
    sb = sum(np.maximum(c2[j][:, i], 0) * w3p[j * 8 + 2 * T + i % 2]
             for j in range(nt2) for i in (2, 3))
    sa, sb = sa.reshape(8, 4).sum(1) + b3, sb.reshape(8, 4).sum(1) + b3

    q, k, w1, b1, w2, b2, w3, b3 = _torch((q, k, w1, b1, w2, b2, w3, b3))
    want = _scores_fp64(q, k, None, w1, b1, w2, b2, w3, b3)[0].numpy()
    np.testing.assert_allclose(sa, want[la[::4]], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(sb, want[lb[::4]], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("chunk", [112, 32])
@pytest.mark.parametrize("L", [921, 2000])
def test_online_softmax_matches_reference_past_one_block(L, chunk):
    """The kernel's chunks (112 keys at DIN width, 32 at its widest tiles)
    over histories past the 920 keys a block once held: the emulated
    scores through ``_online`` within fp32 2e-4 of the JAX reference."""
    args = _case(8, L, 18, 80, 40, seed=L)
    t = _torch(args)
    scores, _ = _emulate(*t)
    got = _online(scores, t[2], t[1], chunk)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(din_attention_ref(*args)), **TOL)


def test_online_softmax_masked_chunks():
    """A history whose first chunks are all masked (their -1e30 scores
    leave the sums once a real score raises the max), and one masked
    throughout (every key weighs the same, as the reference's softmax over
    -1e30 gives)."""
    args = list(_case(4, 500, 18, 16, 8, seed=2))
    args[2][:300] = False
    t = _torch(args)
    scores, _ = _emulate(*t)
    np.testing.assert_allclose(_online(scores, t[2], t[1], 112).numpy(),
                               np.asarray(din_attention_ref(*args)), **TOL)
    none = torch.zeros_like(t[2])
    np.testing.assert_allclose(
        _online(scores, none, t[1], 112).numpy(),
        t[1].mean(0).expand(4, -1).numpy(), **TOL)


# ---- the bf16 tensor-core instance: m16n8k8 (GEMM 1), m16n8k16 (GEMM 2)

def _mma_bf16(c, a, b):
    """c (32, 4) += A x B for mma.sync m16n8k8 / m16n8k16 bf16 (the PTX
    ISA's layouts): a (32, regs, 2), register r holding row G + 8 (r % 2)
    at columns 2T + e + 8 (r // 2); b (32, regs, 2), register r holding k
    rows 2T + e + 8 r of column G."""
    k = 8 * a.shape[1] // 2
    A = np.zeros((16, k))
    for r in range(a.shape[1]):
        for e in (0, 1):
            A[G + 8 * (r % 2), 2 * T + e + 8 * (r // 2)] = a[:, r, e]
    Bm = np.zeros((k, 8))
    for r in range(b.shape[1]):
        for e in (0, 1):
            Bm[2 * T + e + 8 * r, G] = b[:, r, e]
    C = np.zeros((16, 8))
    C[G, 2 * T], C[G, 2 * T + 1], C[G + 8, 2 * T], C[G + 8, 2 * T + 1] = c.T
    C = C + A @ Bm
    return np.stack([C[G, 2 * T], C[G, 2 * T + 1], C[G + 8, 2 * T],
                     C[G + 8, 2 * T + 1]], 1)


@pytest.mark.parametrize("L,D,h1,h2,l0", [(100, 18, 80, 40, 96),
                                          (37, 33, 128, 64, 16),
                                          (5, 8, 16, 8, 0),
                                          (7, 6, 12, 5, 0)])
def test_bf16_mma_fragments_compute_the_two_products(L, D, h1, h2, l0):
    """The bf16 instance's warp task through its fragment indexing: GEMM
    1's A (k*q at rows la, lb, columns 8 kt + 2t, + 1), W1d's B fragments
    (k rows 8 kt + 2t, + 1 of column 8 j + g), and two n tiles of GEMM
    1's C packed as GEMM 2's k16 A fragment as they lie, against W2's
    rows 16 s + 2t, + 1, + 8, + 9 unpermuted (h1 padded to 16). fp64, no
    rounding: this checks indices, not arithmetic."""
    q, k, _, w1, b1, w2, b2, w3, b3 = (a.astype(np.float64)
                                       for a in _case(1, L, D, h1, h2))
    dk, h1p, nt2 = -(-D // 8) * 8, -(-h1 // 16) * 16, -(-h2 // 8)
    nt1, kt2 = h1p // 8, h1p // 16
    kp = np.zeros((L, dk))
    kp[:, :D] = k
    qp = np.zeros(dk)
    qp[:D] = q[0]
    wd = np.zeros((dk, h1p))
    wd[:D, :h1] = w1[3 * D:]
    w2p = np.zeros((h1p, nt2 * 8))
    w2p[:h1, :h2] = w2
    k1 = np.zeros((L, h1p))
    k1[:, :h1] = k @ (w1[:D] + w1[2 * D:3 * D]) + b1
    q1 = np.zeros(h1p)
    q1[:h1] = q[0] @ (w1[D:2 * D] - w1[2 * D:3 * D])
    la, lb = np.minimum(l0 + G, L - 1), np.minimum(l0 + G + 8, L - 1)

    a1 = []
    for kt in range(dk // 8):
        d = kt * 8 + 2 * T
        a1.append(np.stack([np.stack([kp[la, d + e] * qp[d + e]
                                      for e in (0, 1)], 1),
                            np.stack([kp[lb, d + e] * qp[d + e]
                                      for e in (0, 1)], 1)], 1))
    c2 = [np.stack([np.r_[b2, np.zeros(nt2 * 8 - h2)][j * 8 + 2 * T + i]
                    for i in (0, 1, 0, 1)], 1) for j in range(nt2)]
    for s in range(kt2):
        h = []
        for u in (0, 1):
            j = 2 * s + u
            col = j * 8 + 2 * T
            c1 = np.stack([k1[la, col] + q1[col], k1[la, col + 1] + q1[col + 1],
                           k1[lb, col] + q1[col], k1[lb, col + 1] + q1[col + 1]],
                          1)
            for kt in range(dk // 8):     # sB1[(kt nt1 + j) 32 + lane]
                n = j * 8 + G
                b = np.stack([wd[kt * 8 + 2 * T + e, n] for e in (0, 1)], 1)
                c1 = _mma_bf16(c1, a1[kt], b[:, None, :])
            h.append(np.maximum(c1, 0.0))
        # registers: (g, 2t..) (g + 8, 2t..) of n tile 2s, then of 2s + 1
        a = np.stack([h[0][:, 0:2], h[0][:, 2:4], h[1][:, 0:2],
                      h[1][:, 2:4]], 1)
        for j in range(nt2):              # sB2[(s nt2 + j) 32 + lane]
            n = j * 8 + G
            r0 = 16 * s + 2 * T
            b = np.stack([np.stack([w2p[r0 + e, n] for e in (0, 1)], 1),
                          np.stack([w2p[r0 + 8 + e, n] for e in (0, 1)], 1)],
                         1)
            c2[j] = _mma_bf16(c2[j], a, b)
    w3p = np.r_[w3[:, 0], np.zeros(nt2 * 8 - h2)]
    sa = sum(np.maximum(c2[j][:, i], 0) * w3p[j * 8 + 2 * T + i % 2]
             for j in range(nt2) for i in (0, 1))
    sb = sum(np.maximum(c2[j][:, i], 0) * w3p[j * 8 + 2 * T + i % 2]
             for j in range(nt2) for i in (2, 3))
    sa, sb = sa.reshape(8, 4).sum(1) + b3, sb.reshape(8, 4).sum(1) + b3

    q, k, w1, b1, w2, b2, w3, b3 = _torch((q, k, w1, b1, w2, b2, w3, b3))
    want = _scores_fp64(q, k, None, w1, b1, w2, b2, w3, b3)[0].numpy()
    np.testing.assert_allclose(sa, want[la[::4]], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(sb, want[lb[::4]], rtol=1e-12, atol=1e-12)
    if (D, h1, h2) == (18, 80, 40):       # mma a 16-key tile at DIN width
        assert (dk // 8) * nt1 + kt2 * nt2 * 2 == 80
