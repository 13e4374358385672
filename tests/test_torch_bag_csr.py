"""The CSR preparation of ``embedding_bag`` (a stable counting sort by
segment on the card), its index arithmetic modelled in numpy.

``csrc/embedding_bag.cu`` ``embedding_bag_csr_prep`` runs on the card only,
as one cooperative launch of one 512-thread block an SM: (A) each tile's
keys checked in order, the bag boundaries of the tiles in order written
(``offsets[k] = i`` for ``key[i - 1] < k <= key[i]``), and, when every
tile is, the flag ``in_order`` set and nothing else done; otherwise (B)
tile histograms, a scan of each 32-key chunk over the tiles by the block
that owns the chunk's run, and (C) a scan of the runs' sums and a stable
scatter in which up to 8 warps rank contiguous parts of a tile in 32-id
steps (running count per key plus the lower lanes with the same key: the
count read where the step's keys all differ, which each lane finds by
writing its lane beside the count; else one ballot per bit of S + 1),
each id adding its key's ids in the earlier parts. ``_prep`` repeats that integer arithmetic step by step; it
is held against ``np.argsort(kind="stable")`` and against
``csr_prep_plain`` (the sort-based preparation) on sorted, shuffled,
empty-bag and out-of-range segment ids at S = 1, 4096 and 100,000, with
the tile plan of ``csr_plan`` for the H100's 132 blocks, and with fewer
blocks than tiles. Last, the port's ``embedding_bag`` (its plain version
on the CPU) is held against the reference's Pallas kernel in interpret
mode at fp32 rtol = atol = 2e-4.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import embedding_bag as j_bag_pallas
from repro_torch.kernels import build
from repro_torch.kernels import embedding_bag as eb

TOL = dict(rtol=2e-4, atol=2e-4)       # tests/test_kernels.py:21, fp32
H100_SMS = 132
_CONST = dict(re.findall(r"constexpr int (\w+) = ([\d *]+);",
                         (build.CSRC / "embedding_bag.cu").read_text()))
THREADS, MAX_RANK_WARPS, SMEM = (eval(_CONST[k]) for k in (
    "kPrepThreads", "kMaxRankWarps", "kPrepSmem"))
WARPS = THREADS // 32


def _bits(S):
    """Ballots a step: the bit length of S + 1 (keys -1 .. S as 0 .. S+1)."""
    return int(S + 1).bit_length()


def _match(keys, bits):
    """match_key: per lane, the mask of lanes with its key, one ballot per
    bit of key + 1."""
    k = keys.astype(np.int64) + 1
    lanes = np.int64(1) << np.arange(len(keys), dtype=np.int64)
    m = np.full(len(keys), 0xFFFFFFFF, np.int64)
    for b in range(bits):
        bit = (k >> b) & 1
        bal = int((bit * lanes).sum())
        m &= np.where(bit == 1, bal, ~bal & 0xFFFFFFFF)
    return m


def _rank_warps(S, tile, blocks):
    """The kernel's rank_warps: per-warp counts beside a tile's keys,
    ranks and row and the blocks' first positions."""
    fixed = (4 * (-(-blocks // 4) * 4) + 4 * tile + 2 * (-(-tile // 8) * 8)
             + 16 + 4 * (S + 1))
    return max(0, min(MAX_RANK_WARPS, (SMEM - fixed) // (4 * (S + 1))))


def _walk(keys, cnt, bits, tagged=True, steps=None):
    """A warp's 32-id steps over keys (-1: no id) with running counts cnt
    per key: each id's rank among its key's ids, cnt updated. tagged (the
    ranking warps in shared memory): each lane writes its lane beside its
    key's count; where every lane reads its own back the ranks are the
    counts read and the ballots are skipped. steps: counts of the steps
    that skipped ("tagged") and that ballot ("ballots")."""
    ranks = np.zeros(len(keys), np.int64)
    lanes = np.arange(32)
    for c0 in range(0, len(keys), 32):
        k = np.full(32, -1, np.int64)
        n = min(32, len(keys) - c0)
        k[:n] = keys[c0:c0 + n]
        valid = k >= 0
        start = cnt[np.where(valid, k, 0)]
        tag = {}
        for lane in np.flatnonzero(valid):      # a write of each key wins
            tag[k[lane]] = lane
        lost = [valid[lane] and tag[k[lane]] != lane for lane in lanes]
        if tagged and not any(lost):
            ranks[c0:c0 + n] = start[:n]
            cnt[k[valid]] += 1
            if steps is not None:
                steps["tagged"] += 1
            continue
        if steps is not None:
            steps["ballots"] += 1
        same = _match(k, bits)
        below = np.bitwise_count(same & ((1 << lanes) - 1))
        ranks[c0:c0 + n] = (start + below)[:n]
        for key_, size in zip(*np.unique(k[valid], return_counts=True)):
            cnt[key_] += size                   # the lanes' one value
    return ranks


def _prep(seg, S, blocks=H100_SMS):
    """(in_order, positions, offsets) as the cooperative launch computes
    them: positions[i] is where id i lands (the identity when in order)."""
    nnz, K = len(seg), S + 1
    keys = np.where((seg >= 0) & (seg < S), seg, S).astype(np.int64)
    tile, n_tiles = eb.csr_plan(nnz, S, blocks)
    bounds = [(t * tile, min(nnz, (t + 1) * tile)) for t in range(n_tiles)]
    # A: tiles in order write their boundaries; the flag
    offsets = np.full(K, -1, np.int64)
    tile_sorted = []
    for t, (lo, hi) in enumerate(bounds):
        prev = np.concatenate([[keys[lo - 1] if lo > 0 else -1],
                               keys[lo:hi - 1]]) if hi > lo else []
        ok = bool(np.all(np.asarray(prev) <= keys[lo:hi]))
        tile_sorted.append(ok)
        if ok:
            for i in range(lo, hi):
                offsets[prev[i - lo] + 1:keys[i] + 1] = i
            if t == n_tiles - 1:
                last = keys[nnz - 1] if nnz else -1
                offsets[last + 1:S + 1] = nnz
    if all(tile_sorted):
        return True, np.arange(nnz), offsets
    # B1: tile histograms
    counts = np.zeros((n_tiles, K), np.int64)
    for t, (lo, hi) in enumerate(bounds):
        np.add.at(counts[t], keys[lo:hi], 1)
    # B2: block b scans chunks c0 .. c1, each over 16 groups of tiles
    n_chunks = -(-K // 32)
    cpb = -(-n_chunks // blocks)
    per = -(-n_tiles // WARPS)
    block_sums = np.zeros(blocks, np.int64)
    for b in range(blocks):
        carry = 0
        for c in range(min(b * cpb, n_chunks), min((b + 1) * cpb, n_chunks)):
            ks = slice(32 * c, min(32 * c + 32, K))
            col = counts[:, ks]
            groups = [col[min(g * per, n_tiles):min(g * per + per, n_tiles)]
                      for g in range(WARPS)]
            total = sum(gr.sum(0) for gr in groups)
            first = carry + np.cumsum(total) - total
            run = first.copy()
            for gr in groups:                   # each group's rows in order
                for row in gr:
                    v = row.copy()
                    row[:] = run
                    run += v
            offsets[ks] = first
            carry += total.sum()
        block_sums[b] = carry
    # C: the runs' first positions; each tile ranked and scattered
    first_b = np.cumsum(block_sums) - block_sums
    owner = (np.arange(K) >> 5) // cpb
    offsets += first_b[owner]
    W = _rank_warps(S, tile, blocks)
    pos = np.full(nnz, -1, np.int64)
    for t, (lo, hi) in enumerate(bounds):
        k_t = keys[lo:hi]
        base = first_b[owner[k_t]] + counts[t][k_t]
        if W == 0:                              # one warp over the row
            row = counts[t] + first_b[owner]
            pos[lo:hi] = _walk(k_t, row, _bits(S), tagged=False)
            continue
        part = -(-(hi - lo) // (32 * W)) * 32
        cnt = np.zeros((W, K), np.int64)
        rank = np.zeros(hi - lo, np.int64)
        for w in range(W):
            p0, p1 = min(w * part, hi - lo), min(w * part + part, hi - lo)
            rank[p0:p1] = _walk(k_t[p0:p1], cnt[w], _bits(S))
        assert cnt.max() < 1 << 16              # the ranks are 16-bit
        w_of = np.arange(hi - lo) // part
        earlier = np.array([cnt[:w, k].sum() for w, k in zip(w_of, k_t)],
                           np.int64)
        pos[lo:hi] = base + earlier + rank
    return False, pos, offsets


def _segments(kind, S, nnz, rng):
    if kind == "sorted":
        return np.sort(rng.integers(0, S, nnz))
    if kind == "shuffled":
        return rng.integers(0, S, nnz)
    if kind == "empty_bags":           # only every third segment used
        return rng.permutation(3 * (rng.integers(0, max(S // 3, 1), nnz)))
    segs = rng.integers(-3, S + 3, nnz)  # out of range: dropped
    return segs


def _hold(seg, S, blocks=H100_SMS):
    in_order, pos, offsets = _prep(seg, S, blocks)
    keys = np.where((seg >= 0) & (seg < S), seg, S)
    order = np.empty(len(seg), np.int64)
    order[pos] = np.arange(len(seg))            # positions are a bijection
    np.testing.assert_array_equal(order, np.argsort(keys, kind="stable"))
    plain_order, plain_off = eb.csr_prep_plain(torch.from_numpy(seg), S)
    np.testing.assert_array_equal(order, plain_order.numpy())
    np.testing.assert_array_equal(offsets, plain_off.numpy())
    assert in_order == bool(np.all(keys[:-1] <= keys[1:]))
    return in_order


@pytest.mark.parametrize("kind", ["sorted", "shuffled", "empty_bags",
                                  "out_of_range"])
@pytest.mark.parametrize("S,nnz", [(1, 500), (4096, 40_000),
                                   (100_000, 60_000)])
def test_counting_sort_model_is_the_stable_sort(S, nnz, kind):
    rng = np.random.default_rng(S + nnz)
    _hold(_segments(kind, S, nnz, rng), S)


@pytest.mark.parametrize("kind", ["sorted", "shuffled", "out_of_range"])
@pytest.mark.parametrize("S,nnz,blocks,W", [(4096, 30_000, 3, 8),
                                            (20_000, 9_000, 2, 1),
                                            (100_000, 9_000, 2, 0)])
def test_model_with_more_tiles_than_blocks(S, nnz, blocks, W, kind):
    """A block walks several tiles in each phase and scans several chunks;
    at S = 100,000 no warp's counts fit beside the row (W = 0: one warp
    walks each tile over its row of counts in device memory)."""
    tile, n_tiles = eb.csr_plan(nnz, S, blocks)
    assert n_tiles > blocks and _rank_warps(S, tile, blocks) == W
    rng = np.random.default_rng(S + blocks)
    _hold(_segments(kind, S, nnz, rng), S, blocks)


def test_sorted_ids_take_the_identity():
    """Sorted bags with empty ones between and dropped ids last: in order,
    positions the identity, the boundaries csr_prep_plain's offsets."""
    seg = np.concatenate([np.repeat(np.arange(0, 150, 3), 30), [155, 170]])
    in_order, pos, offsets = _prep(seg, 150)
    assert in_order
    np.testing.assert_array_equal(pos, np.arange(len(seg)))
    np.testing.assert_array_equal(
        offsets, eb.csr_prep_plain(torch.from_numpy(seg), 150)[1].numpy())
    for first in (-1, 151):                     # a dropped id first: not
        assert not _hold(np.concatenate([[first], seg]), 150)


@pytest.mark.parametrize("S", [1, 4096, 100_000, 10 ** 7])
@pytest.mark.parametrize("nnz", [0, 1, 409_600])
def test_plan_bounds_the_counts(S, nnz):
    tile, n_tiles = eb.csr_plan(nnz, S, H100_SMS)
    assert tile % 32 == 0 and n_tiles >= 1 and tile * n_tiles >= nnz
    assert n_tiles * (S + 1) <= max(eb.ops.CSR_MAX_SCRATCH, S + 1)
    if (S + 1) * H100_SMS <= eb.ops.CSR_MAX_SCRATCH:
        assert n_tiles <= H100_SMS              # a tile a block fills the card
        assert tile <= max(32, -(-nnz // H100_SMS) + 31)


@pytest.mark.parametrize("S,want", [(4096, 8), (20_000, 1), (100_000, 0)])
def test_rank_warps_fit_shared_memory(S, want):
    """At the DLRM bag (S = 4096, 409,600 ids) 8 warps rank a tile; the
    shared memory a launch takes stays under the kernel's bound."""
    tile, _ = eb.csr_plan(409_600, S, H100_SMS)
    W = _rank_warps(S, tile, H100_SMS)
    assert W == want
    used = (4 * (-(-H100_SMS // 4) * 4) + 4 * tile + 2 * (-(-tile // 8) * 8)
            + -(-(W * (S + 1)) // 4) * 16 + 4 * (S + 1)) if W else 0
    assert used <= SMEM


@pytest.mark.parametrize("kind,share", [("shuffled", (0.85, 0.92)),
                                        ("runs", (0.0, 0.05))])
def test_tagged_steps_skip_the_ballots(kind, share):
    """At the DLRM bag's S = 4096, 32 shuffled ids hold distinct keys in
    ~89% of steps (1 - P(a collision) = 0.886), which take no ballot; ids
    in runs of one key (sorted bags cut and swapped, so not in order)
    ballot nearly every step, with the same ranks."""
    rng = np.random.default_rng(3)
    seg = np.sort(rng.integers(0, 4096, 40_000))
    seg = rng.integers(0, 4096, 40_000) if kind == "shuffled" else \
        np.concatenate([seg[20_000:], seg[:20_000]])
    steps = dict(tagged=0, ballots=0)
    cnt = np.zeros(4097, np.int64)
    ranks = _walk(seg, cnt, _bits(4096), steps=steps)
    assert share[0] <= steps["tagged"] / sum(steps.values()) <= share[1]
    exact = _walk(seg, np.zeros(4097, np.int64), _bits(4096), tagged=False)
    np.testing.assert_array_equal(ranks, exact)


@pytest.mark.parametrize("S", [1, 4096, 65_533, 100_000])
def test_ballot_match_is_key_equality(S):
    rng = np.random.default_rng(S)
    bits = _bits(S)
    assert S != 4096 or bits == 13
    for _ in range(20):
        k = rng.integers(-1, S + 1, 32)
        k[rng.integers(0, 32, 8)] = k[0]           # repeats
        same = _match(k, bits)
        want = [sum(1 << m for m in range(32) if k[m] == k[lane])
                for lane in range(32)]
        np.testing.assert_array_equal(same, want)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("kind", ["sorted", "shuffled", "empty_bags"])
def test_port_matches_reference_kernel(kind, combiner):
    rng = np.random.default_rng(7)
    V, D, S, nnz = 200, 32, 40, 600
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(0, V, nnz).astype(np.int32)
    segs = _segments(kind, S, nnz, rng).astype(np.int32)
    got = eb.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                           torch.from_numpy(segs), S, combiner)
    want = j_bag_pallas(jnp.asarray(table), jnp.asarray(ids),
                        jnp.asarray(segs), num_segments=S, combiner=combiner)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
