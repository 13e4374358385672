"""The CSR preparation of ``embedding_bag`` (a stable counting sort by
segment on the card), its index arithmetic modelled in numpy.

``csrc/embedding_bag.cu`` ``embedding_bag_csr_prep`` runs on the card only
(three launches: per-tile segment histograms, a scan over (segment, tile)
with per-block key prefixes and a last-block scan of the block sums, and a
stable scatter in which up to 8 warps rank contiguous parts of a tile in
32-id steps: running count per key plus the lower lanes with the same key,
found with one ballot per key bit). ``_counting_sort`` repeats that integer
arithmetic step by step; it is held against ``np.argsort(kind="stable")``
and against ``csr_prep_plain`` (the sort-based preparation it replaced) on
sorted, shuffled, empty-bag and out-of-range segment ids at S = 1, 4096
and 100,000, with the tile plan of ``csr_plan``. Last, the port's
``embedding_bag`` (its plain version on the CPU) is held against the
reference's Pallas kernel in interpret mode at fp32 rtol = atol = 2e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import embedding_bag as j_bag_pallas
from repro_torch.kernels import embedding_bag as eb

TOL = dict(rtol=2e-4, atol=2e-4)       # tests/test_kernels.py:21, fp32
RANK_WARPS, SMEM_BYTES, SCAN_KEYS = 8, 196608, 32   # the kernel's constants


def _match(keys, bits):
    """match_key: per lane, the mask of lanes with its key, one ballot per
    bit of key + 1 (keys -1 .. 2^bits - 2)."""
    k = keys.astype(np.int64) + 1
    m = np.full(len(keys), 0xFFFFFFFF, np.int64)
    for b in range(bits):
        bit = (k >> b) & 1
        bal = int(sum(int(v) << lane for lane, v in enumerate(bit)))
        m &= np.where(bit == 1, bal, ~bal & 0xFFFFFFFF)
    return m


def _counting_sort(seg, S):
    """(positions, offsets) as the three launches compute them."""
    nnz, K = len(seg), S + 1
    keys = np.where((seg >= 0) & (seg < S), seg, S).astype(np.int64)
    tile, n_tiles = eb.csr_plan(nnz, S)
    # 1. csr_hist: counts per tile, and whether each tile is in order
    counts = np.zeros((n_tiles, K), np.int64)
    tile_sorted = np.ones(n_tiles, bool)
    for t in range(n_tiles):
        lo, hi = t * tile, min(nnz, (t + 1) * tile)
        np.add.at(counts[t], keys[lo:hi], 1)
        prev = keys[max(lo - 1, 0):hi - 1] if lo > 0 else keys[lo:hi - 1]
        cur = keys[lo:hi] if lo > 0 else keys[lo + 1:hi]
        tile_sorted[t] = bool(np.all(prev <= cur)) if hi > lo else True
    # 2. csr_scan: ids of each key in earlier tiles; offsets from the
    # per-block (32 keys) prefixes plus the scanned block sums
    before = np.cumsum(counts, 0) - counts
    totals = counts.sum(0)
    offsets = np.zeros(K, np.int64)
    n_blocks = -(-K // SCAN_KEYS)
    block_sums = np.zeros(n_blocks, np.int64)
    for b in range(n_blocks):
        tot = totals[b * SCAN_KEYS:(b + 1) * SCAN_KEYS]
        offsets[b * SCAN_KEYS:(b + 1) * SCAN_KEYS] = np.cumsum(tot) - tot
        block_sums[b] = tot.sum()
    offsets += np.repeat(np.cumsum(block_sums) - block_sums,
                         SCAN_KEYS)[:K]
    # 3. csr_scatter: identity where every tile is in order, else parts
    if tile_sorted.all():
        return np.arange(nnz), offsets
    W = min(RANK_WARPS, SMEM_BYTES // (4 * K))
    nw = max(W, 1)
    bits = 16 if K + 1 < (1 << 16) else 32
    pos = np.full(nnz, -1, np.int64)
    for t in range(n_tiles):
        lo, hi = t * tile, min(nnz, (t + 1) * tile)
        part = -(-(hi - lo) // (32 * nw)) * 32
        parts = [(min(hi, lo + w * part), min(hi, lo + (w + 1) * part))
                 for w in range(nw)]
        run = offsets + before[t]
        for plo, phi in parts:                     # counts, then walk
            cnt = run.copy()
            np.add.at(run, keys[plo:phi], 1)
            for c0 in range(plo, phi, 32):
                k = np.full(32, -1, np.int64)
                n = min(32, phi - c0)
                k[:n] = keys[c0:c0 + n]
                same = _match(k, bits)
                lanes = np.arange(32)
                below = np.array([bin(int(same[l]) & ((1 << l) - 1))
                                  .count("1") for l in lanes])
                valid = k >= 0
                start = cnt[np.where(valid, k, 0)]
                pos[c0:c0 + n] = (start + below)[:n]
                for key_, size in zip(*np.unique(k[valid],
                                                 return_counts=True)):
                    cnt[key_] += size
    return pos, offsets


def _segments(kind, S, nnz, rng):
    if kind == "sorted":
        return np.sort(rng.integers(0, S, nnz))
    if kind == "shuffled":
        return rng.integers(0, S, nnz)
    if kind == "empty_bags":           # only every third segment used
        return rng.permutation(3 * (rng.integers(0, max(S // 3, 1), nnz)))
    segs = rng.integers(-3, S + 3, nnz)  # out of range: dropped
    return segs


@pytest.mark.parametrize("kind", ["sorted", "shuffled", "empty_bags",
                                  "out_of_range"])
@pytest.mark.parametrize("S,nnz", [(1, 500), (4096, 40_000),
                                   (100_000, 60_000)])
def test_counting_sort_model_is_the_stable_sort(S, nnz, kind):
    rng = np.random.default_rng(S + nnz)
    seg = _segments(kind, S, nnz, rng)
    pos, offsets = _counting_sort(seg, S)
    keys = np.where((seg >= 0) & (seg < S), seg, S)
    order = np.empty(nnz, np.int64)
    order[pos] = np.arange(nnz)                    # positions are a bijection
    np.testing.assert_array_equal(order, np.argsort(keys, kind="stable"))
    plain_order, plain_off = eb.csr_prep_plain(torch.from_numpy(seg), S)
    np.testing.assert_array_equal(order, plain_order.numpy())
    np.testing.assert_array_equal(offsets, plain_off.numpy())


def test_sorted_ids_take_the_identity():
    seg = np.repeat(np.arange(50), 30)
    pos, _ = _counting_sort(seg, 50)
    np.testing.assert_array_equal(pos, np.arange(len(seg)))


@pytest.mark.parametrize("S", [1, 4096, 100_000, 10 ** 7])
@pytest.mark.parametrize("nnz", [0, 1, 409_600])
def test_plan_bounds_the_counts(S, nnz):
    tile, n_tiles = eb.csr_plan(nnz, S)
    assert tile % 32 == 0 and n_tiles >= 1 and tile * n_tiles >= nnz
    assert n_tiles * (S + 1) <= max(eb.ops.CSR_MAX_SCRATCH, S + 1)


@pytest.mark.parametrize("S", [1, 4096, 65_533, 100_000])
def test_ballot_match_is_key_equality(S):
    rng = np.random.default_rng(S)
    bits = 16 if S + 2 < (1 << 16) else 32
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
