// EmbeddingBag for Hopper, fp32 and bf16: a CSR-offset segmented reduction.
//
//   out[s, :] = combine_{i in [off[s], off[s+1])} w[i] * table[clamp(ids[i]), :]
//
// with combine = sum, or sum / max(count, 1) for mean; an empty bag is 0.
// Replaces the TPU Pallas kernel embedding_bag_kernel
// (src/repro/kernels/embedding_bag/kernel.py:37), which streamed one table
// row per grid step over SORTED segment ids and kept the output row
// resident in VMEM while consecutive steps hit the same segment. Blocks on
// this card run in parallel and in no order, so nothing carries over
// between steps: here one warp owns one bag and walks the bag's ids in
// order, with the bag boundaries given as CSR offsets (built on the card
// by embedding_bag_csr_prep below), or implicitly as s * H for a fixed
// hotness H (the executor's (B, H) ids, which need no sort). Where the
// preparation found the segment ids in order, the bag kernel reads the
// caller's ids and weights (its flag on the device says which to read).
//
// What bounds it on an H100: every referenced table row is read once and
// reduced at one FLOP per element, so it is bound by bytes (3.35 TB/s).
// At the multi-hot DLRM path's largest bag (B = 4096, H = 100, D = 128)
// that is ~200 MB of 512-byte rows at scattered addresses. The design
// keeps many row loads in flight: the lanes of a warp cover a row in
// float4 chunks (D = 128: one warp load is exactly one 512 B row), each
// lane loads 32 ids of the bag at once (coalesced) and broadcasts them by
// shuffle, and the row loads are unrolled over UNROLL ids before any is
// summed. Each lane sums its columns in id order in fp32 registers, with
// no atomics, so a bag's result does not depend on B or on its neighbours.
// D % 4 != 0 (DIN's D = 18) or a table not 16-byte aligned takes the
// scalar path: one float per lane. Columns are tiled over blockIdx.y in
// 32 * VEC floats, so any D works.
//
// bf16 (embedding_bag_bf16): a bf16 table and output, fp32 per-id
// weights. Rows are widened to fp32 as they are loaded (8 bytes a lane on
// the vector path) and summed in fp32 registers as above; each bag's
// result is rounded to bf16 once. The TPU kernel accumulates in the
// table's dtype, one row at a time (o_ref += row_ref), so it rounds after
// every row: this entry is nearer the exact sum, within the reference's
// bf16 tolerance of it.
//
// Index contract: ids outside [0, V) clamp to [0, V - 1] (the port's
// index rule, as jnp.take(mode="clip")): no id ever makes the kernel read
// outside the table. Segment ids outside [0, S) never reach the kernel:
// the preparation drops them, as jax.ops.segment_sum does.
//
// The CSR preparation (embedding_bag_csr_prep): a stable counting sort of
// the nnz ids by segment, one key digit wide (key = the segment id, or S
// for a dropped one), in ONE cooperative launch of one 512-thread block an
// SM (grid-wide barriers between its phases; no host synchronisation:
// every size is known on the host, nnz, S and the tile plan of
// kernels/embedding_bag/ops.py csr_plan: a tile a block, of at most 4096
// ids, where the counts allow):
//  A. each block checks that its tiles' keys never decrease (from the key
//     before the tile on) and, where a tile's do, writes the bag
//     boundaries it holds: offsets[k] = i for key[i - 1] < k <= key[i]
//     (the tail, keys past the last id, -> nnz). Barrier. When every tile
//     is in order the offsets are complete, the flag in_order says so and
//     the launch ends: the bag kernel reads the caller's ids and weights
//     in place, with nothing copied. This is the common case (a flattened
//     ragged batch arrives sorted): one pass over the keys.
//  B. otherwise: each tile's histogram (shared memory, one integer atomic
//     a lane, or a warp's when its 32 keys agree; the keys are A's, held
//     in registers) goes to row t of counts (n_tiles, S + 1). Barrier.
//     Each block owns a contiguous run of 32-key chunks and turns each
//     key's column of counts into its first position in the tile among
//     the keys of its run (ids of the run's earlier keys plus ids of the
//     key in earlier tiles); the run's sum goes to block_sums. Barrier.
//  C. each block scans block_sums (every run's first position), finishes
//     its keys' offsets and ranks its tiles: up to W = 8 warps each walk a
//     contiguous part of a tile in order, 32 ids a step, an id's rank in
//     its part being its key's running count (in shared memory) plus the
//     lanes below it with the same key. Most steps' keys all differ (a
//     random step of 32 of S = 4096 keys does 89 times in 100): each lane
//     writes its lane beside its key's count, and where every lane reads
//     its own back the ranks are the counts read; else one ballot per bit
//     of S + 1 (13 at S = 4096) finds each key's lanes. Then each id's
//     position is its run's first position + the row of counts + its
//     key's ids in earlier parts + its rank, and the id (and weight) is
//     written there. Where W (S + 1) counts do not fit, one warp walks the
//     tile over its row of counts in device memory (read and written
//     volatile), with the ballots every step.
// So each bag holds its ids in input order, exactly as a stable sort gives
// them, and the bag kernel's result is bitwise that of the sort-based
// preparation. The tile plan keeps the counts at n_tiles * (S + 1) <=
// max(2^22, S + 1) int32. Measured on an H100 (PERF.md): sorted ids cost
// the launch, one load of the keys and one barrier; shuffled ones, where
// 409,600 ids land at scattered addresses, pay the scattered stores most.
// The bag kernel after it is a programmatic dependent launch: its blocks
// are scheduled before the preparation ends and wait for it at
// griddepcontrol.wait, so the second launch's latency is hidden.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kUnroll = 8;

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void fma(T& acc, const T& v, float w) {
    acc.x = fmaf(w, v.x, acc.x);
    acc.y = fmaf(w, v.y, acc.y);
    acc.z = fmaf(w, v.z, acc.z);
    acc.w = fmaf(w, v.w, acc.w);
  }
  __device__ static void add(T& acc, const T& v) {
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  __device__ static void scale(T& acc, float s) {
    acc.x *= s;
    acc.y *= s;
    acc.z *= s;
    acc.w *= s;
  }
};
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static void fma(T& acc, const T& v, float w) {
    acc = fmaf(w, v, acc);
  }
  __device__ static void add(T& acc, const T& v) { acc += v; }
  __device__ static void scale(T& acc, float s) { acc *= s; }
};

// VEC columns of a table row widened to fp32, and of an output rounded
// from fp32: fp32 as they are, bf16 by its bits (the float's top 16)
__device__ __forceinline__ void load(float4& v, const float* p) {
  v = *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void load(float& v, const float* p) { v = *p; }
__device__ __forceinline__ void load(float4& v, const __nv_bfloat16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  v = make_float4(__uint_as_float(r.x << 16),
                  __uint_as_float(r.x & 0xffff0000u),
                  __uint_as_float(r.y << 16),
                  __uint_as_float(r.y & 0xffff0000u));
}
__device__ __forceinline__ void load(float& v, const __nv_bfloat16* p) {
  v = __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, const float4& v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One warp per (bag, column tile). FIXED: bag s spans ids [s * H, s * H + H);
// otherwise [offsets[s], offsets[s + 1]), of `ids` where in_order is NULL or
// *in_order != 0, else of ids_bag (and w_bag for the weights). E: the
// table's and output's element type (float or bf16).
template <typename E, typename Idx, int VEC, bool FIXED, bool WEIGHTED>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    embedding_bag_kernel(const E* __restrict__ table,
                         const Idx* __restrict__ ids,
                         const int64_t* __restrict__ offsets,
                         const float* __restrict__ weights,
                         const Idx* __restrict__ ids_bag,
                         const float* __restrict__ w_bag,
                         const int* __restrict__ in_order,
                         E* __restrict__ out, int S, int D, int64_t V,
                         int H, int mean) {
  using V_ = Vec<VEC>;
  using T = typename V_::T;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (s >= S) return;
  const int col = (blockIdx.y * 32 + lane) * VEC;   // this lane's first column
  const bool active = col < D;
  int64_t start, end;
  if (FIXED) {
    start = (int64_t)s * H;
    end = start + H;
  } else {
    // launched behind the preparation (programmatic dependent launch):
    // wait here until its offsets and flag are written
    asm volatile("griddepcontrol.wait;" ::: "memory");
    start = offsets[s];
    end = offsets[s + 1];
    if (in_order != nullptr && *in_order == 0) {   // loaded beside offsets
      ids = ids_bag;
      weights = w_bag;
    }
  }
  T acc = V_::zero();
  for (int64_t base = start; base < end; base += 32) {
    const int n = end - base < 32 ? (int)(end - base) : 32;
    // the warp loads 32 ids (and weights) of the bag in one coalesced read
    int64_t my_id = 0;
    float my_w = 1.f;
    if (lane < n) {
      my_id = (int64_t)ids[base + lane];
      my_id = my_id < 0 ? 0 : (my_id >= V ? V - 1 : my_id);
      if (WEIGHTED) my_w = weights[base + lane];
    }
    int j = 0;
    for (; j + kUnroll <= n; j += kUnroll) {
      T v[kUnroll];
      float w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t id = __shfl_sync(0xffffffffu, my_id, j + u);
        if (WEIGHTED) w[u] = __shfl_sync(0xffffffffu, my_w, j + u);
        v[u] = V_::zero();
        if (active) load(v[u], table + id * D + col);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (WEIGHTED)
          V_::fma(acc, v[u], w[u]);
        else
          V_::add(acc, v[u]);
      }
    }
    for (; j < n; ++j) {
      const int64_t id = __shfl_sync(0xffffffffu, my_id, j);
      const float w = WEIGHTED ? __shfl_sync(0xffffffffu, my_w, j) : 1.f;
      if (active) {
        T v;
        load(v, table + id * D + col);
        if (WEIGHTED)
          V_::fma(acc, v, w);
        else
          V_::add(acc, v);
      }
    }
  }
  if (!active) return;
  if (mean) {
    const int64_t count = end - start;
    V_::scale(acc, 1.f / (float)(count > 1 ? count : 1));
  }
  store(out + (int64_t)s * D + col, acc);
}

template <typename E, typename Idx, int VEC>
int launch(const E* table, const Idx* ids, const int64_t* offsets,
           const float* weights, const Idx* ids_bag, const float* w_bag,
           const int* in_order, E* out, int S, int D, int64_t V, int H,
           int mean, cudaStream_t stream) {
  const dim3 grid((S + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (D + 32 * VEC - 1) / (32 * VEC));
  const dim3 block(32 * kWarpsPerBlock);
  const bool fixed = offsets == nullptr;
  auto kernel = fixed ? (weights ? embedding_bag_kernel<E, Idx, VEC, true, true>
                                 : embedding_bag_kernel<E, Idx, VEC, true, false>)
                      : (weights ? embedding_bag_kernel<E, Idx, VEC, false, true>
                                 : embedding_bag_kernel<E, Idx, VEC, false, false>);
  if (in_order == nullptr) {
    kernel<<<grid, block, 0, stream>>>(table, ids, offsets, weights, ids_bag,
                                       w_bag, in_order, out, S, D, V, H,
                                       mean);
    return (int)cudaGetLastError();
  }
  // behind embedding_bag_csr_prep: its blocks may start before the
  // preparation ends, and wait for it at griddepcontrol.wait
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, table, ids, offsets, weights,
                                 ids_bag, w_bag, in_order, out, S, D, V, H,
                                 mean);
}

template <typename E, typename Idx>
int dispatch_vec(const E* table, const Idx* ids, const int64_t* offsets,
                 const float* weights, const Idx* ids_bag,
                 const float* w_bag, const int* in_order, E* out, int S,
                 int D, int64_t V, int H, int mean, cudaStream_t stream) {
  // 4-column loads need every row start aligned to 4 values
  const uintptr_t a = 4 * sizeof(E);
  const bool vec4 = D % 4 == 0 && ((uintptr_t)table % a == 0) &&
                    ((uintptr_t)out % a == 0);
  return vec4 ? launch<E, Idx, 4>(table, ids, offsets, weights, ids_bag,
                                  w_bag, in_order, out, S, D, V, H, mean,
                                  stream)
              : launch<E, Idx, 1>(table, ids, offsets, weights, ids_bag,
                                  w_bag, in_order, out, S, D, V, H, mean,
                                  stream);
}

template <typename E>
int dispatch_ids(const E* table, const void* ids, int ids_int64,
                 const int64_t* offsets, const float* weights,
                 const void* ids_bag, const float* w_bag,
                 const int* in_order, E* out, int S, int D, int64_t V,
                 int H, int mean, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ids_int64
             ? dispatch_vec(table, static_cast<const int64_t*>(ids), offsets,
                            weights, static_cast<const int64_t*>(ids_bag),
                            w_bag, in_order, out, S, D, V, H, mean, st)
             : dispatch_vec(table, static_cast<const int32_t*>(ids), offsets,
                            weights, static_cast<const int32_t*>(ids_bag),
                            w_bag, in_order, out, S, D, V, H, mean, st);
}

// ---- CSR preparation: a stable counting sort by segment, one launch ------

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPrepThreads = 512;       // one block an SM, all co-resident
constexpr int kPrepWarps = kPrepThreads / 32;
constexpr int kMaxRankWarps = 8;        // warps ranking one tile
constexpr int kPrepSmem = 224 * 1024;   // dynamic shared memory of a block
constexpr int kAhead = 8;               // chunks of keys loaded ahead

template <typename Seg, typename Id>
struct Prep {
  const Seg* seg;
  const Id* ids;
  const float* w;
  int64_t nnz;
  int S, tile, n_tiles;
  int W;           // ranking warps; 0: one warp over the row in device memory
  int bits;        // ballots a step: the bit length of S + 1
  int smem_hist;   // the tile histogram counts in shared memory
  int* in_order;   // 1: the keys never decrease (the ids stay in place)
  int* tile_sorted;
  int* block_sums;
  int* counts;     // (n_tiles, S + 1)
  int64_t* offsets;
  Id* ids_out;
  float* w_out;
};

template <typename Seg>
__device__ __forceinline__ int seg_key(const Seg* seg, int64_t i, int S) {
  const Seg s = seg[i];
  return s >= 0 && s < (Seg)S ? (int)s : S;
}

// the lanes whose key equals this lane's (keys -1 .. 2^BITS - 2), by one
// ballot per key bit, unrolled (__match_any_sync in its place made the
// walk no faster on an H100)
template <int BITS>
__device__ __forceinline__ unsigned match_key(int key) {
  const unsigned k = (unsigned)(key + 1);
  unsigned m = kFull;
#pragma unroll
  for (int b = 0; b < BITS; ++b) {
    const unsigned bal = __ballot_sync(kFull, (k >> b) & 1u);
    m &= (k >> b) & 1u ? bal : ~bal;
  }
  return m;
}

// counts[key] += 1 for each lane's key (-1: none); counts only, so the
// atomics' order cannot matter: one add for a warp of one key (sorted
// ids), else one per lane. No branch: the warp stays converged for the
// collectives around it.
__device__ __forceinline__ void count_keys(int* counts, int key, int lane) {
  const bool one = __all_sync(kFull, key == __shfl_sync(kFull, key, 0));
  const int add = one ? (lane == 0 ? 32 : 0) : 1;
  if (key >= 0 && add) atomicAdd(&counts[key], add);
}

// exclusive scan of v over the block (blockDim.x a multiple of 32, at most
// 1024); returns this thread's prefix, *total the block's sum
__device__ __forceinline__ int block_exclusive_scan(int v, int* scratch,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += t;
  }
  if (lane == 31) scratch[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < nwarps; ++w) {
    const int x = scratch[w];
    if (w < warp) before += x;
    all += x;
  }
  __syncthreads();
  *total = all;
  return before + inc - v;
}

// off[from + 1 .. to] = v for each lane's range, the warp writing one
// lane's range at a time, 32 keys a store. Every loop runs the same
// trips on every lane: a lane-dependent trip count before the shuffles
// would make each of them wait for the warp to reconverge.
__device__ __forceinline__ void fill_range(int64_t* off, int from, int to,
                                           int64_t v, int lane) {
  unsigned pend = __ballot_sync(kFull, to > from);
  while (pend) {
    const int src = __ffs(pend) - 1;
    pend &= pend - 1;
    const int a = __shfl_sync(kFull, from, src);
    const int b = __shfl_sync(kFull, to, src);
    const int64_t x = __shfl_sync(kFull, v, src);
    for (int q = a + 1; q <= b; q += 32)
      if (q + lane <= b) off[q + lane] = x;
  }
}

// A: whether tile t's keys never decrease (from the key before it on);
// where they do, the bag boundaries they hold. key: the tile's keys, id
// lo + u * kPrepThreads + threadIdx.x in key[u] (-1 past the tile), where
// the tile has at most 8 * kPrepThreads ids.
template <typename Seg, typename Id>
__device__ __forceinline__ void sorted_pass(const Prep<Seg, Id>& p, int t,
                                            int (&key)[8], int lane,
                                            int warp) {
  const int64_t lo = (int64_t)t * p.tile;
  const int64_t hi = lo + p.tile < p.nnz ? lo + p.tile : p.nnz;
  // 8 ids' keys (and the keys before them) loaded at once: a tile of at
  // most 8 * kPrepThreads ids stays in registers for the boundaries
  int prev[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) key[u] = prev[u] = -1;
  int ok = 1;
  for (int64_t b0 = lo; b0 < hi; b0 += 8 * kPrepThreads) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int64_t i = b0 + u * kPrepThreads + threadIdx.x;
      key[u] = i < hi ? seg_key(p.seg, i, p.S) : -1;
      prev[u] = i < hi && i > 0 ? seg_key(p.seg, i - 1, p.S) : -1;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) ok &= prev[u] <= key[u] || key[u] < 0;
  }
  ok = __syncthreads_and(ok);
  if (ok) {
    // the keys past the last id (all of them when there is none) -> nnz,
    // by the lane that holds the last id (or position 0)
    const bool tail = t == p.n_tiles - 1;
    const int64_t last = p.nnz > 0 ? p.nnz - 1 : 0;
    if (hi - lo <= 8 * kPrepThreads) {
      // a bag's first id writes its boundary; the keys of empty bags
      // before it (rare) the warp writes together
      int from = -1, to = -1;
      bool gaps = false;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int64_t i = lo + u * kPrepThreads + threadIdx.x;
        if (key[u] > prev[u]) p.offsets[prev[u] + 1] = i;
        gaps |= key[u] > prev[u] + 1;
        if (tail && i == last) {
          from = key[u];
          to = p.S;
        }
      }
      if (__any_sync(kFull, gaps))
#pragma unroll
        for (int u = 0; u < 8; ++u)
          fill_range(p.offsets, prev[u] + 1, key[u],
                     lo + u * kPrepThreads + threadIdx.x, lane);
      fill_range(p.offsets, from, to, p.nnz, lane);
    } else {
      for (int64_t b0 = lo; b0 < hi; b0 += kPrepThreads) {
        const int64_t i = b0 + threadIdx.x;
        const int k = i < hi ? seg_key(p.seg, i, p.S) : -1;
        const int k0 = i < hi && i > 0 ? seg_key(p.seg, i - 1, p.S) : -1;
        fill_range(p.offsets, k0, k, i, lane);
      }
      if (tail && warp == 0)
        fill_range(p.offsets, lane == 0 ? seg_key(p.seg, last, p.S) : -1,
                   lane == 0 ? p.S : -1, p.nnz, lane);
    }
  }
  if (threadIdx.x == 0) p.tile_sorted[t] = ok;
}

// B1: tile t's histogram into row t of counts. held: key holds the tile's
// keys from A (the block's one tile, of at most 8 * kPrepThreads ids);
// they also go to key_s for C's walk. Else each warp loads its 8 steps'
// keys at once (the same layout: step u of warp w is ids lo + u *
// kPrepThreads + 32 w ..).
template <typename Seg, typename Id>
__device__ __forceinline__ void tile_hist(const Prep<Seg, Id>& p, int t,
                                          int* cnt_s, int (&key)[8],
                                          bool held, int* key_s, int lane,
                                          int warp) {
  const int K = p.S + 1;
  int* row = p.counts + (size_t)t * K;
  int* cnt = p.smem_hist ? cnt_s : row;
  const int64_t lo = (int64_t)t * p.tile;
  const int64_t hi = lo + p.tile < p.nnz ? lo + p.tile : p.nnz;
  const int64_t w0 = lo + 32 * warp;
  if (!held)
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int64_t i = w0 + u * kPrepThreads + lane;
      key[u] = i < hi ? seg_key(p.seg, i, p.S) : -1;
    }
  for (int k = threadIdx.x; k < K; k += kPrepThreads) cnt[k] = 0;
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 8; ++u) count_keys(cnt, key[u], lane);
  for (int64_t b0 = w0 + 8 * kPrepThreads; b0 < hi; b0 += 8 * kPrepThreads) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int64_t i = b0 + u * kPrepThreads + lane;
      key[u] = i < hi ? seg_key(p.seg, i, p.S) : -1;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) count_keys(cnt, key[u], lane);
  }
  if (held && p.W > 0)
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (w0 + u * kPrepThreads + lane < hi)
        key_s[(int)(w0 - lo) + u * kPrepThreads + lane] = key[u];
  __syncthreads();
  if (p.smem_hist)
    for (int k = threadIdx.x; k < K; k += kPrepThreads) row[k] = cnt_s[k];
}

// B2: chunk c (keys 32 c .. 32 c + 31), the 16 warps each summing a
// contiguous group of tiles: each count becomes carry + the chunk's
// earlier keys' ids + the key's ids in earlier tiles; offsets[k] the same
// without the tiles; returns the chunk's ids
template <typename Seg, typename Id>
__device__ __forceinline__ int scan_chunk(const Prep<Seg, Id>& p, int c,
                                          int carry, int (*part)[32],
                                          int lane, int warp) {
  const int K = p.S + 1;
  const int k = c * 32 + lane;
  const int per = (p.n_tiles + kPrepWarps - 1) / kPrepWarps;
  const int t0 = warp * per < p.n_tiles ? warp * per : p.n_tiles;
  const int t1 = t0 + per < p.n_tiles ? t0 + per : p.n_tiles;
  // 16 counts loaded at once; a group of at most 16 tiles (n_tiles <= 256)
  // stays in registers for the rewrite
  int v[16];
  auto load = [&](int tb) {
#pragma unroll
    for (int u = 0; u < 16; ++u)
      v[u] = k < K && tb + u < t1 ? __ldcg(p.counts + (size_t)(tb + u) * K + k)
                                  : 0;
  };
  int sum = 0;
  for (int tb = t0; tb < t1; tb += 16) {
    load(tb);
#pragma unroll
    for (int u = 0; u < 16; ++u) sum += v[u];
  }
  part[warp][lane] = sum;
  __syncthreads();
  int run = 0, total = 0;
#pragma unroll
  for (int h = 0; h < kPrepWarps; ++h) {
    const int x = part[h][lane];
    run += h < warp ? x : 0;
    total += x;
  }
  int inc = total;                        // the chunk's keys, inclusive
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += up;
  }
  const int first = carry + inc - total;  // the key's first id in the run
  run += first;
  for (int tb = t0; tb < t1; tb += 16) {
    if (t1 - t0 > 16) load(tb);
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      if (k < K && tb + u < t1) p.counts[(size_t)(tb + u) * K + k] = run;
      run += v[u];
    }
  }
  if (k < K && warp == 0) p.offsets[k] = first;
  const int chunk = __shfl_sync(kFull, inc, 31);
  __syncthreads();                        // part is the next chunk's
  return chunk;
}

// f(integral_constant<BITS>) with the fewest ballots a step the keys need
// (13 at S = 4096); bits is the same on every lane, so the branch keeps
// the warp converged
template <typename F>
__device__ __forceinline__ void with_bits(int bits, F f) {
  if (bits <= 8)
    f(std::integral_constant<int, 8>());
  else if (bits <= 13)
    f(std::integral_constant<int, 13>());
  else if (bits <= 16)
    f(std::integral_constant<int, 16>());
  else if (bits <= 17)
    f(std::integral_constant<int, 17>());
  else
    f(std::integral_constant<int, 32>());
}

// C where no warp's counts fit: one warp walks ids lo .. hi in order, 32
// a step, over the tile's row of positions in device memory: an id's
// position is its key's, plus the lanes below it with the same key (one
// ballot per key bit; the lanes of one key read the position and write
// back one value); the id (and weight) goes there. Keys are loaded kAhead
// steps ahead; steps past hi hold key -1 and change nothing.
template <int BITS, typename Seg, typename Id>
__device__ __forceinline__ void walk_row(const Prep<Seg, Id>& p, int64_t lo,
                                         int64_t hi, volatile int* row,
                                         int lane) {
  int key[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    const int64_t i = lo + 32 * u + lane;
    key[u] = i < hi ? seg_key(p.seg, i, p.S) : -1;
  }
  for (int64_t b0 = lo; b0 < hi; b0 += 32 * kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int64_t i = b0 + 32 * u + lane;
      const int k = key[u];
      const unsigned same = match_key<BITS>(k);
      const int start = row[k >= 0 ? k : 0];
      __syncwarp();                       // every read before the write
      if (k >= 0) {
        row[k] = start + __popc(same);
        const int pos = start + __popc(same & ((1u << lane) - 1u));
        p.ids_out[pos] = p.ids[i];
        if (p.w_out) p.w_out[pos] = p.w[i];
      }
      __syncwarp();
      const int64_t j = i + 32 * kAhead;
      key[u] = j < hi ? seg_key(p.seg, j, p.S) : -1;
    }
  }
}

// C, a ranking warp's walk over its part lo .. hi of the tile from base,
// 32 ids a step: an id's rank in the part is its key's count so far plus
// the lanes below it with the same key. A count keeps in its low 5 bits
// the lane that last wrote it: each lane writes its own, and where no
// lane finds another's there (the step's keys all differ, as most do)
// the ranks are the counts read; else one ballot per key bit (BITS) finds
// the lanes of each key, which write back one value.
template <int BITS>
__device__ __forceinline__ void rank_part(int64_t lo, int64_t hi,
                                          int64_t base, int* cnt,
                                          const int* key_s,
                                          unsigned short* rank_s, int lane) {
  for (int64_t b0 = lo; b0 < hi; b0 += 32) {
    const int at = (int)(b0 - base) + lane;
    const int k = b0 + lane < hi ? key_s[at] : -1;
    const int start = cnt[k >= 0 ? k : 0] >> 5;
    __syncwarp();                         // every read before the writes
    if (k >= 0) cnt[k] = start << 5 | lane;
    __syncwarp();
    const bool lost = k >= 0 && (cnt[k] & 31) != lane;
    int r = start;
    if (__any_sync(kFull, lost)) {
      const unsigned same = match_key<BITS>(k);
      r += __popc(same & ((1u << lane) - 1u));
      if (k >= 0) cnt[k] = (start + __popc(same)) << 5;
    } else if (k >= 0) {
      cnt[k] = (start + 1) << 5;
    }
    __syncwarp();
    if (k >= 0) rank_s[at] = (unsigned short)r;
  }
}

// n counts of the ranking warps to 0, 16 bytes a store
__device__ __forceinline__ void zero_counts(int* cnt, int n) {
  int4* cnt4 = reinterpret_cast<int4*>(cnt);
  for (int q = threadIdx.x; q < (n + 3) / 4; q += kPrepThreads)
    cnt4[q] = make_int4(0, 0, 0, 0);
}

// C: tile t's ids and weights to their positions. first: the first
// position of block b's run of chunks (b < gridDim.x), in shared memory;
// key_s (the tile's keys, B1's where held), rank_s, cnt (W arrays of S + 1
// counts; zeroed: already 0) and row_s (S + 1) after it.
template <typename Seg, typename Id>
__device__ __forceinline__ void rank_tile(const Prep<Seg, Id>& p, int t,
                                          int cpb, const int* first,
                                          int* key_s, unsigned short* rank_s,
                                          int* cnt, int* row_s, bool held,
                                          bool zeroed, int lane, int warp) {
  const int K = p.S + 1;
  const int64_t lo = (int64_t)t * p.tile;
  const int64_t hi = lo + p.tile < p.nnz ? lo + p.tile : p.nnz;
  int* row = p.counts + (size_t)t * K;
  auto owner = [&](int k) {               // the block that scanned key k
    return cpb == 1 ? k >> 5 : (k >> 5) / cpb;
  };
  if (p.W == 0) {
    // one warp walks the tile over its row of counts, made positions
    for (int k = threadIdx.x; k < K; k += kPrepThreads)
      row[k] = __ldcg(row + k) + first[owner(k)];
    __syncthreads();
    if (warp == 0)
      with_bits(p.bits, [&](auto b) {
        walk_row<decltype(b)::value>(p, lo, hi, row, lane);
      });
    __syncthreads();
    return;
  }
  if (!held)                              // the tile's keys, 8 a thread at once
    for (int64_t b0 = lo; b0 < hi; b0 += 8 * kPrepThreads) {
      int k8[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int64_t i = b0 + u * kPrepThreads + threadIdx.x;
        k8[u] = i < hi ? seg_key(p.seg, i, p.S) : -1;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (b0 + u * kPrepThreads + threadIdx.x < hi)
          key_s[(int)(b0 - lo) + u * kPrepThreads + threadIdx.x] = k8[u];
    }
  // a tile of at most 8 * kPrepThreads ids: its ids (and weights) loaded
  // now, under the walk below
  const bool one = hi - lo <= 8 * kPrepThreads;
  Id id[8];
  float wv[8];
  auto load_ids = [&](int64_t b0) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int64_t i = b0 + u * kPrepThreads + threadIdx.x;
      if (i < hi) {
        id[u] = p.ids[i];
        wv[u] = p.w_out ? p.w[i] : 0.f;
      }
    }
  };
  if (one) load_ids(lo);
  // the tile's row (each key's position in the tile) in shared memory, 16
  // counts a thread loaded at once; the warps' counts zeroed meanwhile
  // (the block's first tile's were, in the kernel)
  for (int k0 = 0; k0 < K; k0 += 16 * kPrepThreads) {
    int r[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int k = k0 + u * kPrepThreads + threadIdx.x;
      r[u] = k < K ? __ldcg(row + k) : 0;
    }
    if (k0 == 0 && !zeroed) zero_counts(cnt, p.W * K);
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int k = k0 + u * kPrepThreads + threadIdx.x;
      if (k < K) row_s[k] = r[u] + first[owner(k)];
    }
  }
  __syncthreads();
  // warp w's part: whole chunks of 32 ids
  const int part = (int)((hi - lo + 32 * p.W - 1) / (32 * p.W)) * 32;
  if (warp < p.W) {
    const int64_t plo =
        lo + (int64_t)warp * part < hi ? lo + (int64_t)warp * part : hi;
    const int64_t phi = plo + part < hi ? plo + part : hi;
    with_bits(p.bits, [&](auto b) {
      rank_part<decltype(b)::value>(plo, phi, lo, cnt + (size_t)warp * K,
                                    key_s, rank_s, lane);
    });
  }
  __syncthreads();
  // each id: its key's position plus its key's ids in the earlier parts
  // plus its rank in its own; 8 ids' loads issued before any store
  for (int64_t b0 = lo; b0 < hi; b0 += 8 * kPrepThreads) {
    int pos[8];
    if (!one) load_ids(b0);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int64_t i = b0 + u * kPrepThreads + threadIdx.x;
      if (i < hi) {
        const int at = (int)(i - lo);
        const int k = key_s[at];
        const int w = at / part;
        pos[u] = row_s[k] + rank_s[at];
        for (int v = 0; v < w; ++v) pos[u] += cnt[(size_t)v * K + k] >> 5;
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (b0 + u * kPrepThreads + threadIdx.x < hi) {
        p.ids_out[pos[u]] = id[u];
        if (p.w_out) p.w_out[pos[u]] = wv[u];
      }
    }
  }
  __syncthreads();                        // the arrays are the next tile's
}

template <typename Seg, typename Id>
__global__ void __launch_bounds__(kPrepThreads, 1)
    csr_prep_kernel(const Prep<Seg, Id> p) {
  namespace cg = cooperative_groups;
  extern __shared__ int4 smem4[];
  __shared__ int part[kPrepWarps][32];
  __shared__ int scratch[32];
  cg::grid_group grid = cg::this_grid();
  // the bag kernel after it may be scheduled now (it waits for the end)
  asm volatile("griddepcontrol.launch_dependents;");
  const int lane = threadIdx.x & 31;
  // the warp index as a value the compiler sees is the same on every lane
  // (a shuffle from lane 0): branches on it keep the warp converged, so
  // the collectives below need no reconvergence
  const int warp = __shfl_sync(kFull, (int)threadIdx.x >> 5, 0);
  const int G = gridDim.x;
  const int K = p.S + 1;
  // the block's one tile, of at most 8 * kPrepThreads ids, is held in
  // registers (key) from A to B1 and in key_s from B1 to C
  const bool held = p.n_tiles <= G && p.tile <= 8 * kPrepThreads;
  int key[8];
  for (int t = blockIdx.x; t < p.n_tiles; t += G)
    sorted_pass(p, t, key, lane, warp);
  grid.sync();
  int all = 1;
  for (int t = threadIdx.x; t < p.n_tiles; t += kPrepThreads)
    all &= __ldcg(p.tile_sorted + t);
  all = __syncthreads_and(all);
  if (blockIdx.x == 0 && threadIdx.x == 0) *p.in_order = all;
  if (all) return;                        // the offsets are complete
  // shared memory: first (a block's run's first position), key_s, rank_s,
  // the warps' counts, row_s; B1's histogram in row_s (at 0 when W = 0)
  const int groom = (G + 3) / 4 * 4;
  int* ints = reinterpret_cast<int*>(smem4);
  int* first = ints;
  int* key_s = ints + groom;
  unsigned short* rank_s = reinterpret_cast<unsigned short*>(key_s + p.tile);
  int* cnt = reinterpret_cast<int*>(rank_s + (p.tile + 7) / 8 * 8);
  int* row_s = cnt + ((size_t)p.W * K + 3) / 4 * 4;
  for (int t = blockIdx.x; t < p.n_tiles; t += G)
    tile_hist(p, t, p.W > 0 ? row_s : ints, key, held, key_s, lane, warp);
  grid.sync();
  const int n_chunks = (K + 31) / 32;
  const int cpb = (n_chunks + G - 1) / G;   // chunks a block scans
  const int c0 = blockIdx.x * cpb < n_chunks ? blockIdx.x * cpb : n_chunks;
  const int c1 = c0 + cpb < n_chunks ? c0 + cpb : n_chunks;
  int carry = 0;
  for (int c = c0; c < c1; ++c)
    carry += scan_chunk(p, c, carry, part, lane, warp);
  if (threadIdx.x == 0) p.block_sums[blockIdx.x] = carry;
  grid.sync();
  // every block's first position: the scan of block_sums; the first
  // tile's ranking counts are zeroed under the loads' latency
  int cum = 0;
  for (int b0 = 0; b0 < G; b0 += kPrepThreads) {
    const int b = b0 + threadIdx.x;
    const int v = b < G ? __ldcg(p.block_sums + b) : 0;
    if (b0 == 0 && p.W > 0) zero_counts(cnt, p.W * K);
    int total;
    const int ex = block_exclusive_scan(v, scratch, &total);
    if (b < G) first[b] = cum + ex;
    cum += total;
  }
  __syncthreads();
  for (int k = c0 * 32 + threadIdx.x; k < c1 * 32 && k < K; k += kPrepThreads)
    p.offsets[k] = __ldcg(p.offsets + k) + first[blockIdx.x];
  for (int t = blockIdx.x; t < p.n_tiles; t += G)
    rank_tile(p, t, cpb, first, key_s, rank_s, cnt, row_s, held,
              t == blockIdx.x, lane, warp);
}

// the shared memory a launch takes, and the ranking warps W: as many
// per-warp arrays of S + 1 counts as fit beside a tile's keys and ranks
// and its row, up to kMaxRankWarps; 0 when not even one does
int rank_warps(int S, int tile, int blocks) {
  const long long fixed = 4LL * ((blocks + 3) / 4 * 4) + 4LL * tile +
                          2LL * ((tile + 7) / 8 * 8) + 16 + 4LL * (S + 1);
  const long long w = (kPrepSmem - fixed) / (4LL * (S + 1));
  return (int)(w < 0 ? 0 : (w < kMaxRankWarps ? w : kMaxRankWarps));
}

size_t prep_smem(int S, int tile, int blocks, int W, int smem_hist) {
  const size_t K = (size_t)S + 1;
  const size_t groom = (size_t)(blocks + 3) / 4 * 4;
  size_t c = 4 * groom;
  if (W > 0)
    c += 4 * (size_t)tile + 2 * ((size_t)(tile + 7) / 8 * 8) +
         ((size_t)W * K + 3) / 4 * 16 + 4 * K;
  const size_t h = smem_hist ? 4 * K : 0;
  return c > h ? c : h;
}

template <typename Seg, typename Id>
int csr_prep(const Seg* seg, const Id* ids, const float* w, int64_t nnz,
             int S, int tile, int n_tiles, int blocks, int* scratch,
             int64_t* offsets, Id* ids_out, float* w_out,
             cudaStream_t stream) {
  const int64_t K = (int64_t)S + 1;
  Prep<Seg, Id> p;
  p.seg = seg;
  p.ids = ids;
  p.w = w;
  p.nnz = nnz;
  p.S = S;
  p.tile = tile;
  p.n_tiles = n_tiles;
  p.W = rank_warps(S, tile, blocks);
  p.bits = 32 - __builtin_clz((unsigned)K);
  p.smem_hist = 4 * K <= kPrepSmem;
  p.in_order = scratch;
  p.tile_sorted = scratch + 1;
  p.block_sums = p.tile_sorted + n_tiles;
  p.counts = p.block_sums + blocks;
  p.offsets = offsets;
  p.ids_out = ids_out;
  p.w_out = w_out;
  const size_t smem = prep_smem(S, tile, blocks, p.W, p.smem_hist);
  const void* kernel = (const void*)csr_prep_kernel<Seg, Id>;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kPrepThreads),
                                  args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename Seg>
int csr_prep_ids(const Seg* seg, const void* ids, int ids_int64,
                 const float* w, int64_t nnz, int S, int tile, int n_tiles,
                 int blocks, int* scratch, int64_t* offsets, void* ids_out,
                 float* w_out, cudaStream_t stream) {
  return ids_int64
             ? csr_prep(seg, static_cast<const int64_t*>(ids), w, nnz, S,
                        tile, n_tiles, blocks, scratch, offsets,
                        static_cast<int64_t*>(ids_out), w_out, stream)
             : csr_prep(seg, static_cast<const int32_t*>(ids), w, nnz, S,
                        tile, n_tiles, blocks, scratch, offsets,
                        static_cast<int32_t*>(ids_out), w_out, stream);
}

}  // namespace

extern "C" {

// table: contiguous (V, D) fp32, V >= 1; out: contiguous (S, D) fp32;
// ids: contiguous int32 (ids_int64 = 0) or int64 (ids_int64 = 1).
// offsets: (S + 1) int64 CSR bag boundaries into ids (bags in segment
// order), or NULL for the fixed hotness H, where bag s is ids[s*H, s*H+H).
// weights: one fp32 per id, aligned with ids, or NULL. in_order: NULL, or
// (with offsets) embedding_bag_csr_prep's flag on the device: where it
// reads 0, the bags are read from ids_bag and w_bag (its copies in bag
// order) in place of ids and weights; the launch is then a programmatic
// dependent launch, meant right behind the preparation on the same
// stream (its blocks wait for it). mean != 0 divides each bag by
// max(count, 1). The caller (kernels/embedding_bag/ops.py) passes S, D >
// 0. Launches on `stream`, allocates nothing, does not synchronise.
// Returns cudaGetLastError() after the launch (0 = launched).
int embedding_bag_f32(const float* table, const void* ids, int ids_int64,
                      const int64_t* offsets, const float* weights,
                      const void* ids_bag, const float* w_bag,
                      const int* in_order, float* out, int S, int D,
                      int64_t V, int H, int mean, void* stream) {
  return dispatch_ids(table, ids, ids_int64, offsets, weights, ids_bag,
                      w_bag, in_order, out, S, D, V, H, mean, stream);
}

// The same for a bf16 table and out (fp32 weights, f32 sums, each bag
// rounded once).
int embedding_bag_bf16(const __nv_bfloat16* table, const void* ids,
                       int ids_int64, const int64_t* offsets,
                       const float* weights, const void* ids_bag,
                       const float* w_bag, const int* in_order,
                       __nv_bfloat16* out, int S, int D, int64_t V, int H,
                       int mean, void* stream) {
  return dispatch_ids(table, ids, ids_int64, offsets, weights, ids_bag,
                      w_bag, in_order, out, S, D, V, H, mean, stream);
}

// CSR preparation for the bag entries: segment ids (nnz,) int32
// (seg_int64 = 0) or int64, ids (nnz,) int32 / int64 and weights (nnz,)
// fp32 or NULL, all contiguous; S >= 1 bags; the tile plan (tile ids per
// tile, tile % 32 == 0, n_tiles = max(1, ceil(nnz / tile))) and blocks
// (the card's SM count: one cooperative launch of `blocks` blocks, each
// holding kPrepSmem bytes at most) from kernels/embedding_bag/ops.py
// csr_plan, with nnz < 2^31. scratch: 1 + n_tiles + blocks + n_tiles * (S
// + 1) int32 (uninitialised); scratch[0] becomes the flag in_order.
// Writes offsets (S + 1) int64 and the flag; where the flag is 0 (the
// segment ids decrease somewhere) also ids_out (nnz,) of the ids' type and
// w_out (nnz,) when weights are given: the ids (and weights) in bag order,
// stable. Where it is 1, ids and weights are already in bag order and
// ids_out / w_out are not written. One launch on `stream`; allocates
// nothing, does not synchronise. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a plan that does not cover nnz.
int embedding_bag_csr_prep(const void* seg, int seg_int64, const void* ids,
                           int ids_int64, const float* weights, int64_t nnz,
                           int S, int tile, int n_tiles, int blocks,
                           int* scratch, int64_t* offsets, void* ids_out,
                           float* w_out, void* stream) {
  if (S < 1 || tile < 32 || tile % 32 != 0 || n_tiles < 1 || blocks < 1 ||
      (int64_t)tile * n_tiles < nnz || nnz >= ((int64_t)1 << 31) ||
      (weights != nullptr) != (w_out != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return seg_int64
             ? csr_prep_ids(static_cast<const int64_t*>(seg), ids, ids_int64,
                            weights, nnz, S, tile, n_tiles, blocks, scratch,
                            offsets, ids_out, w_out, st)
             : csr_prep_ids(static_cast<const int32_t*>(seg), ids, ids_int64,
                            weights, nnz, S, tile, n_tiles, blocks, scratch,
                            offsets, ids_out, w_out, st);
}

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
