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
// hotness H (the executor's (B, H) ids, which need no sort).
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
// for a dropped one), in three launches, with no host synchronisation
// (every size is known on the host: nnz, S, the tile plan):
//  1. csr_hist: one block per tile of `tile` ids counts each key in the
//     tile into row t of counts (n_tiles, S + 1), with integer atomics
//     (their order cannot change a count; one add for a warp step of one
//     key), and records whether the tile's keys do not decrease, from the
//     id before the tile on;
//  2. csr_scan: one thread per (key, group of tiles) turns each key's
//     column of counts into its ids in earlier tiles; a block's 32 keys'
//     exclusive prefix goes to offsets and their sum to block_sums; the
//     last block to finish (an integer ticket) scans block_sums and adds
//     each block's prefix to its keys (offsets[s] = ids of segments < s,
//     offsets[S] = the kept ids) and ANDs the tiles' flags;
//  3. csr_scatter: one block per tile, up to 8 warps each owning a
//     contiguous part of it. The parts' counts per key (atomics again)
//     give each part's first position per key: offsets[key] + counts[t]
//     [key] + the key's ids in earlier parts. Each warp then walks its part
//     in order, 32 ids a step: an id's position is its key's running count
//     plus the lanes below it with the same key (one ballot per key bit).
//     The running counts live in shared memory (W (S + 1) ints, W warps,
//     S + 1 <= 49152), else one warp walks the tile over its row of counts
//     in global memory (read and written volatile). Where every key is
//     already in order the positions are the identity and the block
//     copies. ids and weights land in bag order.
// So each bag holds its ids in input order, exactly as a stable sort gives
// them, and the bag kernel's result is bitwise that of the sort-based
// preparation. The tile plan (kernels/embedding_bag/ops.py csr_plan) keeps
// the counts at n_tiles * (S + 1) <= max(2^22, S + 1) int32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// otherwise [offsets[s], offsets[s + 1]). E: the table's and output's
// element type (float or bf16).
template <typename E, typename Idx, int VEC, bool FIXED, bool WEIGHTED>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    embedding_bag_kernel(const E* __restrict__ table,
                         const Idx* __restrict__ ids,
                         const int64_t* __restrict__ offsets,
                         const float* __restrict__ weights,
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
    start = offsets[s];
    end = offsets[s + 1];
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
           const float* weights, E* out, int S, int D, int64_t V, int H,
           int mean, cudaStream_t stream) {
  const dim3 grid((S + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (D + 32 * VEC - 1) / (32 * VEC));
  const dim3 block(32 * kWarpsPerBlock);
  const bool fixed = offsets == nullptr;
  auto kernel = fixed ? (weights ? embedding_bag_kernel<E, Idx, VEC, true, true>
                                 : embedding_bag_kernel<E, Idx, VEC, true, false>)
                      : (weights ? embedding_bag_kernel<E, Idx, VEC, false, true>
                                 : embedding_bag_kernel<E, Idx, VEC, false, false>);
  kernel<<<grid, block, 0, stream>>>(table, ids, offsets, weights, out, S, D,
                                     V, H, mean);
  return (int)cudaGetLastError();
}

template <typename E, typename Idx>
int dispatch_vec(const E* table, const Idx* ids, const int64_t* offsets,
                 const float* weights, E* out, int S, int D, int64_t V,
                 int H, int mean, cudaStream_t stream) {
  // 4-column loads need every row start aligned to 4 values
  const uintptr_t a = 4 * sizeof(E);
  const bool vec4 = D % 4 == 0 && ((uintptr_t)table % a == 0) &&
                    ((uintptr_t)out % a == 0);
  return vec4 ? launch<E, Idx, 4>(table, ids, offsets, weights, out, S, D, V,
                                  H, mean, stream)
              : launch<E, Idx, 1>(table, ids, offsets, weights, out, S, D, V,
                                  H, mean, stream);
}

template <typename E>
int dispatch_ids(const E* table, const void* ids, int ids_int64,
                 const int64_t* offsets, const float* weights, E* out, int S,
                 int D, int64_t V, int H, int mean, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ids_int64
             ? dispatch_vec(table, static_cast<const int64_t*>(ids), offsets,
                            weights, out, S, D, V, H, mean, st)
             : dispatch_vec(table, static_cast<const int32_t*>(ids), offsets,
                            weights, out, S, D, V, H, mean, st);
}

// ---- CSR preparation: a stable counting sort by segment ------------------

constexpr unsigned kFull = 0xffffffffu;
constexpr int kHistThreads = 256;
constexpr int kScanGroups = 8;          // tile groups (warps) per scan block
constexpr int kRankWarps = 8;           // warps ranking one tile
constexpr int kSmemBytes = 196608;      // shared memory for per-warp counts
constexpr int kAhead = 8;               // chunks of ids loaded ahead

template <typename Seg>
__device__ __forceinline__ int seg_key(const Seg* seg, int64_t i, int S) {
  const Seg s = seg[i];
  return s >= 0 && s < (Seg)S ? (int)s : S;
}

// the lanes whose key equals this lane's (keys -1 .. 2^BITS - 2), by one
// ballot per key bit, unrolled: a constant cost, where __match_any_sync
// grows with the number of distinct keys in the warp
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

template <typename Seg, bool SMEM>
__global__ void __launch_bounds__(kHistThreads)
    csr_hist(const Seg* __restrict__ seg, int64_t nnz, int S, int tile,
             int* __restrict__ counts, int* __restrict__ tile_sorted,
             int* __restrict__ done) {
  extern __shared__ int cnt_s[];
  const int K = S + 1;
  int* row = counts + (size_t)blockIdx.x * K;
  int* cnt = SMEM ? cnt_s : row;
  for (int k = threadIdx.x; k < K; k += blockDim.x) cnt[k] = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) *done = 0;   // csr_scan's ticket
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = __shfl_sync(kFull, (int)threadIdx.x >> 5, 0);
  const int64_t lo = (int64_t)blockIdx.x * tile;
  const int64_t hi = lo + tile < nnz ? lo + tile : nnz;
  int ok = 1;
  // 8 steps' keys (and the keys before them) loaded at once
  for (int64_t b0 = lo + 32 * warp; b0 < hi; b0 += 8 * blockDim.x) {
    int key[8], prev[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int64_t i = b0 + u * blockDim.x + lane;
      key[u] = i < hi ? seg_key(seg, i, S) : -1;
      prev[u] = i < hi && i > 0 ? seg_key(seg, i - 1, S) : -1;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (prev[u] > key[u]) ok = 0;
      count_keys(cnt, key[u], lane);
    }
  }
  ok = __syncthreads_and(ok);
  if (SMEM)
    for (int k = threadIdx.x; k < K; k += blockDim.x) row[k] = cnt_s[k];
  if (threadIdx.x == 0) tile_sorted[blockIdx.x] = ok;
}

// block b: keys 32 b .. 32 b + 31, each a column of counts over the tiles
// (8 groups of tiles, a warp each). Each count becomes the key's ids in
// earlier tiles; the block's keys' exclusive prefix goes to offsets and
// its sum to block_sums[b]. The last block to finish scans block_sums and
// adds each block's prefix to its keys' offsets.
__global__ void __launch_bounds__(32 * kScanGroups)
    csr_scan(int* __restrict__ counts, int n_tiles, int S,
             int* __restrict__ block_sums,
             const int* __restrict__ tile_sorted, int* __restrict__ done,
             int* __restrict__ sorted, int64_t* __restrict__ offsets) {
  __shared__ int part[kScanGroups][32];
  __shared__ int scratch[32];
  __shared__ int last;
  const int K = S + 1;
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int key = blockIdx.x * 32 + lane;
  const int per = (n_tiles + kScanGroups - 1) / kScanGroups;
  const int t0 = g * per < n_tiles ? g * per : n_tiles;
  const int t1 = t0 + per < n_tiles ? t0 + per : n_tiles;
  int sum = 0;
  if (key < K)
#pragma unroll 8
    for (int t = t0; t < t1; ++t) sum += counts[(size_t)t * K + key];
  part[g][lane] = sum;
  __syncthreads();
  int run = 0;
  for (int h = 0; h < g; ++h) run += part[h][lane];
  if (key < K) {
    // 8 tiles' counts loaded before any is rewritten
    for (int tb = t0; tb < t1; tb += 8) {
      int v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = tb + u < t1 ? counts[(size_t)(tb + u) * K + key] : 0;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (tb + u < t1) counts[(size_t)(tb + u) * K + key] = run;
        run += v[u];
      }
    }
  }
  if (g == kScanGroups - 1) {             // run: the key's total
    int inc = key < K ? run : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, inc, off);
      if (lane >= off) inc += t;
    }
    if (key < K) offsets[key] = inc - run;
    if (lane == 31) block_sums[blockIdx.x] = inc;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: exclusive scan of the block sums, in place
  const int nb = gridDim.x;
  int carry = 0;
  for (int b0 = 0; b0 < nb; b0 += blockDim.x) {
    const int b = b0 + threadIdx.x;
    const int v = b < nb ? __ldcg(block_sums + b) : 0;
    int total;
    const int ex = block_exclusive_scan(v, scratch, &total);
    if (b < nb) block_sums[b] = carry + ex;
    carry += total;
  }
  __syncthreads();
  // every key's offset: its block's prefix plus its prefix in the block
  for (int kb = 0; kb < K; kb += 8 * blockDim.x) {
    int64_t o[8];
    int bp[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int k = kb + u * blockDim.x + threadIdx.x;
      o[u] = k < K ? __ldcg(offsets + k) : 0;
      bp[u] = k < K ? __ldcg(block_sums + (k >> 5)) : 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int k = kb + u * blockDim.x + threadIdx.x;
      if (k < K) offsets[k] = o[u] + bp[u];
    }
  }
  int all = 1;
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x)
    all &= __ldcg(tile_sorted + t);
  all = __syncthreads_and(all);
  if (threadIdx.x == 0) *sorted = all;
}

// a warp walks its part lo .. hi in order, 32 ids a step: an id's position
// is its key's running count plus the lanes below it with the same key
// (the lanes of one key read the count and write back one value). Chunk
// c's key, id and weight sit in slot c % kAhead, loaded kAhead chunks
// ahead; chunks past hi hold key -1 and change nothing.
template <int BITS, typename Seg, typename Id>
__device__ __forceinline__ void rank_part(const Seg* seg, const Id* ids,
                                          const float* w, int64_t lo,
                                          int64_t hi, int S, volatile int* cnt,
                                          Id* ids_out, float* w_out,
                                          int lane) {
  int key[kAhead];
  Id id[kAhead];
  float wv[kAhead];
  auto fetch = [&](int u, int64_t i) {
    key[u] = i < hi ? seg_key(seg, i, S) : -1;
    id[u] = i < hi ? ids[i] : Id(0);
    wv[u] = w && i < hi ? w[i] : 0.f;
  };
#pragma unroll
  for (int u = 0; u < kAhead; ++u) fetch(u, lo + 32 * u + lane);
  for (int64_t base = lo; base < hi; base += 32 * kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int k = key[u];
      const unsigned same = match_key<BITS>(k);
      const int start = cnt[k >= 0 ? k : 0];
      __syncwarp();                       // every read before the write
      if (k >= 0) cnt[k] = start + __popc(same);
      __syncwarp();
      const int pos = start + __popc(same & ((1u << lane) - 1u));
      if (k >= 0) {
        ids_out[pos] = id[u];
        if (w) w_out[pos] = wv[u];
      }
      fetch(u, base + 32 * (u + kAhead) + lane);
    }
  }
}

// one tile: W warps each rank a contiguous part of it over their own
// running counts per key (shared memory: W (S + 1) ints), counted first
// and turned into each part's first positions; W = 0 means one warp over
// the tile's own row of counts in global memory (read and written
// volatile)
template <typename Seg, typename Id>
__global__ void __launch_bounds__(32 * kRankWarps)
    csr_scatter(const Seg* __restrict__ seg, const Id* __restrict__ ids,
                const float* __restrict__ w, int64_t nnz, int S, int tile,
                int W, int* __restrict__ counts,
                const int64_t* __restrict__ offsets,
                const int* __restrict__ sorted, Id* __restrict__ ids_out,
                float* __restrict__ w_out) {
  extern __shared__ int4 cnt4[];
  int* cnt_s = reinterpret_cast<int*>(cnt4);
  const int K = S + 1;
  // the warp index and the flag as values the compiler sees are the same
  // on every lane (a shuffle from lane 0, a vote): branches on them keep
  // the warp converged, so the collectives below need no reconvergence
  const int warp = __shfl_sync(kFull, (int)threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const int64_t lo = (int64_t)blockIdx.x * tile;
  const int64_t hi = lo + tile < nnz ? lo + tile : nnz;
  if (__all_sync(kFull, *sorted != 0)) {  // every key in order: identity
#pragma unroll 8
    for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      ids_out[i] = ids[i];
      if (w) w_out[i] = w[i];
    }
    return;
  }
  int* row = counts + (size_t)blockIdx.x * K;
  const int nw = W > 0 ? W : 1;
  // warp `warp`'s part: whole chunks of 32 ids
  const int64_t part = ((hi - lo + 32 * nw - 1) / (32 * nw)) * 32;
  const int64_t plo = lo + warp * part < hi ? lo + warp * part : hi;
  const int64_t phi = plo + part < hi ? plo + part : hi;
  volatile int* cnt;
  if (W > 0) {
    const int n4 = (W * K + 3) / 4;
    for (int k = threadIdx.x; k < n4; k += blockDim.x)
      cnt4[k] = make_int4(0, 0, 0, 0);
    __syncthreads();
    if (warp < W) {
      int key[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int64_t i = plo + 32 * u + lane;
        key[u] = i < phi ? seg_key(seg, i, S) : -1;
      }
      for (int64_t base = plo; base < phi; base += 32 * kAhead) {
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const int64_t at = base + 32 * u;
          if (at < phi) count_keys(cnt_s + warp * K, key[u], lane);
          const int64_t i = at + 32 * kAhead + lane;
          key[u] = i < phi ? seg_key(seg, i, S) : -1;
        }
      }
    }
    __syncthreads();
    for (int kb = 0; kb < K; kb += 8 * blockDim.x) {
      int run[8];                         // 8 keys' bases loaded at once
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int k = kb + u * blockDim.x + threadIdx.x;
        run[u] = k < K ? (int)offsets[k] + row[k] : 0;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int k = kb + u * blockDim.x + threadIdx.x;
        if (k < K)
          for (int v = 0; v < W; ++v) {
            const int c = cnt_s[v * K + k];
            cnt_s[v * K + k] = run[u];
            run[u] += c;
          }
      }
    }
    __syncthreads();
    if (warp >= W) return;
    cnt = cnt_s + warp * K;
  } else {
    if (warp > 0) return;
    cnt = row;
    for (int kb = 0; kb < K; kb += 8 * 32) {
      int run[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int k = kb + 32 * u + lane;
        run[u] = k < K ? (int)offsets[k] + row[k] : 0;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (kb + 32 * u + lane < K) cnt[kb + 32 * u + lane] = run[u];
    }
    __syncwarp();
  }
  if (K + 1 < (1 << 16))
    rank_part<16>(seg, ids, w, plo, phi, S, cnt, ids_out, w_out, lane);
  else
    rank_part<32>(seg, ids, w, plo, phi, S, cnt, ids_out, w_out, lane);
}

// the warps that rank one tile: as many per-warp count arrays of S + 1
// ints as kSmemBytes holds, up to kRankWarps; 0 when not even one fits
int rank_warps(int S) {
  const long long w = kSmemBytes / (4LL * (S + 1));
  return (int)(w < kRankWarps ? w : kRankWarps);
}

template <typename Seg, typename Id>
int csr_prep(const Seg* seg, const Id* ids, const float* w, int64_t nnz,
             int S, int tile, int n_tiles, int* scratch, int64_t* offsets,
             Id* ids_out, float* w_out, cudaStream_t stream) {
  const int K = S + 1;
  const int scan_blocks = (K + 31) / 32;
  int* counts = scratch;
  int* block_sums = counts + (size_t)n_tiles * K;
  int* tile_sorted = block_sums + scan_blocks;
  int* done = tile_sorted + n_tiles;
  int* sorted = done + 1;
  const int W = rank_warps(S);
  const size_t hist_bytes = W > 0 ? (size_t)K * sizeof(int) : 0;
  const size_t rank_bytes = (size_t)((W * K + 3) / 4) * 16;
  cudaError_t e = cudaSuccess;
  if (hist_bytes > 48 * 1024)
    e = cudaFuncSetAttribute(csr_hist<Seg, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)hist_bytes);
  if (e == cudaSuccess && rank_bytes > 48 * 1024)
    e = cudaFuncSetAttribute(csr_scatter<Seg, Id>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)rank_bytes);
  if (e != cudaSuccess) return (int)e;
  if (W > 0)
    csr_hist<Seg, true><<<n_tiles, kHistThreads, hist_bytes, stream>>>(
        seg, nnz, S, tile, counts, tile_sorted, done);
  else
    csr_hist<Seg, false><<<n_tiles, kHistThreads, 0, stream>>>(
        seg, nnz, S, tile, counts, tile_sorted, done);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  csr_scan<<<scan_blocks, 32 * kScanGroups, 0, stream>>>(
      counts, n_tiles, S, block_sums, tile_sorted, done, sorted, offsets);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  csr_scatter<Seg, Id><<<n_tiles, 32 * kRankWarps, rank_bytes, stream>>>(
      seg, ids, w, nnz, S, tile, W, counts, offsets, sorted, ids_out, w_out);
  return (int)cudaGetLastError();
}

template <typename Seg>
int csr_prep_ids(const Seg* seg, const void* ids, int ids_int64,
                 const float* w, int64_t nnz, int S, int tile, int n_tiles,
                 int* scratch, int64_t* offsets, void* ids_out, float* w_out,
                 cudaStream_t stream) {
  return ids_int64
             ? csr_prep(seg, static_cast<const int64_t*>(ids), w, nnz, S,
                        tile, n_tiles, scratch, offsets,
                        static_cast<int64_t*>(ids_out), w_out, stream)
             : csr_prep(seg, static_cast<const int32_t*>(ids), w, nnz, S,
                        tile, n_tiles, scratch, offsets,
                        static_cast<int32_t*>(ids_out), w_out, stream);
}

}  // namespace

extern "C" {

// table: contiguous (V, D) fp32, V >= 1; out: contiguous (S, D) fp32;
// ids: contiguous int32 (ids_int64 = 0) or int64 (ids_int64 = 1).
// offsets: (S + 1) int64 CSR bag boundaries into ids (bags in segment
// order), or NULL for the fixed hotness H, where bag s is ids[s*H, s*H+H).
// weights: one fp32 per id, aligned with ids, or NULL. mean != 0 divides
// each bag by max(count, 1). The caller (kernels/embedding_bag/ops.py)
// passes S, D > 0. Launches on `stream`, allocates nothing, does not
// synchronise. Returns cudaGetLastError() after the launch (0 = launched).
int embedding_bag_f32(const float* table, const void* ids, int ids_int64,
                      const int64_t* offsets, const float* weights,
                      float* out, int S, int D, int64_t V, int H, int mean,
                      void* stream) {
  return dispatch_ids(table, ids, ids_int64, offsets, weights, out, S, D, V,
                      H, mean, stream);
}

// The same for a bf16 table and out (fp32 weights, f32 sums, each bag
// rounded once).
int embedding_bag_bf16(const __nv_bfloat16* table, const void* ids,
                       int ids_int64, const int64_t* offsets,
                       const float* weights, __nv_bfloat16* out, int S, int D,
                       int64_t V, int H, int mean, void* stream) {
  return dispatch_ids(table, ids, ids_int64, offsets, weights, out, S, D, V,
                      H, mean, stream);
}

// CSR preparation for embedding_bag_f32: segment ids (nnz,) int32
// (seg_int64 = 0) or int64, ids (nnz,) int32 / int64 and weights (nnz,)
// fp32 or NULL, all contiguous; S >= 1 bags; the tile plan (tile ids per
// tile, n_tiles = max(1, ceil(nnz / tile)), tile % 32 == 0) from
// kernels/embedding_bag/ops.py csr_plan, with nnz < 2^31. scratch:
// n_tiles * (S + 1) + ceil((S + 1) / 32) + n_tiles + 2 int32
// (uninitialised). Writes
// offsets (S + 1) int64, ids_out (nnz,) of the ids' type and w_out
// (nnz,) when weights are given: the ids (and weights) in bag order,
// stable. Three launches on `stream`; allocates nothing, does not
// synchronise. Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a plan that does not cover nnz.
int embedding_bag_csr_prep(const void* seg, int seg_int64, const void* ids,
                           int ids_int64, const float* weights, int64_t nnz,
                           int S, int tile, int n_tiles, int* scratch,
                           int64_t* offsets, void* ids_out, float* w_out,
                           void* stream) {
  if (S < 1 || tile < 32 || tile % 32 != 0 || n_tiles < 1 ||
      (int64_t)tile * n_tiles < nnz || nnz >= ((int64_t)1 << 31) ||
      (weights != nullptr) != (w_out != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return seg_int64
             ? csr_prep_ids(static_cast<const int64_t*>(seg), ids, ids_int64,
                            weights, nnz, S, tile, n_tiles, scratch, offsets,
                            ids_out, w_out, st)
             : csr_prep_ids(static_cast<const int32_t*>(seg), ids, ids_int64,
                            weights, nnz, S, tile, n_tiles, scratch, offsets,
                            ids_out, w_out, st);
}

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
