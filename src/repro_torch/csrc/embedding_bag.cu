// EmbeddingBag for Hopper, fp32: a CSR-offset segmented reduction.
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
// order, with the bag boundaries given as CSR offsets (the wrapper sorts
// and builds them), or implicitly as s * H for a fixed hotness H (the
// executor's (B, H) ids, which need no sort).
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
// Index contract: ids outside [0, V) clamp to [0, V - 1] (the port's
// index rule, as jnp.take(mode="clip")): no id ever makes the kernel read
// outside the table. Segment ids outside [0, S) never reach the kernel:
// the wrapper drops them, as jax.ops.segment_sum does.
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

// One warp per (bag, column tile). FIXED: bag s spans ids [s * H, s * H + H);
// otherwise [offsets[s], offsets[s + 1]).
template <typename Idx, int VEC, bool FIXED, bool WEIGHTED>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    embedding_bag_kernel(const float* __restrict__ table,
                         const Idx* __restrict__ ids,
                         const int64_t* __restrict__ offsets,
                         const float* __restrict__ weights,
                         float* __restrict__ out, int S, int D, int64_t V,
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
        v[u] = active ? *reinterpret_cast<const T*>(table + id * D + col)
                      : V_::zero();
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
        const T v = *reinterpret_cast<const T*>(table + id * D + col);
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
  *reinterpret_cast<T*>(out + (int64_t)s * D + col) = acc;
}

template <typename Idx, int VEC>
int launch(const float* table, const Idx* ids, const int64_t* offsets,
           const float* weights, float* out, int S, int D, int64_t V, int H,
           int mean, cudaStream_t stream) {
  const dim3 grid((S + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (D + 32 * VEC - 1) / (32 * VEC));
  const dim3 block(32 * kWarpsPerBlock);
  const bool fixed = offsets == nullptr;
  if (fixed && weights)
    embedding_bag_kernel<Idx, VEC, true, true><<<grid, block, 0, stream>>>(
        table, ids, offsets, weights, out, S, D, V, H, mean);
  else if (fixed)
    embedding_bag_kernel<Idx, VEC, true, false><<<grid, block, 0, stream>>>(
        table, ids, offsets, weights, out, S, D, V, H, mean);
  else if (weights)
    embedding_bag_kernel<Idx, VEC, false, true><<<grid, block, 0, stream>>>(
        table, ids, offsets, weights, out, S, D, V, H, mean);
  else
    embedding_bag_kernel<Idx, VEC, false, false><<<grid, block, 0, stream>>>(
        table, ids, offsets, weights, out, S, D, V, H, mean);
  return (int)cudaGetLastError();
}

template <typename Idx>
int dispatch_vec(const float* table, const Idx* ids, const int64_t* offsets,
                 const float* weights, float* out, int S, int D, int64_t V,
                 int H, int mean, cudaStream_t stream) {
  // float4 loads need every row start 16-byte aligned
  const bool vec4 = D % 4 == 0 && ((uintptr_t)table % 16 == 0) &&
                    ((uintptr_t)out % 16 == 0);
  return vec4 ? launch<Idx, 4>(table, ids, offsets, weights, out, S, D, V, H,
                               mean, stream)
              : launch<Idx, 1>(table, ids, offsets, weights, out, S, D, V, H,
                               mean, stream);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ids_int64
             ? dispatch_vec<int64_t>(table,
                                     static_cast<const int64_t*>(ids),
                                     offsets, weights, out, S, D, V, H, mean,
                                     st)
             : dispatch_vec<int32_t>(table,
                                     static_cast<const int32_t*>(ids),
                                     offsets, weights, out, S, D, V, H, mean,
                                     st);
}

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
