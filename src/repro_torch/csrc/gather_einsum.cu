// Gather-aware einsum for Hopper, fp32: einsum(spec, x, table[clamp(idx)])
// with the per-row gather folded into the operand load.
//
// Replaces the TPU Pallas kernel gather_einsum_kernel
// (src/repro/kernels/gather_einsum/kernel.py:79). Three specs, the
// decomposed DIN attention contractions:
//   SPEC_Q_T      "bd,uldh->blh"  q (B,D) against T (U,L,D,H)  -> (B,L,H)
//   SPEC_W_KEYS   "bl,uld->bd"    weights (B,L) against keys (U,L,D) -> (B,D)
//   SPEC_ROWS_VEC "blh,uh->bl"    x (B,L,H) against a vector table (U,H)
// Each block (or thread) loads its own row's index, clamps it to [0, U-1]
// and reads that user's table row directly: the gathered (B, ...) operand
// (for SPEC_Q_T a (B, L, D, H) block) never exists in device memory.
//
// What bounds it on an H100: the tables are small (U <= max_users_per_batch
// = 8 users; T at DIN width is 8*100*18*80*4 B = 4.6 MB) and stay in the
// 50 MB L2 across the rows that share them, so device-memory traffic is the
// per-row operands and outputs. SPEC_Q_T writes (B, L, H) floats at 2*D = 36
// FLOP per output — 9 FLOP/byte, below the fp32 ridge, so it is bound by the
// bytes it writes. SPEC_W_KEYS reads (B, L) and writes (B, D): bytes again.
// The design keeps each output's sum in one thread, in one fixed order over
// the contracted dim, so a row's result does not depend on B, U or packing:
//   SPEC_Q_T      one block per (row, slice of L*H); the row's q sits in
//                 shared memory and consecutive threads read consecutive h
//                 of T (coalesced) and write consecutive outputs;
//   SPEC_W_KEYS   one thread per (row, d), looping over L;
//   SPEC_ROWS_VEC one thread per (row, l), looping over H.
#include <cuda_runtime.h>

namespace {

enum Spec { SPEC_Q_T = 0, SPEC_W_KEYS = 1, SPEC_ROWS_VEC = 2 };
constexpr int THREADS = 256;
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ int clamp_slot(int s, int U) {
  return s < 0 ? 0 : (s >= U ? U - 1 : s);
}

// out[b, l, h] = sum_d x[b, d] * t[u_b, l, d, h]
__global__ void __launch_bounds__(THREADS)
q_t_kernel(const float* __restrict__ x, const float* __restrict__ t,
           const int* __restrict__ idx, float* __restrict__ out,
           int B, int U, int L, int D, int H) {
  extern __shared__ float xs[];  // D floats: this row's q
  const int LH = L * H;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    for (int d = threadIdx.x; d < D; d += blockDim.x) xs[d] = x[(size_t)b * D + d];
    __syncthreads();
    const float* tb = t + (size_t)clamp_slot(idx[b], U) * LH * D;
    float* ob = out + (size_t)b * LH;
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < LH;
         e += gridDim.x * blockDim.x) {
      const int l = e / H, h = e - (e / H) * H;
      const float* tp = tb + (size_t)l * D * H + h;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc = fmaf(xs[d], tp[(size_t)d * H], acc);
      ob[e] = acc;
    }
    __syncthreads();  // xs is rewritten for the next row
  }
}

// out[b, d] = sum_l w[b, l] * t[u_b, l, d]
__global__ void __launch_bounds__(THREADS)
w_keys_kernel(const float* __restrict__ x, const float* __restrict__ t,
              const int* __restrict__ idx, float* __restrict__ out,
              int B, int U, int L, int D) {
  const size_t n = (size_t)B * D;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(e / D), d = (int)(e % D);
    const float* xp = x + (size_t)b * L;
    const float* tp = t + (size_t)clamp_slot(idx[b], U) * L * D + d;
    float acc = 0.f;
    for (int l = 0; l < L; ++l) acc = fmaf(xp[l], tp[(size_t)l * D], acc);
    out[e] = acc;
  }
}

// out[b, l] = sum_h x[b, l, h] * t[u_b, h]
__global__ void __launch_bounds__(THREADS)
rows_vec_kernel(const float* __restrict__ x, const float* __restrict__ t,
                const int* __restrict__ idx, float* __restrict__ out,
                int B, int U, int L, int H) {
  const size_t n = (size_t)B * L;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(e / L);
    const float* xp = x + e * H;
    const float* tp = t + (size_t)clamp_slot(idx[b], U) * H;
    float acc = 0.f;
    for (int h = 0; h < H; ++h) acc = fmaf(xp[h], tp[h], acc);
    out[e] = acc;
  }
}

int grid_1d(size_t n) {
  const size_t blocks = (n + THREADS - 1) / THREADS;
  return (int)(blocks < 1048576 ? blocks : 1048576);
}

}  // namespace

extern "C" {

// Row-major fp32 x / table / out, int32 idx (B,). (d1, d2, d3) are the
// non-batch dims of the table: (L, D, H) for SPEC_Q_T, (L, D) for
// SPEC_W_KEYS, (H) for SPEC_ROWS_VEC with L passed as d2. Launches on
// `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() after the launch (0 = launched).
int gather_einsum_f32(int spec, const float* x, const float* t,
                      const int* idx, float* out, int B, int U, int d1,
                      int d2, int d3, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (spec) {
    case SPEC_Q_T: {
      const int L = d1, D = d2, H = d3;
      const int lh_blocks = (L * H + THREADS - 1) / THREADS;
      const dim3 grid(lh_blocks > 0 ? lh_blocks : 1,
                      B < MAX_GRID_Y ? B : MAX_GRID_Y);
      q_t_kernel<<<grid, THREADS, (size_t)D * sizeof(float), s>>>(
          x, t, idx, out, B, U, L, D, H);
      break;
    }
    case SPEC_W_KEYS:
      w_keys_kernel<<<grid_1d((size_t)B * d2), THREADS, 0, s>>>(
          x, t, idx, out, B, U, d1, d2);
      break;
    case SPEC_ROWS_VEC:
      rows_vec_kernel<<<grid_1d((size_t)B * d2), THREADS, 0, s>>>(
          x, t, idx, out, B, U, d2, d1);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
