// Fused MaRI matmul (Eq. 7) for Hopper, fp32.
//
//   out = act(u_init + x_rest (B, K) @ w_rest (K, N))
//
// Replaces the TPU Pallas kernels mari_matmul_kernel and
// mari_matmul_kernel_gather (src/repro/kernels/mari_matmul/kernel.py:77,
// :119). The f32 accumulator starts from the user-side partial instead of
// zero, in one of three layouts (template INIT):
//   INIT_ROW    u is one (1, N) row broadcast over all B rows (one user);
//   INIT_BLOCK  u is a row-wise (B, N) block (row b carries its own user);
//   INIT_GATHER u is a stacked (U, N) table and row b starts from
//               u[clamp(idx[b], 0, U - 1)]: the gathered (B, N) block is
//               never written to device memory.
// The activation (template ACT) runs on the accumulator in the epilogue, so
// the (B, N) pre-activation never round-trips through device memory.
//
// What bounds it on an H100: at the serving path's shapes (B up to 4096,
// K ~ 1064, N = 512 for the paper's expert fc0) the product is
// 2*B*K*N = 4.5 GFLOP against ~36 MB of operands, ~125 FLOP/byte: above the
// fp32 ridge (67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte), so it is bound by
// fp32 operations. The design does the simple thing first: a 64x64 output
// tile per 256-thread block, x and w staged through shared memory in
// K-slices of 16, a 4x4 register micro-tile per thread, ragged edges
// masked in the kernel (no padding copies). No split-K: every output sums
// its K products in one fixed order starting from u, so a row's result does
// not depend on B, U or the bucket it was packed into. Tensor cores (TF32
// or bf16 wgmma) and TMA are later work; the path is full fp32.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = 256;   // (BM / TM) * (BN / TN)

enum Init { INIT_ROW = 0, INIT_BLOCK = 1, INIT_GATHER = 2 };
enum Act {
  ACT_IDENTITY = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3,
  ACT_SIGMOID = 4, ACT_TANH = 5
};

template <int ACT>
__device__ __forceinline__ float activate(float v) {
  if (ACT == ACT_RELU) return fmaxf(v, 0.f);
  if (ACT == ACT_GELU) {  // tanh form, as jax.nn.gelu's default
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
  }
  if (ACT == ACT_SILU) return v / (1.f + expf(-v));
  if (ACT == ACT_SIGMOID) return 1.f / (1.f + expf(-v));
  if (ACT == ACT_TANH) return tanhf(v);
  return v;
}

template <int INIT, int ACT>
__global__ void __launch_bounds__(THREADS)
mari_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ u, const int* __restrict__ idx,
                   float* __restrict__ out, int B, int K, int N, int U) {
  // x tile stored transposed (k-major) so the compute loop reads a column
  // of rows; +1 padding breaks the store's bank conflicts
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // thread (ty, tx) owns rows m0 + ty + 16 i and cols n0 + tx + 16 j
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + (BM / TM) * i;
    const float* urow = nullptr;
    if (row < B) {
      if (INIT == INIT_ROW) {
        urow = u;
      } else if (INIT == INIT_BLOCK) {
        urow = u + (size_t)row * N;
      } else {
        int s = idx[row];
        s = s < 0 ? 0 : (s >= U ? U - 1 : s);
        urow = u + (size_t)s * N;
      }
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + (BN / TN) * j;
      acc[i][j] = (urow != nullptr && col < N) ? urow[col] : 0.f;
    }
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int l = 0; l < (BM * BK) / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int r = e / BK, c = e % BK;
      const int gr = m0 + r, gc = k0 + c;
      xs[c][r] = (gr < B && gc < K) ? x[(size_t)gr * K + gc] : 0.f;
    }
#pragma unroll
    for (int l = 0; l < (BK * BN) / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int r = e / BN, c = e % BN;
      const int gr = k0 + r, gc = n0 + c;
      ws[r][c] = (gr < K && gc < N) ? w[(size_t)gr * N + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[k][ty + (BM / TM) * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[k][tx + (BN / TN) * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + (BM / TM) * i;
    if (row >= B) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + (BN / TN) * j;
      if (col < N) out[(size_t)row * N + col] = activate<ACT>(acc[i][j]);
    }
  }
}

template <int INIT, int ACT>
void launch(const float* x, const float* w, const float* u, const int* idx,
            float* out, int B, int K, int N, int U, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (B + BM - 1) / BM);
  mari_matmul_kernel<INIT, ACT><<<grid, THREADS, 0, stream>>>(
      x, w, u, idx, out, B, K, N, U);
}

template <int INIT>
int launch_act(int act, const float* x, const float* w, const float* u,
               const int* idx, float* out, int B, int K, int N, int U,
               cudaStream_t s) {
  switch (act) {
    case ACT_IDENTITY: launch<INIT, ACT_IDENTITY>(x, w, u, idx, out, B, K, N, U, s); break;
    case ACT_RELU: launch<INIT, ACT_RELU>(x, w, u, idx, out, B, K, N, U, s); break;
    case ACT_GELU: launch<INIT, ACT_GELU>(x, w, u, idx, out, B, K, N, U, s); break;
    case ACT_SILU: launch<INIT, ACT_SILU>(x, w, u, idx, out, B, K, N, U, s); break;
    case ACT_SIGMOID: launch<INIT, ACT_SIGMOID>(x, w, u, idx, out, B, K, N, U, s); break;
    case ACT_TANH: launch<INIT, ACT_TANH>(x, w, u, idx, out, B, K, N, U, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Row-major fp32 operands, int32 idx (INIT_GATHER only, else may be null).
// Launches on `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() after the launch (0 = launched).
int mari_matmul_f32(const float* x, const float* w, const float* u,
                    const int* idx, float* out, int B, int K, int N, int U,
                    int init, int act, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (init) {
    case INIT_ROW: return launch_act<INIT_ROW>(act, x, w, u, idx, out, B, K, N, U, s);
    case INIT_BLOCK: return launch_act<INIT_BLOCK>(act, x, w, u, idx, out, B, K, N, U, s);
    case INIT_GATHER: return launch_act<INIT_GATHER>(act, x, w, u, idx, out, B, K, N, U, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
