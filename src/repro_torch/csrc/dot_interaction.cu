// DLRM dot interaction for Hopper, fp32.
//
//   out[b, p] = sum_d x[b, i_p, d] * x[b, j_p, d]
//
// with (i_p, j_p) the upper triangle of the F x F gram in row-major order,
// np.triu_indices(F, k=1) (k=0 with KEEP_SELF). Replaces the TPU Pallas
// kernel dot_interaction_kernel (src/repro/kernels/dot_interaction/
// kernel.py:41), which filled a (bm, F, F) gram in VMEM and picked the
// triangle with a one-hot (F*F, P) matmul on the MXU; here only the
// gram's upper 4 x 4 tiles are computed and the triangle is written
// directly.
//
// What bounds it on an H100: at the serving path's shape (B up to 4096,
// F = 27, D = 128, P = 351) it moves 4 * (B*F*D + B*P) = 62.4 MB and does
// 2*B*P*D = 0.37 GFLOP: 6 FLOP/byte, below the fp32 ridge (67 TFLOP/s /
// 3.35 TB/s = 20 FLOP/byte), so it is bound by bytes. A design with one
// thread per pair, reading both D-float rows from shared memory for each
// pair, is bound by shared-memory reads instead (2 * P * D per row).
//
// The design: one warp per candidate row, `rows` warps per block, no
// block-wide barrier (each warp owns its row). The warp stages x[b]
// transposed in shared memory with cp.async, xs[d][f] with F zero-padded
// to Fp, a multiple of 4, so one 16-byte load reads four features at one
// d. Each lane owns 4 x 4 tiles (ti <= tj) of the Fp x Fp gram: per d it
// loads one float4 of features 4ti.. and one of features 4tj.. (the
// warp's loads all fall in one Fp-float row of xs) and does 16 FMAs: two
// 16-byte shared loads per 16 FMAs, where one thread per pair needs two
// 4-byte loads per FMA (F = 27: 28 tiles, one per lane). Each pair sums
// d = 0..D-1 in order with fmaf, so a row's result never depends on B;
// ragged B needs no padding. wgmma and TMA are later work.
#include <cuda_runtime.h>

namespace {

template <bool KEEP_SELF>
__device__ __forceinline__ int pair_index(int i, int j, int F) {
  // start of triangle row i, then the offset of j inside it
  return KEEP_SELF ? i * (2 * F - i + 1) / 2 + (j - i)
                   : i * (2 * F - i - 1) / 2 + (j - i - 1);
}

template <bool KEEP_SELF>
__global__ void dot_interaction_kernel(const float* __restrict__ x,
                                       float* __restrict__ out, int B, int F,
                                       int D, int P) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  const int T = (F + 3) >> 2;          // 4-feature groups per d
  const int Fp = T << 2;
  float4* xs4 = smem4 + (size_t)warp * D * T;     // this warp's (D, Fp)
  float* xs = reinterpret_cast<float*>(xs4);
  const float* xb = x + (size_t)b * F * D;
  // cp.async copies global -> shared without a register round trip, so
  // all of a lane's loads of the row are in flight at once (coalesced:
  // consecutive lanes read consecutive d); the padded features are zeroed
  const unsigned xs_addr = (unsigned)__cvta_generic_to_shared(xs);
  for (int f = 0; f < F; ++f) {
    for (int d = lane; d < D; d += 32) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       xs_addr + 4u * (unsigned)(d * Fp + f)),
                   "l"(xb + f * D + d));
    }
  }
  for (int f = F; f < Fp; ++f) {
    for (int d = lane; d < D; d += 32) xs[d * Fp + f] = 0.f;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();

  float* ob = out + (size_t)b * P;
  const int tiles = T * (T + 1) / 2;
  for (int t = lane; t < tiles; t += 32) {
    // t -> (ti, tj), ti <= tj, row-major over the tile triangle
    int ti = 0, rem = t, row_len = T;
    while (rem >= row_len) {
      rem -= row_len;
      ++ti;
      --row_len;
    }
    const int tj = ti + rem;
    float acc[4][4] = {};
    for (int d = 0; d < D; ++d) {
      const float4 a = xs4[d * T + ti];
      const float4 c = xs4[d * T + tj];
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(av[r], cv[s], acc[r][s]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int i = 4 * ti + r, j = 4 * tj + s;
        if (j < F && (KEEP_SELF ? i <= j : i < j))
          ob[pair_index<KEEP_SELF>(i, j, F)] = acc[r][s];
      }
  }
}

template <bool KEEP_SELF>
int launch(const float* x, float* out, int B, int F, int D, int P, int rows,
           cudaStream_t stream) {
  const int T = (F + 3) / 4;
  const size_t smem = (size_t)rows * D * T * sizeof(float4);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        dot_interaction_kernel<KEEP_SELF>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + rows - 1) / rows;
  dot_interaction_kernel<KEEP_SELF><<<blocks, 32 * rows, smem, stream>>>(
      x, out, B, F, D, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: contiguous row-major (B, F, D) fp32; out: (B, P) fp32 with
// P = F * (F - 1) / 2, or F * (F + 1) / 2 with keep_self; `rows` candidate
// rows per block (one warp each). The caller (kernels/dot_interaction/
// ops.py) passes B, D, P > 0 and a `rows` whose rows * D * ceil4(F) floats
// fit a block's shared memory. Launches on `stream`, allocates nothing,
// does not synchronise. Returns cudaGetLastError() after the launch
// (0 = launched).
int dot_interaction_f32(const float* x, float* out, int B, int F, int D,
                        int keep_self, int rows, void* stream) {
  const int P = keep_self ? F * (F + 1) / 2 : F * (F - 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return keep_self ? launch<true>(x, out, B, F, D, P, rows, s)
                   : launch<false>(x, out, B, F, D, P, rows, s);
}

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
