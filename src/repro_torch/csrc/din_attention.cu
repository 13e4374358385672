// DIN local-activation unit (target attention) for Hopper, fp32.
//
//   f[b, l]  = [k_l, q_b, k_l - q_b, k_l * q_b]                (4D)
//   s[b, l]  = relu(relu(f W1 + b1) W2 + b2) W3 + b3          (4D->h1->h2->1)
//   p[b, :]  = softmax_l(mask[l] ? s[b, l] : -1e30)
//   out[b]   = sum_l p[b, l] * k_l                             (B, D)
//
// for one (L, D) key block shared by the whole batch (the single-call UOI
// / MaRI executor, where the user's history carries batch 1). Replaces the
// TPU Pallas kernel din_attention_kernel (src/repro/kernels/din_attention/
// kernel.py:47), which ran the unit per 128-row batch tile in VMEM with
// the MLP on the MXU; the (B, L, 4D) feature block never reached HBM.
//
// What bounds it on an H100: the least work splits the first layer,
// [k, q, k-q, k*q] W1 = k (W1a + W1c) + q (W1b - W1c) + (k*q) W1d, so a
// (b, l) pair needs only 2 * (D*h1 + h1*h2 + h2) FLOP plus adds, the key
// and query parts being computed once per l and once per b. At the single
// call's shape (B = 2048, L = 100, D = 18, h1 = 80, h2 = 40) that is
// 1.98 GFLOP against ~0.34 MB of inputs and outputs, so it is bound by
// operations: 0.029 ms at 67 TFLOP/s fp32 (0.059 ms at B = 4096). This
// kernel does the whole 4D first layer per pair, ~1.9x that work.
//
// The design: one block of 256 threads per 8 query rows. The block stages
// the keys, its 8 query rows and all three weight matrices (columns
// zero-padded to multiples of 16) in shared memory, then walks its 8 * L
// pairs in chunks of 128. A thread is (pair lane, hidden lane), 16 x 16:
// it owns 8 pairs x ceil(h1/16) hidden units of the first layer in
// registers and forms each pair's 4D features on the fly from the staged
// k and q, so the feature block never exists anywhere. The relu'd first
// layer of the chunk goes to shared memory; the second layer is spread
// the same way, and the third (h2 -> 1) is a shuffle reduction over the
// 16 hidden lanes. Scores land in shared memory; after the last chunk one
// warp per row does the masked softmax (warp reductions) and the pooled
// sum over l = 0..L-1 in order. Every pair and every row is summed in one
// fixed order, so a row's result never depends on B; rows past B are
// guarded, not padded. Rows of D = 18 floats are not 16-byte aligned, so
// every load is a 4-byte one. Tensor cores for the two MLP layers, and
// computing the per-key part k (W1a + W1c) once per l rather than once
// per pair, are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;             // query rows per block (one warp each)
constexpr int kHidLanes = 16;        // thread = (pair lane, hidden lane)
constexpr int kPairLanes = kThreads / kHidLanes;
constexpr int kPairsPer = 8;         // pairs per thread in a chunk
constexpr int kChunk = kPairLanes * kPairsPer;     // 128 pairs per pass
constexpr int kJ1Max = 8;            // h1 <= 128
constexpr int kJ2Max = 4;            // h2 <= 64
constexpr float kNegInf = -1e30f;    // the reference's mask constant

struct Layout {
  int J1, J2, h1p, h2p, hs;          // hs: row stride of the chunk's layer 1
  int k, q, w1, b1, w2, b2, w3, h, s, total;  // offsets in floats
};

__host__ __device__ inline Layout layout(int L, int D, int h1, int h2) {
  Layout o;
  o.J1 = (h1 + kHidLanes - 1) / kHidLanes;
  o.J2 = (h2 + kHidLanes - 1) / kHidLanes;
  o.h1p = o.J1 * kHidLanes;
  o.h2p = o.J2 * kHidLanes;
  o.hs = o.h1p + 1;
  o.k = 0;
  o.q = o.k + L * D;
  o.w1 = o.q + kRows * D;
  o.b1 = o.w1 + 4 * D * o.h1p;
  o.w2 = o.b1 + o.h1p;
  o.b2 = o.w2 + h1 * o.h2p;
  o.w3 = o.b2 + o.h2p;
  o.h = o.w3 + o.h2p;
  o.s = o.h + kChunk * o.hs;
  o.total = o.s + kRows * L;
  return o;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// two blocks per SM: at most 128 registers a thread
__global__ void __launch_bounds__(kThreads, 2)
    din_attention_kernel(const float* __restrict__ q,
                         const float* __restrict__ keys,
                         const int* __restrict__ mask,
                         const float* __restrict__ w1,
                         const float* __restrict__ b1,
                         const float* __restrict__ w2,
                         const float* __restrict__ b2,
                         const float* __restrict__ w3,
                         const float* __restrict__ b3,
                         float* __restrict__ out, int B, int L, int D, int h1,
                         int h2) {
  extern __shared__ float smem[];
  const Layout lo = layout(L, D, h1, h2);
  float* sK = smem + lo.k;
  float* sQ = smem + lo.q;
  float* sW1 = smem + lo.w1;
  float* sB1 = smem + lo.b1;
  float* sW2 = smem + lo.w2;
  float* sB2 = smem + lo.b2;
  float* sW3 = smem + lo.w3;
  float* sH = smem + lo.h;
  float* sS = smem + lo.s;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, B - row0);

  // ---- stage keys, this block's query rows and the padded weights ------
  for (int i = tid; i < L * D; i += kThreads) sK[i] = keys[i];
  for (int i = tid; i < nrows * D; i += kThreads)
    sQ[i] = q[(size_t)row0 * D + i];
  for (int i = tid; i < 4 * D * lo.h1p; i += kThreads) {
    const int r = i / lo.h1p, c = i - r * lo.h1p;
    sW1[i] = c < h1 ? w1[r * h1 + c] : 0.f;
  }
  for (int i = tid; i < lo.h1p; i += kThreads) sB1[i] = i < h1 ? b1[i] : 0.f;
  for (int i = tid; i < h1 * lo.h2p; i += kThreads) {
    const int r = i / lo.h2p, c = i - r * lo.h2p;
    sW2[i] = c < h2 ? w2[r * h2 + c] : 0.f;
  }
  for (int i = tid; i < lo.h2p; i += kThreads) {
    sB2[i] = i < h2 ? b2[i] : 0.f;
    sW3[i] = i < h2 ? w3[i] : 0.f;
  }
  __syncthreads();
  const float bias3 = b3[0];

  // ---- scores of the block's nrows * L pairs, kChunk at a time ----------
  const int hl = tid % kHidLanes;
  const int pl = tid / kHidLanes;
  const int npairs = nrows * L;
  for (int c0 = 0; c0 < npairs; c0 += kChunk) {
    int ko[kPairsPer], qo[kPairsPer];
#pragma unroll
    for (int i = 0; i < kPairsPer; ++i) {
      // a ragged chunk's spare lanes recompute the last pair (never stored)
      const int p = min(c0 + pl + kPairLanes * i, npairs - 1);
      const int r = p / L;
      ko[i] = (p - r * L) * D;
      qo[i] = r * D;
    }
    // layer 1: features formed on the fly, d outer, [k, q, k-q, k*q] inner
    float acc[kPairsPer][kJ1Max];
#pragma unroll
    for (int j = 0; j < kJ1Max; ++j) {
      const float bj = j < lo.J1 ? sB1[hl + kHidLanes * j] : 0.f;
#pragma unroll
      for (int i = 0; i < kPairsPer; ++i) acc[i][j] = bj;
    }
    for (int d = 0; d < D; ++d) {
      float fk[kPairsPer], fq[kPairsPer];
#pragma unroll
      for (int i = 0; i < kPairsPer; ++i) {
        fk[i] = sK[ko[i] + d];
        fq[i] = sQ[qo[i] + d];
      }
      const float* wr = sW1 + d * lo.h1p + hl;
#pragma unroll
      for (int j = 0; j < kJ1Max; ++j) {
        if (j < lo.J1) {
          const int c = kHidLanes * j;
          const float wk = wr[c];
          const float wq = wr[D * lo.h1p + c];
          const float wd = wr[2 * D * lo.h1p + c];
          const float wm = wr[3 * D * lo.h1p + c];
#pragma unroll
          for (int i = 0; i < kPairsPer; ++i) {
            float a = fmaf(fk[i], wk, acc[i][j]);
            a = fmaf(fq[i], wq, a);
            a = fmaf(fk[i] - fq[i], wd, a);
            acc[i][j] = fmaf(fk[i] * fq[i], wm, a);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kJ1Max; ++j) {
      if (j < lo.J1) {
#pragma unroll
        for (int i = 0; i < kPairsPer; ++i)
          sH[(pl + kPairLanes * i) * lo.hs + hl + kHidLanes * j] =
              fmaxf(acc[i][j], 0.f);
      }
    }
    __syncthreads();

    // layer 2 over the chunk's relu'd layer 1, then layer 3 as a reduction
    float acc2[kPairsPer][kJ2Max];
#pragma unroll
    for (int j = 0; j < kJ2Max; ++j) {
      const float bj = j < lo.J2 ? sB2[hl + kHidLanes * j] : 0.f;
#pragma unroll
      for (int i = 0; i < kPairsPer; ++i) acc2[i][j] = bj;
    }
    for (int k = 0; k < h1; ++k) {
      float hv[kPairsPer];
#pragma unroll
      for (int i = 0; i < kPairsPer; ++i)
        hv[i] = sH[(pl + kPairLanes * i) * lo.hs + k];
      const float* wr = sW2 + k * lo.h2p + hl;
#pragma unroll
      for (int j = 0; j < kJ2Max; ++j) {
        if (j < lo.J2) {
          const float w = wr[kHidLanes * j];
#pragma unroll
          for (int i = 0; i < kPairsPer; ++i)
            acc2[i][j] = fmaf(hv[i], w, acc2[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPairsPer; ++i) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kJ2Max; ++j)
        if (j < lo.J2)
          s = fmaf(fmaxf(acc2[i][j], 0.f), sW3[hl + kHidLanes * j], s);
      // the 16 hidden lanes of a pair are 16 consecutive lanes of one warp
#pragma unroll
      for (int off = kHidLanes / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      const int p = c0 + pl + kPairLanes * i;
      if (hl == 0 && p < npairs) sS[p] = s + bias3;   // sS[r * L + l]
    }
    __syncthreads();                  // sH is rewritten by the next chunk
  }

  // ---- masked softmax over L and the pooled keys, one warp per row ------
  const int warp = tid >> 5, lane = tid & 31;
  if (warp >= nrows) return;
  float* srow = sS + warp * L;
  float m = -INFINITY;
  for (int l = lane; l < L; l += 32) {
    const float v = mask[l] != 0 ? srow[l] : kNegInf;
    srow[l] = v;
    m = fmaxf(m, v);
  }
  m = warp_max(m);
  float sum = 0.f;
  for (int l = lane; l < L; l += 32) {
    const float e = expf(srow[l] - m);
    srow[l] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int l = lane; l < L; l += 32) srow[l] = srow[l] / sum;
  __syncwarp();
  float* orow = out + (size_t)(row0 + warp) * D;
  for (int d = lane; d < D; d += 32) {
    float o = 0.f;
    for (int l = 0; l < L; ++l) o = fmaf(srow[l], sK[l * D + d], o);
    orow[d] = o;
  }
}

}  // namespace

extern "C" {

// Bytes of shared memory one block stages for a unit of these widths, or
// -1 when L or D is not positive or h1 / h2 exceed the register tiles
// (h1 <= 128, h2 <= 64). kernels/din_attention/ops.py asks this before it
// routes a unit here and refuses what a block cannot hold.
long din_attention_smem_bytes(int L, int D, int h1, int h2) {
  if (L <= 0 || D <= 0 || h1 <= 0 || h2 <= 0 || h1 > kJ1Max * kHidLanes ||
      h2 > kJ2Max * kHidLanes)
    return -1;
  return (long)layout(L, D, h1, h2).total * (long)sizeof(float);
}

// query (B, D), keys (L, D), w1 (4D, h1), b1 (h1), w2 (h1, h2), b2 (h2),
// w3 (h2, 1), b3 (1): contiguous fp32; mask (L) int32 (0 = masked);
// out (B, D) fp32. The caller passes B > 0 and widths for which
// din_attention_smem_bytes is positive and fits a block. Launches on
// `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() after the launch (0 = launched).
int din_attention_f32(const float* q, const float* keys, const int* mask,
                      const float* w1, const float* b1, const float* w2,
                      const float* b2, const float* w3, const float* b3,
                      float* out, int B, int L, int D, int h1, int h2,
                      void* stream) {
  const size_t smem = (size_t)layout(L, D, h1, h2).total * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        din_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + kRows - 1) / kRows;
  din_attention_kernel<<<blocks, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      q, keys, mask, w1, b1, w2, b2, w3, b3, out, B, L, D, h1, h2);
  return (int)cudaGetLastError();
}

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
