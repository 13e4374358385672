// DIN local-activation unit (target attention) for Hopper, fp32 and bf16.
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
// Least work. The first layer splits exactly:
//   [k, q, k-q, k*q] W1 = k (W1a + W1c) + q (W1b - W1c) + (k*q) W1d,
// so K1[l] = k_l (W1a + W1c) + b1 is needed once per key and Q1[b] =
// q_b (W1b - W1c) once per query row, and a (b, l) pair needs only
//   D (k*q) + 2 D h1 ((k*q) W1d) + 2 h1 (+ K1 + Q1, relu)
//   + 2 h1 h2 + h2 (layer 2, b2) + 2 h2 + 1 (layer 3, b3) + 3 + 2 D
// (softmax, pool) operations: the per-pair count of chip_smoke.py's
// din_bound, 2 * (18*80 + 80*40) = 9280 of ~9.6k FLOP at DIN width
// (B = 2048, L = 100, D = 18, h1 = 80, h2 = 40: 1.98 GFLOP in all).
//
// What bounds it on an H100: operations. On the CUDA cores (67 TFLOP/s
// fp32) the least work takes 0.0295 ms. This kernel runs the two per-pair
// products on the tensor cores with mma.sync.m16n8k8 tf32 and a 3xTF32
// split (hi = tf32(a), lo = tf32(a - hi), each product lo*hi + hi*lo +
// hi*hi accumulated in fp32: the fp32 accuracy mari_matmul.cu keeps), so
// its bound is 3 * 2 * (D h1 + h1 h2) per pair at 495 TFLOP/s, 0.0115 ms.
// The mma shape pads that work: D to a multiple of 8 (18 -> 24) and L to a
// multiple of 16 (100 -> 112).
//
// The design: one block of 256 threads (8 warps) per 8 query rows, so
// B = 2048 gives 256 blocks, two resident per SM at DIN width (113 KB of
// shared memory each). The block stages its rows' queries, the folded
// first-layer blocks (W1a + W1c, W1b - W1c) and W1d and W2 as hi / lo mma
// B fragments (16 bytes a lane, conflict-free). Then it streams the keys
// in chunks of up to kChunk = 112 (7 m16 tiles; DIN's 100 keys are one
// chunk; fewer where a wide unit's weights leave less shared memory, a
// function of the widths alone; the first chunk is staged with the
// weights, under one wait). Per chunk it stages the chunk's keys and
// mask, computes their K1 (keys x h1) and, with the first chunk, its rows'
// Q1 (8 x h1) on the CUDA cores in shared memory, a thread owning 4 rows x
// 4 columns, and then the chunk's scores. A warp task is one query row
// against 16 consecutive keys (an m16 tile), one n tile of 8 hidden units
// at a time:
//   GEMM 1: C = K1[l] + Q1[b] (fp32 adds), then += (k*q) W1d, the A
//           fragment formed from the staged k and q and split in registers;
//   relu;   the C fragment of GEMM 1 is GEMM 2's A fragment as it lies:
//           W2's rows are permuted inside each 8-row block to match
//           (thread t holds columns 2t, 2t+1 of C and k = t, t+4 of A);
//   GEMM 2: C2 = b2, += relu(h1) W2, one k step per n tile of GEMM 1;
//   layer 3 (h2 -> 1) on the CUDA cores: each lane sums its columns, the
//           four lanes of a row reduce by a fixed shuffle tree.
// The hi*hi products and the two cross terms go to separate accumulators,
// added once a sum is complete, so chains of dependent mma stay short.
// The chunk's scores land in shared memory; then one warp per row folds
// them into an online softmax: a running max m and sum s, and the (D,)
// pooled sum in the row warp's registers (D <= 64: lane d holds columns d
// and d + 32), all rescaled by exp(m_old - m_new) when the max rises. The
// chunk's keys are pooled with weights exp(score - m) over l in order,
// and the row's output is the pooled sum over s once the last chunk is
// in. Chunks go in a fixed order and a pair (b, l) always sits at row
// l % 16 of its tile and runs the same instruction sequence whatever B, so
// a row's result never depends on B; rows past B are guarded, not padded.
// Shared memory holds one chunk of keys, K1, scores and mask, so it no
// longer grows with L: a block takes any history length. Register tiles:
// an unguarded instance for D 17..24, h1 73..80, h2 33..40 (DIN's width)
// and a guarded one for D <= 64, h1 <= 128, h2 <= 64; wider units are
// refused (din_attention_smem_bytes returns -1).
//
// bf16 (din_attention_bf16): bf16 query, keys and weights, every product
// exact and every sum in f32, the output rounded to bf16 once, as the TPU
// kernel; k*q is rounded to bf16 before the product with W1d, as the TPU
// forms it. Its bound: the two per-pair products once at the bf16 peak,
// 0.0019 ms at DIN width. It runs on the bf16 tensor cores:
//   staging: keys and query rows in bf16 (half the key chunk's bytes);
//           W1's four blocks and W2 as bf16 mma B fragments, exact, the
//           biases in fp32;
//   fold:   K1 = b1 + k W1a + k W1c per key and Q1 = q W1b - q W1c per
//           row on the tensor cores too (m16n8k8, f32 sums; a warp an m16
//           tile of keys or the block's rows), where the fp32 pipeline's
//           fold on the CUDA cores (every block folds every key) was the
//           largest phase of a block after the scores;
//   GEMM 1: C = K1[l] + Q1[b], += bf16(k*q) W1d on mma.sync.m16n8k8 bf16
//           (D 18 -> 24, one product: 3 k steps x 10 n tiles at DIN width);
//   relu;   two n tiles of GEMM 1's C (16 hidden units) packed are GEMM
//           2's m16n8k16 A fragment as they lie (no permutation of W2), h1
//           split into hi = bf16(h1) and lo = bf16(h1 - hi), about 16 of
//           its bits;
//   GEMM 2: C2 = b2 + hi W2, C2' = lo W2 on mma.sync.m16n8k16 bf16 (5 k
//           steps x 5 n tiles x 2), added once the sum is complete;
// 80 mma a 16-key tile at DIN width where the 3xTF32 pipeline issues 240.
// Layer 3, the online softmax, the fixed chunk order (so a row's bits do
// not depend on B) and the register tiles' limits are the fp32 kernel's.
// The split first layer uses k - q exactly (the TPU rounds it) and p is
// not rounded to bf16 before the pool (the online softmax never holds the
// normalised p): both within the reference's bf16 tolerance of 2e-2.
// A build with -DDIN_ATTENTION_BF16_TF32 runs the bf16 entry through the
// fp32 pipeline instead (values widened as staged), with the products
// that are exact zeros in bf16 left out (GEMM 1 keeps hi*hi, GEMM 2 hi*hi
// and lo(h1)*hi(W2)): bit for bit the widened run it replaced, timed
// beside the tensor-core instance by chip_smoke.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;             // query rows per block (one warp each)
constexpr int kM = 16;               // keys per mma tile
constexpr int kChunk = 7 * kM;       // keys a block stages at once, at most
constexpr int kKT1Max = 8;           // D <= 64
constexpr int kNT1Max = 16;          // h1 <= 128
constexpr int kNT2Max = 8;           // h2 <= 64
constexpr int kMaxSmem = 232448;     // a Hopper block's dynamic shared memory
#ifdef DIN_ATTENTION_GUARDED_ONLY
constexpr bool kUnguarded = false;
#else
constexpr bool kUnguarded = true;
#endif
constexpr float kNegInf = -1e30f;    // the reference's mask constant
constexpr unsigned kFull = 0xffffffffu;

struct Layout {
  int dk, ks, kt1, h1p, nt1, h2p, nt2, hs, chunk, cs;
  // offsets in floats: B fragments of W1d and W2, K1, Q1, keys, queries,
  // the folded key / query blocks of W1, b1, b2, w3, scores, the mask
  int fb1, fb2, k1, q1, k, q, wk, wq, b1, b2, w3, s, m, total;
};

// a row stride (a multiple of 8 floats) at which the 8 rows g = 0..7 of a
// fragment's float2 reads fall on distinct banks
__host__ __device__ inline int bank_stride(int n) {
  return (n % 32 == 8 || n % 32 == 24) ? n : n + 8;
}

// the layout with chunks of `chunk` keys: the buffers of a chunk hold
// cs = min(L, chunk) keys
__host__ __device__ inline Layout layout_at(int L, int D, int h1, int h2,
                                            int chunk) {
  Layout o;
  o.dk = (D + 7) / 8 * 8;
  o.ks = o.dk + 4;                   // A reads at rows g, columns t: no conflict
  o.kt1 = o.dk / 8;
  o.h1p = (h1 + 7) / 8 * 8;
  o.nt1 = o.h1p / 8;
  o.h2p = (h2 + 7) / 8 * 8;
  o.nt2 = o.h2p / 8;
  o.hs = bank_stride(o.h1p);
  o.chunk = chunk;
  o.cs = L < chunk ? L : chunk;
  o.fb1 = 0;
  o.fb2 = o.fb1 + o.kt1 * o.nt1 * 128;
  o.k1 = o.fb2 + o.nt1 * o.nt2 * 128;
  o.q1 = o.k1 + o.cs * o.hs;
  o.k = o.q1 + kRows * o.hs;
  o.q = o.k + o.cs * o.ks;
  o.wk = o.q + kRows * o.ks;
  o.wq = o.wk + D * o.h1p;
  o.b1 = o.wq + D * o.h1p;
  o.b2 = o.b1 + o.h1p;
  o.w3 = o.b2 + o.h2p;
  o.s = o.w3 + o.h2p;
  o.m = o.s + kRows * o.cs;
  o.total = o.m + o.cs;
  return o;
}

// the bf16 tensor-core instance's layout: keys and queries in bf16 at a
// row stride ks whose 32-bit words make rows g = 0..7 of an A read fall on
// distinct banks ((ks / 2) % 8 == 4), h1 padded to 16 (GEMM 2's k step),
// the k8 B fragments of W1's four blocks (W1a, W1b, W1c, W1d: a 32-bit
// word a lane each), W2's k16 fragments (two words); offsets in bytes,
// each a multiple of 16
struct LayoutH {
  int dk, ks, kt1, h1p, nt1, kt2, h2p, nt2, hs, chunk, cs;
  int fb1, fb2, k1, q1, k, q, b1, b2, w3, s, m, total;
};

__host__ __device__ inline int up16(int n) { return (n + 15) & ~15; }

__host__ __device__ inline LayoutH layout_h_at(int L, int D, int h1, int h2,
                                               int chunk) {
  LayoutH o;
  o.dk = (D + 7) / 8 * 8;
  o.ks = (o.dk / 2) % 8 == 4 ? o.dk : o.dk + 8;
  o.kt1 = o.dk / 8;
  o.h1p = (h1 + 15) / 16 * 16;
  o.nt1 = o.h1p / 8;
  o.kt2 = o.h1p / 16;
  o.h2p = (h2 + 7) / 8 * 8;
  o.nt2 = o.h2p / 8;
  o.hs = bank_stride(o.h1p);
  o.chunk = chunk;
  o.cs = L < chunk ? L : chunk;
  o.fb1 = 0;
  o.fb2 = o.fb1 + 4 * o.kt1 * o.nt1 * 32 * 4;
  o.k1 = o.fb2 + o.kt2 * o.nt2 * 32 * 8;
  o.q1 = o.k1 + o.cs * o.hs * 4;
  o.k = o.q1 + kRows * o.hs * 4;
  o.q = o.k + up16(o.cs * o.ks * 2);
  o.b1 = o.q + up16(kRows * o.ks * 2);
  o.b2 = o.b1 + o.h1p * 4;
  o.w3 = o.b2 + o.h2p * 4;
  o.s = o.w3 + o.h2p * 4;
  o.m = o.s + kRows * o.cs * 4;
  o.total = o.m + o.cs * 4;
  return o;
}

// bytes of shared memory of a layout
__host__ __device__ inline size_t bytes_of(const Layout& o) {
  return (size_t)o.total * sizeof(float);
}
__host__ __device__ inline size_t bytes_of(const LayoutH& o) {
  return (size_t)o.total;
}

// the layout with the largest chunk (a multiple of kM keys, at most
// kChunk) that fits a block: it depends on the widths only, never on B.
// Within the register tiles a chunk of kM keys always fits (fp32 at D =
// 64, h1 = 128, h2 = 64: 32 keys, 231 KB; bf16 there: 112 keys).
Layout layout_f(int L, int D, int h1, int h2) {
  Layout o = layout_at(L, D, h1, h2, kChunk);
  for (int c = kChunk - kM; c >= kM && bytes_of(o) > (size_t)kMaxSmem;
       c -= kM)
    o = layout_at(L, D, h1, h2, c);
  return o;
}

LayoutH layout_h(int L, int D, int h1, int h2) {
  LayoutH o = layout_h_at(L, D, h1, h2, kChunk);
  for (int c = kChunk - kM; c >= kM && bytes_of(o) > (size_t)kMaxSmem;
       c -= kM)
    o = layout_h_at(L, D, h1, h2, c);
  return o;
}

// loads widened to fp32; an int index (within a key block or a weight)
__device__ __forceinline__ float ld(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}
// a staged key or query value as fp32
__device__ __forceinline__ float wide(float v) { return v; }
__device__ __forceinline__ float wide(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// element i of src as the staged type (fp32 widens, bf16 copies)
template <typename T>
__device__ __forceinline__ void stage_elem(float* dst, const T* src, int i) {
  *dst = ld(src, i);
}
__device__ __forceinline__ void stage_elem(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int i) {
  *dst = src[i];
}
template <typename K>
__device__ __forceinline__ K zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// hi = tf32(v), lo = tf32(v - hi)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// C (16 x 8, f32) += A (16 x 8, tf32) * B (8 x 8, tf32)
__device__ __forceinline__ void mma(float* c, const uint32_t* a, float b0,
                                    float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// C (16 x 8, f32) += A (16 x 8, bf16) * B (8 x 8, bf16)
__device__ __forceinline__ void mma_k8(float* c, const uint32_t* a,
                                       uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// C (16 x 8, f32) += A (16 x 16, bf16) * B (16 x 8, bf16)
__device__ __forceinline__ void mma_k16(float* c, const uint32_t* a,
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two values rounded to bf16 as one mma register (the first in the low
// 16 bits), and two bf16 as one
__device__ __forceinline__ uint32_t pack_rn(float v0, float v1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack(__nv_bfloat16 v0,
                                         __nv_bfloat16 v1) {
  return (uint32_t)__bfloat16_as_ushort(v0) |
         ((uint32_t)__bfloat16_as_ushort(v1) << 16);
}

// hi = bf16(v), lo = bf16(v - hi) of two values, packed
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hv = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_rn(v0 - hv.x, v1 - hv.y);
}

__device__ __forceinline__ float4 split4(float v0, float v1) {
  uint32_t h0, l0, h1, l1;
  split(v0, h0, l0);
  split(v1, h1, l1);
  return make_float4(__uint_as_float(h0), __uint_as_float(h1),
                     __uint_as_float(l0), __uint_as_float(l1));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// ---- the parts both pipelines share (K: the staged key type) ---------------

// keys c0 .. c0 + nl - 1 into rows of ks, zero past D
template <typename K, typename T>
__device__ __forceinline__ void stage_keys(K* sK, const T* keys, int c0,
                                           int nl, int D, int dk, int ks) {
#pragma unroll 4
  for (int i = threadIdx.x; i < nl * dk; i += kThreads) {
    const int l = i / dk, d = i - l * dk;
    if (d < D)
      stage_elem(sK + l * ks + d, keys, (c0 + l) * D + d);
    else
      sK[l * ks + d] = zero_of<K>();
  }
}

// the block's query rows (zero past B and past D) and the biases (fp32)
template <typename K, typename T>
__device__ __forceinline__ void stage_rows_and_biases(
    K* sQ, float* sb1, float* sb2, float* sw3, const T* q, const T* b1,
    const T* b2, const T* w3, int row0, int nrows, int D, int dk, int ks,
    int h1, int h1p, int h2, int h2p) {
  const int tid = threadIdx.x;
#pragma unroll 4
  for (int i = tid; i < kRows * dk; i += kThreads) {
    const int r = i / dk, d = i - r * dk;
    if (r < nrows && d < D)
      stage_elem(sQ + r * ks + d, q + (size_t)(row0 + r) * D, d);
    else
      sQ[r * ks + d] = zero_of<K>();
  }
  for (int i = tid; i < h1p; i += kThreads) sb1[i] = i < h1 ? ld(b1, i) : 0.f;
  for (int i = tid; i < h2p; i += kThreads) {
    sb2[i] = i < h2 ? ld(b2, i) : 0.f;
    sw3[i] = i < h2 ? ld(w3, i) : 0.f;
  }
}

// the folded W1 blocks W1a + W1c and W1b - W1c in fp32
template <typename T>
__device__ __forceinline__ void stage_folded_w1(float* sWk, float* sWq,
                                                const T* w1, int D, int h1,
                                                int h1p) {
  const int tid = threadIdx.x;
#pragma unroll 4
  for (int i = tid; i < D * h1p; i += kThreads) {
    const int d = i / h1p, c = i - d * h1p;
    float a = 0.f, b = 0.f;
    if (c < h1) {
      const float wc = ld(w1, (2 * D + d) * h1 + c);
      a = ld(w1, d * h1 + c) + wc;          // W1a + W1c
      b = ld(w1, (D + d) * h1 + c) - wc;    // W1b - W1c
    }
    sWk[i] = a;
    sWq[i] = b;
  }
}

// K1 = k (W1a + W1c) + b1 of the chunk's nl keys and, with the first chunk,
// Q1 = q (W1b - W1c) of the rows, on the CUDA cores: a thread owns 4 rows
// x 4 columns (keys in groups of 4, then the 8 query rows), each sum over
// d = 0..D-1 in order
__device__ __forceinline__ void fold_first_layer(
    const float* sK, const float* sQ, const float* sWk, const float* sWq,
    const float* sb1, float* sK1, float* sQ1, int ks, int hs, int h1p, int D,
    int nl, bool first) {
  const int cgroups = h1p / 4;
  const int kgroups = (nl + 3) / 4, qgroups = first ? kRows / 4 : 0;
  for (int i = threadIdx.x; i < (kgroups + qgroups) * cgroups;
       i += kThreads) {
    const int rg = i / cgroups, c = (i - rg * cgroups) * 4;
    const bool is_key = rg < kgroups;
    const float* xs = is_key ? sK : sQ;
    const float* ws = (is_key ? sWk : sWq) + c;
    int rows[4];
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = is_key ? rg * 4 + a : (rg - kgroups) * 4 + a;
      rows[a] = is_key ? min(r, nl - 1) : r;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][e] = is_key ? sb1[c + e] : 0.f;
    }
#pragma unroll 6
    for (int d = 0; d < D; ++d) {
      const float4 w = *reinterpret_cast<const float4*>(ws + d * h1p);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float xv = xs[rows[a] * ks + d];
        acc[a][0] = fmaf(xv, w.x, acc[a][0]);
        acc[a][1] = fmaf(xv, w.y, acc[a][1]);
        acc[a][2] = fmaf(xv, w.z, acc[a][2]);
        acc[a][3] = fmaf(xv, w.w, acc[a][3]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = is_key ? rg * 4 + a : (rg - kgroups) * 4 + a;
      if (is_key && r >= nl) continue;
      *reinterpret_cast<float4*>((is_key ? sK1 : sQ1) + r * hs + c) =
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    }
  }
}

// the row warp's online softmax over a chunk's nl scores in srow: mask,
// the chunk's max, rescale what was summed, then the chunk's exp(score -
// m) and their pooled keys (columns d0 and d1, lane and lane + 32), l in
// order
template <typename K>
__device__ __forceinline__ void softmax_chunk(float* srow, const int* sM,
                                              const K* sK, int ks, int nl,
                                              int D, int d0, int d1,
                                              bool first, float& m_run,
                                              float& s_run, float& acc0,
                                              float& acc1) {
  const int lane = threadIdx.x & 31;
  float mc = -INFINITY;
  for (int l = lane; l < nl; l += 32) {
    const float v = sM[l] != 0 ? srow[l] : kNegInf;
    srow[l] = v;
    mc = fmaxf(mc, v);
  }
  const float m_new = fmaxf(m_run, warp_max(mc));
  float sc = 0.f;
  for (int l = lane; l < nl; l += 32) {
    const float e = expf(srow[l] - m_new);
    srow[l] = e;
    sc += e;
  }
  sc = warp_sum(sc);
  __syncwarp();
  // columns 32..63 only where D > 32 (a warp-uniform branch)
  float o0 = 0.f, o1 = 0.f;
  if (D <= 32) {
#pragma unroll 10
    for (int l = 0; l < nl; ++l) o0 = fmaf(srow[l], wide(sK[l * ks + d0]), o0);
  } else {
#pragma unroll 4
    for (int l = 0; l < nl; ++l) {
      const float e = srow[l];
      o0 = fmaf(e, wide(sK[l * ks + d0]), o0);
      o1 = fmaf(e, wide(sK[l * ks + d1]), o1);
    }
  }
  if (first) {                     // nothing summed yet to rescale
    s_run = sc;
    acc0 = o0;
    acc1 = o1;
  } else {
    const float scale = expf(m_run - m_new);
    s_run = s_run * scale + sc;
    acc0 = fmaf(acc0, scale, o0);
    acc1 = fmaf(acc1, scale, o1);
  }
  m_run = m_new;
}

// layer 3 of one m16 tile, relu(C2 + C2') w3 + b3 with the four lanes of a
// row in a fixed tree, and the two scores this lane's row group owns
template <int NT2>
__device__ __forceinline__ void layer3(const float (&c2)[NT2][4],
                                       const float (&c2s)[NT2][4], int nt2,
                                       const float* w3, float* s, int cs,
                                       int r, int l0, int nl, float bias3) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int j = 0; j < NT2; ++j) {
    if (j < nt2) {
      const float2 wv = *reinterpret_cast<const float2*>(w3 + j * 8 + 2 * t);
      sa = fmaf(fmaxf(c2[j][0] + c2s[j][0], 0.f), wv.x, sa);
      sa = fmaf(fmaxf(c2[j][1] + c2s[j][1], 0.f), wv.y, sa);
      sb = fmaf(fmaxf(c2[j][2] + c2s[j][2], 0.f), wv.x, sb);
      sb = fmaf(fmaxf(c2[j][3] + c2s[j][3], 0.f), wv.y, sb);
    }
  }
  sa += __shfl_xor_sync(kFull, sa, 1);
  sb += __shfl_xor_sync(kFull, sb, 1);
  sa += __shfl_xor_sync(kFull, sa, 2);
  sb += __shfl_xor_sync(kFull, sb, 2);
  if (t == 0) {
    if (l0 + g < nl) s[r * cs + l0 + g] = sa + bias3;
    if (l0 + g + 8 < nl) s[r * cs + l0 + g + 8] = sb + bias3;
  }
}

// C2 = b2 (this lane's columns), C2' = 0
template <int NT2>
__device__ __forceinline__ void init_c2(float (&c2)[NT2][4],
                                        float (&c2s)[NT2][4], int nt2,
                                        const float* b2v) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT2; ++j) {
    if (j < nt2) {
      const float2 bv = *reinterpret_cast<const float2*>(b2v + j * 8 + 2 * t);
      c2[j][0] = c2[j][2] = bv.x;
      c2[j][1] = c2[j][3] = bv.y;
#pragma unroll
      for (int e = 0; e < 4; ++e) c2s[j][e] = 0.f;
    }
  }
}

// ---- the fp32 pipeline (3xTF32), and the bf16 entry widened into it ----------

struct Smem {
  const float4 *b1, *b2;                 // B fragments of W1d, W2
  const float *k1, *q1, *k, *q, *b2v, *w3;
  float* s;                              // the chunk's scores (kRows x cs)
};

// k * q as GEMM 1's A operand: in bf16 (BF16) rounded to bf16, as the TPU
// kernel forms it
template <bool BF16>
__device__ __forceinline__ float kq(float k, float q) {
  const float v = k * q;
  return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// The scores of one m16 tile: query row r against the chunk's keys l0 ..
// l0 + 15 (rows past the chunk's nl keys clamped, never stored). GEMM 1
// runs one n tile (8 hidden units) at a time and hands it, relu'd, to
// GEMM 2 as its k step. The 3xTF32 terms go to separate accumulators
// (hi*hi beside lo*hi and hi*lo), added in a fixed order once a sum is
// complete. BF16 (values widened from bf16): the lo halves of bf16(k*q),
// W1d and W2 are 0, so GEMM 1 keeps hi*hi and GEMM 2 hi*hi and lo*hi
// (adding an exact 0 changed nothing). EXACT: the widths equal the
// register tiles, so no guard splits the unrolled code.
template <int KT1, int NT1, int NT2, bool EXACT, bool BF16>
__device__ __forceinline__ void score_tile(const Smem& sm, const Layout& lo,
                                           int r, int l0, int nl,
                                           float bias3) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ks = lo.ks, hs = lo.hs;
  const int kt1 = EXACT ? KT1 : lo.kt1, nt1 = EXACT ? NT1 : lo.nt1,
            nt2 = EXACT ? NT2 : lo.nt2;
  const int la = min(l0 + g, nl - 1), lb = min(l0 + g + 8, nl - 1);
  uint32_t ah[KT1][4], al[KT1][4];           // (k * q) as GEMM 1's A
#pragma unroll
  for (int kt = 0; kt < KT1; ++kt) {
    if (kt < kt1) {
      const int d0 = kt * 8 + t, d1 = d0 + 4;
      const float q0 = sm.q[r * ks + d0], q1 = sm.q[r * ks + d1];
      split(kq<BF16>(sm.k[la * ks + d0], q0), ah[kt][0], al[kt][0]);  // g,   t
      split(kq<BF16>(sm.k[lb * ks + d0], q0), ah[kt][1], al[kt][1]);  // g+8, t
      split(kq<BF16>(sm.k[la * ks + d1], q1), ah[kt][2], al[kt][2]);  // g,   t+4
      split(kq<BF16>(sm.k[lb * ks + d1], q1), ah[kt][3], al[kt][3]);  // g+8, t+4
    }
  }
  float c2[NT2][4], c2s[NT2][4];             // b2 + hi*hi; lo*hi + hi*lo
  init_c2<NT2>(c2, c2s, nt2, sm.b2v);
#pragma unroll
  for (int j = 0; j < NT1; ++j) {
    if (j < nt1) {
      // GEMM 1, hidden units 8j .. 8j + 7: K1[l] + Q1[b] + (k*q) W1d
      const int col = j * 8 + 2 * t;
      const float2 ka = *reinterpret_cast<const float2*>(sm.k1 + la * hs + col);
      const float2 kb = *reinterpret_cast<const float2*>(sm.k1 + lb * hs + col);
      const float2 qv = *reinterpret_cast<const float2*>(sm.q1 + r * hs + col);
      float c1[4] = {ka.x + qv.x, ka.y + qv.y, kb.x + qv.x, kb.y + qv.y};
      float c1a[4] = {0.f, 0.f, 0.f, 0.f}, c1b[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kt = 0; kt < KT1; ++kt) {
        if (kt < kt1) {
          const float4 b = sm.b1[(kt * nt1 + j) * 32 + lane];
          if (!BF16) {
            mma(c1a, al[kt], b.x, b.y);        // lo * hi
            mma(c1b, ah[kt], b.z, b.w);        // hi * lo
          }
          mma(c1, ah[kt], b.x, b.y);           // hi * hi
        }
      }
      // relu; C's fragment is GEMM 2's A fragment for k step j
      float h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) h[e] = fmaxf(c1[e] + (c1a[e] + c1b[e]), 0.f);
      uint32_t bh[4], bl[4];
      split(h[0], bh[0], bl[0]);               // row g,     col 2t
      split(h[2], bh[1], bl[1]);               // row g + 8, col 2t
      split(h[1], bh[2], bl[2]);               // row g,     col 2t + 1
      split(h[3], bh[3], bl[3]);               // row g + 8, col 2t + 1
#pragma unroll
      for (int j2 = 0; j2 < NT2; ++j2) {
        if (j2 < nt2) {
          const float4 b = sm.b2[(j * nt2 + j2) * 32 + lane];
          mma(c2s[j2], bl, b.x, b.y);          // lo * hi
          if (!BF16) mma(c2s[j2], bh, b.z, b.w);   // hi * lo
          mma(c2[j2], bh, b.x, b.y);           // hi * hi
        }
      }
    }
  }
  layer3<NT2>(c2, c2s, nt2, sm.w3, sm.s, lo.cs, r, l0, nl, bias3);
}

template <typename T, int KT1, int NT1, int NT2, bool EXACT>
__global__ void __launch_bounds__(kThreads, KT1 <= 3 ? 2 : 1)
    din_attention_kernel(const T* __restrict__ q, const T* __restrict__ keys,
                         const int* __restrict__ mask,
                         const T* __restrict__ w1, const T* __restrict__ b1,
                         const T* __restrict__ w2, const T* __restrict__ b2,
                         const T* __restrict__ w3, const T* __restrict__ b3,
                         T* __restrict__ out, int B, int L, int D, int h1,
                         int h2, int chunk) {
  const Layout lo = layout_at(L, D, h1, h2, chunk);
  constexpr bool kBF16 = sizeof(T) == 2;
  extern __shared__ __align__(16) float smem[];
  float4* sB1 = reinterpret_cast<float4*>(smem + lo.fb1);
  float4* sB2 = reinterpret_cast<float4*>(smem + lo.fb2);
  float* sK1 = smem + lo.k1;
  float* sQ1 = smem + lo.q1;
  float* sK = smem + lo.k;
  float* sQ = smem + lo.q;
  float* sWk = smem + lo.wk;
  float* sWq = smem + lo.wq;
  float* sb1 = smem + lo.b1;
  float* sb2 = smem + lo.b2;
  float* sw3 = smem + lo.w3;
  float* sS = smem + lo.s;
  int* sM = reinterpret_cast<int*>(smem + lo.m);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, B - row0);
  const int dk = lo.dk, ks = lo.ks, hs = lo.hs, h1p = lo.h1p;
  const int nt1 = lo.nt1, nt2 = lo.nt2;

  // ---- stage the first chunk's keys and mask, the queries, the folded W1
  // blocks and the B fragments, widened to fp32; one wait for all ---------
  const int nl0 = min(lo.chunk, L);
  stage_keys(sK, keys, 0, nl0, D, dk, ks);
  for (int i = tid; i < nl0; i += kThreads) sM[i] = mask[i];
  stage_rows_and_biases(sQ, sb1, sb2, sw3, q, b1, b2, w3, row0, nrows, D,
                        dk, ks, h1, h1p, h2, lo.h2p);
  stage_folded_w1(sWk, sWq, w1, D, h1, h1p);
  // W1d: b0 = W1d[8 kt + t][8 j + g], b1 = W1d[8 kt + t + 4][8 j + g]
#pragma unroll 4
  for (int i = tid; i < lo.kt1 * nt1 * 32; i += kThreads) {
    const int lane = i & 31, j = (i >> 5) % nt1, kt = (i >> 5) / nt1;
    const int d0 = kt * 8 + (lane & 3), d1 = d0 + 4, n = j * 8 + (lane >> 2);
    const T* wd = w1 + (size_t)3 * D * h1;
    sB1[i] = split4(d0 < D && n < h1 ? ld(wd, d0 * h1 + n) : 0.f,
                    d1 < D && n < h1 ? ld(wd, d1 * h1 + n) : 0.f);
  }
  // W2, rows permuted to GEMM 1's C layout: b0 = W2[8 kt + 2t][8 j + g],
  // b1 = W2[8 kt + 2t + 1][8 j + g]
#pragma unroll 4
  for (int i = tid; i < nt1 * nt2 * 32; i += kThreads) {
    const int lane = i & 31, j = (i >> 5) % nt2, kt = (i >> 5) / nt2;
    const int r0 = kt * 8 + 2 * (lane & 3), r1 = r0 + 1;
    const int n = j * 8 + (lane >> 2);
    sB2[i] = split4(r0 < h1 && n < h2 ? ld(w2, r0 * h2 + n) : 0.f,
                    r1 < h1 && n < h2 ? ld(w2, r1 * h2 + n) : 0.f);
  }

  // ---- by chunks of lo.chunk keys: stage the chunk (past the first), K1 =
  // k (W1a + W1c) + b1 of its keys (with the first chunk, Q1 = q (W1b -
  // W1c) of the rows), its scores, then each row's online softmax ---------
  const Smem sm{sB1, sB2, sK1, sQ1, sK, sQ, sb2, sw3, sS};
  const float bias3 = ld(b3, 0);
  const int warp = tid >> 5, lane = tid & 31;
  // the row warp's running max, sum and pooled columns lane, lane + 32
  float m_run = -INFINITY, s_run = 0.f, acc0 = 0.f, acc1 = 0.f;
  const int d0 = lane < D ? lane : 0, d1 = lane + 32 < D ? lane + 32 : 0;
  for (int c0 = 0; c0 < L; c0 += lo.chunk) {
    const int nl = min(lo.chunk, L - c0);
    if (c0 > 0) {                      // the chunk's keys and mask
      stage_keys(sK, keys, c0, nl, D, dk, ks);
      for (int i = tid; i < nl; i += kThreads) sM[i] = mask[c0 + i];
    }
    __syncthreads();                   // (the first chunk: all staged)
    fold_first_layer(sK, sQ, sWk, sWq, sb1, sK1, sQ1, ks, hs, h1p, D, nl,
                     c0 == 0);
    __syncthreads();

    // scores: warp w takes tiles w, w + 8, ... (tile = one row against 16
    // consecutive keys of the chunk)
    const int ltiles = (nl + kM - 1) / kM;
    for (int ti = warp; ti < nrows * ltiles; ti += kWarps) {
      const int r = ti / ltiles;
      score_tile<KT1, NT1, NT2, EXACT, kBF16>(sm, lo, r,
                                              (ti - r * ltiles) * kM, nl,
                                              bias3);
    }
    __syncthreads();

    if (warp < nrows)
      softmax_chunk(sS + warp * lo.cs, sM, sK, ks, nl, D, d0, d1, c0 == 0,
                    m_run, s_run, acc0, acc1);
    if (c0 + lo.chunk < L) __syncthreads();   // the chunk's buffers are free
  }

  if (warp < nrows) {
    T* orow = out + (size_t)(row0 + warp) * D;
    if (lane < D) st(orow, lane, acc0 / s_run);
    if (lane + 32 < D) st(orow, lane + 32, acc1 / s_run);
  }
}

// ---- the bf16 tensor-core pipeline ----------------------------------------

struct SmemH {
  const uint32_t* w1;                    // k8 B fragments of W1a .. W1d
  const uint32_t* b1;                    // ... of W1d (the fourth block)
  const uint2* b2;                       // k16 B fragments of W2
  const float *k1, *q1;
  const __nv_bfloat16 *k, *q;
  const float *b1v, *b2v, *w3;
  float* s;                              // the chunk's scores (kRows x cs)
};

// K1 = b1 + k W1a + k W1c of the chunk's nl keys and, with the first
// chunk, Q1 = q W1b - q W1c of the block's rows, on the bf16 tensor cores
// (exact bf16 products, f32 sums; -q is exact): a warp a task, the keys'
// m16 tiles then the rows' (rows 8..15 zero), every n tile of h1, each
// sum the W1a (W1b) k steps in order, then the W1c ones
template <int KT1, bool EXACT>
__device__ __forceinline__ void fold_first_layer_bf16(const SmemH& sm,
                                                      float* sK1, float* sQ1,
                                                      const LayoutH& lo,
                                                      int nl, bool first) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kt1 = EXACT ? KT1 : lo.kt1, nt1 = lo.nt1, ks = lo.ks,
            hs = lo.hs;
  const int per = lo.kt1 * nt1 * 32;         // words of one W1 block
  const int ktiles = (nl + kM - 1) / kM;
  for (int task = warp; task < ktiles + (first ? 1 : 0); task += kWarps) {
    const bool is_q = task == ktiles;
    const int ra = is_q ? g : min(task * kM + g, nl - 1),
              rb = min(task * kM + g + 8, nl - 1);
    uint32_t a[KT1][2], ac[KT1][2];          // A of the W1a / W1b and W1c steps
#pragma unroll
    for (int kt = 0; kt < KT1; ++kt) {
      if (kt < kt1) {
        const int d = kt * 8 + 2 * t;
        a[kt][0] = *reinterpret_cast<const uint32_t*>(
            (is_q ? sm.q : sm.k) + ra * ks + d);
        a[kt][1] = is_q ? 0u
                        : *reinterpret_cast<const uint32_t*>(sm.k + rb * ks +
                                                             d);
        ac[kt][0] = is_q ? a[kt][0] ^ 0x80008000u : a[kt][0];   // -q
        ac[kt][1] = a[kt][1];
      }
    }
    const uint32_t* fa = sm.w1 + (is_q ? per : 0);   // W1b for q, W1a for k
    const uint32_t* fc = sm.w1 + 2 * per;            // W1c
    for (int j = 0; j < nt1; ++j) {
      const int col = j * 8 + 2 * t;
      const float2 bv = is_q ? make_float2(0.f, 0.f)
                             : *reinterpret_cast<const float2*>(sm.b1v + col);
      float c[4] = {bv.x, bv.y, bv.x, bv.y};
#pragma unroll
      for (int kt = 0; kt < KT1; ++kt)
        if (kt < kt1) mma_k8(c, a[kt], fa[(kt * nt1 + j) * 32 + lane]);
#pragma unroll
      for (int kt = 0; kt < KT1; ++kt)
        if (kt < kt1) mma_k8(c, ac[kt], fc[(kt * nt1 + j) * 32 + lane]);
      if (is_q) {
        *reinterpret_cast<float2*>(sQ1 + g * hs + col) =
            make_float2(c[0], c[1]);
      } else {
        const int l = task * kM + g;
        if (l < nl)
          *reinterpret_cast<float2*>(sK1 + l * hs + col) =
              make_float2(c[0], c[1]);
        if (l + 8 < nl)
          *reinterpret_cast<float2*>(sK1 + (l + 8) * hs + col) =
              make_float2(c[2], c[3]);
      }
    }
  }
}

// The scores of one m16 tile on the bf16 tensor cores (see the note at
// the top): GEMM 1 two n tiles at a time, whose relu'd C fragments, split
// into bf16 hi and lo, are GEMM 2's A for one k16 step.
template <int KT1, int KT2, int NT2, bool EXACT>
__device__ __forceinline__ void score_tile_bf16(const SmemH& sm,
                                                const LayoutH& lo, int r,
                                                int l0, int nl,
                                                float bias3) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ks = lo.ks, hs = lo.hs, nt1 = lo.nt1;
  const int kt1 = EXACT ? KT1 : lo.kt1, kt2 = EXACT ? KT2 : lo.kt2,
            nt2 = EXACT ? NT2 : lo.nt2;
  const int la = min(l0 + g, nl - 1), lb = min(l0 + g + 8, nl - 1);
  uint32_t a1[KT1][2];                       // bf16(k * q): rows g, g + 8
#pragma unroll
  for (int kt = 0; kt < KT1; ++kt) {
    if (kt < kt1) {
      const int d = kt * 8 + 2 * t;          // columns d, d + 1
      const float2 qv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(sm.q + r * ks + d));
      const float2 ka = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(sm.k + la * ks + d));
      const float2 kb = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(sm.k + lb * ks + d));
      a1[kt][0] = pack_rn(ka.x * qv.x, ka.y * qv.y);
      a1[kt][1] = pack_rn(kb.x * qv.x, kb.y * qv.y);
    }
  }
  float c2[NT2][4], c2s[NT2][4];             // b2 + hi W2; lo W2
  init_c2<NT2>(c2, c2s, nt2, sm.b2v);
#pragma unroll
  for (int s = 0; s < KT2; ++s) {
    if (s < kt2) {
      // GEMM 1, hidden units 16s .. 16s + 15 (n tiles 2s, 2s + 1)
      float h[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 2 * s + u, col = j * 8 + 2 * t;
        const float2 ka =
            *reinterpret_cast<const float2*>(sm.k1 + la * hs + col);
        const float2 kb =
            *reinterpret_cast<const float2*>(sm.k1 + lb * hs + col);
        const float2 qv =
            *reinterpret_cast<const float2*>(sm.q1 + r * hs + col);
        float c1[4] = {ka.x + qv.x, ka.y + qv.y, kb.x + qv.x, kb.y + qv.y};
#pragma unroll
        for (int kt = 0; kt < KT1; ++kt)
          if (kt < kt1) mma_k8(c1, a1[kt], sm.b1[(kt * nt1 + j) * 32 + lane]);
#pragma unroll
        for (int e = 0; e < 4; ++e) h[u][e] = fmaxf(c1[e], 0.f);
      }
      // GEMM 2's A for k step s: (row g | g + 8) x (k 2t | 2t + 8)
      uint32_t ah[4], al[4];
      split_bf16(h[0][0], h[0][1], ah[0], al[0]);   // row g,     k 2t
      split_bf16(h[0][2], h[0][3], ah[1], al[1]);   // row g + 8, k 2t
      split_bf16(h[1][0], h[1][1], ah[2], al[2]);   // row g,     k 2t + 8
      split_bf16(h[1][2], h[1][3], ah[3], al[3]);   // row g + 8, k 2t + 8
#pragma unroll
      for (int j2 = 0; j2 < NT2; ++j2) {
        if (j2 < nt2) {
          const uint2 b = sm.b2[(s * nt2 + j2) * 32 + lane];
          mma_k16(c2s[j2], al, b.x, b.y);    // lo * W2
          mma_k16(c2[j2], ah, b.x, b.y);     // hi * W2
        }
      }
    }
  }
  layer3<NT2>(c2, c2s, nt2, sm.w3, sm.s, lo.cs, r, l0, nl, bias3);
}

template <int KT1, int KT2, int NT2, bool EXACT>
__global__ void __launch_bounds__(kThreads, KT1 <= 3 ? 2 : 1)
    din_attention_bf16_kernel(
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ keys, const int* __restrict__ mask,
        const __nv_bfloat16* __restrict__ w1,
        const __nv_bfloat16* __restrict__ b1,
        const __nv_bfloat16* __restrict__ w2,
        const __nv_bfloat16* __restrict__ b2,
        const __nv_bfloat16* __restrict__ w3,
        const __nv_bfloat16* __restrict__ b3, __nv_bfloat16* __restrict__ out,
        int B, int L, int D, int h1, int h2, int chunk) {
  const LayoutH lo = layout_h_at(L, D, h1, h2, chunk);
  extern __shared__ __align__(16) unsigned char smem_h[];
  uint32_t* sW1 = reinterpret_cast<uint32_t*>(smem_h + lo.fb1);
  uint2* sB2 = reinterpret_cast<uint2*>(smem_h + lo.fb2);
  float* sK1 = reinterpret_cast<float*>(smem_h + lo.k1);
  float* sQ1 = reinterpret_cast<float*>(smem_h + lo.q1);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_h + lo.k);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_h + lo.q);
  float* sb1 = reinterpret_cast<float*>(smem_h + lo.b1);
  float* sb2 = reinterpret_cast<float*>(smem_h + lo.b2);
  float* sw3 = reinterpret_cast<float*>(smem_h + lo.w3);
  float* sS = reinterpret_cast<float*>(smem_h + lo.s);
  int* sM = reinterpret_cast<int*>(smem_h + lo.m);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, B - row0);
  const int dk = lo.dk, ks = lo.ks, h1p = lo.h1p;
  const int nt1 = lo.nt1, nt2 = lo.nt2;
  const int per = lo.kt1 * nt1 * 32;
  const __nv_bfloat16 zero = zero_of<__nv_bfloat16>();

  // ---- stage the first chunk's keys and mask, the queries (bf16), the
  // biases (fp32) and the B fragments (bf16); one wait for all. Each
  // thread's loads of a fragment word are independent, so a loop step
  // keeps eight (W1) or four (W2) loads in flight ------------------------
  const int nl0 = min(lo.chunk, L);
  stage_keys(sK, keys, 0, nl0, D, dk, ks);
  for (int i = tid; i < nl0; i += kThreads) sM[i] = mask[i];
  stage_rows_and_biases(sQ, sb1, sb2, sw3, q, b1, b2, w3, row0, nrows, D,
                        dk, ks, h1, h1p, h2, lo.h2p);
  // W1's blocks (k8): word (blk, kt, j, lane) = (W[8 kt + 2t][8 j + g],
  // W[8 kt + 2t + 1][8 j + g]) of W = W1a, W1b, W1c, W1d
#pragma unroll 2
  for (int i = tid; i < per; i += kThreads) {
    const int lane = i & 31, j = (i >> 5) % nt1, kt = (i >> 5) / nt1;
    const int d0 = kt * 8 + 2 * (lane & 3), n = j * 8 + (lane >> 2);
    const bool in0 = n < h1 && d0 < D, in1 = n < h1 && d0 + 1 < D;
#pragma unroll
    for (int blk = 0; blk < 4; ++blk) {
      const __nv_bfloat16* wb = w1 + (size_t)blk * D * h1;
      sW1[blk * per + i] = pack(in0 ? wb[d0 * h1 + n] : zero,
                                in1 ? wb[(d0 + 1) * h1 + n] : zero);
    }
  }
  // W2 (k16): b0 = (W2[16 s + 2t][8 j + g], W2[16 s + 2t + 1][8 j + g]),
  // b1 the same 8 rows on
#pragma unroll 2
  for (int i = tid; i < lo.kt2 * nt2 * 32; i += kThreads) {
    const int lane = i & 31, j = (i >> 5) % nt2, s = (i >> 5) / nt2;
    const int r0 = 16 * s + 2 * (lane & 3), n = j * 8 + (lane >> 2);
    const bool in = n < h2;
    auto w = [&](int r) { return in && r < h1 ? w2[r * h2 + n] : zero; };
    sB2[i] = make_uint2(pack(w(r0), w(r0 + 1)), pack(w(r0 + 8), w(r0 + 9)));
  }

  const SmemH sm{sW1, sW1 + 3 * per, sB2, sK1, sQ1, sK, sQ, sb1, sb2, sw3,
                 sS};
  const float bias3 = ld(b3, 0);
  const int warp = tid >> 5, lane = tid & 31;
  float m_run = -INFINITY, s_run = 0.f, acc0 = 0.f, acc1 = 0.f;
  const int d0 = lane < D ? lane : 0, d1 = lane + 32 < D ? lane + 32 : 0;
  for (int c0 = 0; c0 < L; c0 += lo.chunk) {
    const int nl = min(lo.chunk, L - c0);
    if (c0 > 0) {
      stage_keys(sK, keys, c0, nl, D, dk, ks);
      for (int i = tid; i < nl; i += kThreads) sM[i] = mask[c0 + i];
    }
    __syncthreads();
    fold_first_layer_bf16<KT1, EXACT>(sm, sK1, sQ1, lo, nl, c0 == 0);
    __syncthreads();
    const int ltiles = (nl + kM - 1) / kM;
    for (int ti = warp; ti < nrows * ltiles; ti += kWarps) {
      const int r = ti / ltiles;
      score_tile_bf16<KT1, KT2, NT2, EXACT>(sm, lo, r,
                                            (ti - r * ltiles) * kM, nl,
                                            bias3);
    }
    __syncthreads();
    if (warp < nrows)
      softmax_chunk(sS + warp * lo.cs, sM, sK, ks, nl, D, d0, d1, c0 == 0,
                    m_run, s_run, acc0, acc1);
    if (c0 + lo.chunk < L) __syncthreads();
  }

  if (warp < nrows) {
    __nv_bfloat16* orow = out + (size_t)(row0 + warp) * D;
    if (lane < D) st(orow, lane, acc0 / s_run);
    if (lane + 32 < D) st(orow, lane + 32, acc1 / s_run);
  }
}

// ---- host side -------------------------------------------------------------

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    // two blocks an SM at DIN's width need the largest carveout
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename T, int KT1, int NT1, int NT2, bool EXACT>
int launch(const T* q, const T* keys, const int* mask, const T* w1,
           const T* b1, const T* w2, const T* b2, const T* w3, const T* b3,
           T* out, int B, int L, int D, int h1, int h2, const Layout& lo,
           cudaStream_t stream) {
  auto kernel = din_attention_kernel<T, KT1, NT1, NT2, EXACT>;
  const size_t smem = bytes_of(lo);
  if (const int e = prepare(kernel, smem)) return e;
  const int blocks = (B + kRows - 1) / kRows;
  kernel<<<blocks, kThreads, smem, stream>>>(q, keys, mask, w1, b1, w2, b2,
                                             w3, b3, out, B, L, D, h1, h2,
                                             lo.chunk);
  return (int)cudaGetLastError();
}

template <int KT1, int KT2, int NT2, bool EXACT>
int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* keys,
                const int* mask, const __nv_bfloat16* w1,
                const __nv_bfloat16* b1, const __nv_bfloat16* w2,
                const __nv_bfloat16* b2, const __nv_bfloat16* w3,
                const __nv_bfloat16* b3, __nv_bfloat16* out, int B, int L,
                int D, int h1, int h2, const LayoutH& lo,
                cudaStream_t stream) {
  auto kernel = din_attention_bf16_kernel<KT1, KT2, NT2, EXACT>;
  const size_t smem = bytes_of(lo);
  if (const int e = prepare(kernel, smem)) return e;
  const int blocks = (B + kRows - 1) / kRows;
  kernel<<<blocks, kThreads, smem, stream>>>(q, keys, mask, w1, b1, w2, b2,
                                             w3, b3, out, B, L, D, h1, h2,
                                             lo.chunk);
  return (int)cudaGetLastError();
}

bool within_tiles(int L, int D, int h1, int h2) {
  return L > 0 && D > 0 && h1 > 0 && h2 > 0 && D <= kKT1Max * 8 &&
         h1 <= kNT1Max * 8 && h2 <= kNT2Max * 8;
}

// the fp32 pipeline (and, built with DIN_ATTENTION_BF16_TF32, the bf16
// entry widened into it)
template <typename T>
int dispatch(const T* q, const T* keys, const int* mask, const T* w1,
             const T* b1, const T* w2, const T* b2, const T* w3, const T* b3,
             T* out, int B, int L, int D, int h1, int h2, void* stream) {
  if (B <= 0 || !within_tiles(L, D, h1, h2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lo = layout_f(L, D, h1, h2);
  // 3 k tiles of GEMM 1, 10 n tiles of GEMM 1 and 5 of GEMM 2 (D 17..24,
  // h1 73..80, h2 33..40): an unguarded instance with two blocks an SM;
  // a build with -DDIN_ATTENTION_GUARDED_ONLY leaves it out, only for
  // chip_smoke.py to time the guarded instance at these tile counts
  if (kUnguarded && lo.kt1 == 3 && lo.nt1 == 10 && lo.nt2 == 5)
    return launch<T, 3, 10, 5, true>(q, keys, mask, w1, b1, w2, b2, w3, b3,
                                     out, B, L, D, h1, h2, lo, s);
  return launch<T, kKT1Max, kNT1Max, kNT2Max, false>(
      q, keys, mask, w1, b1, w2, b2, w3, b3, out, B, L, D, h1, h2, lo, s);
}

// the bf16 tensor-core pipeline: an unguarded instance at DIN's width (3
// k8 steps of GEMM 1, 5 k16 steps and 5 n tiles of GEMM 2: D 17..24, h1
// 65..80, h2 33..40), a guarded one up to the register tiles
int dispatch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* keys,
                  const int* mask, const __nv_bfloat16* w1,
                  const __nv_bfloat16* b1, const __nv_bfloat16* w2,
                  const __nv_bfloat16* b2, const __nv_bfloat16* w3,
                  const __nv_bfloat16* b3, __nv_bfloat16* out, int B, int L,
                  int D, int h1, int h2, void* stream) {
  if (B <= 0 || !within_tiles(L, D, h1, h2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LayoutH lo = layout_h(L, D, h1, h2);
  if (kUnguarded && lo.kt1 == 3 && lo.kt2 == 5 && lo.nt2 == 5)
    return launch_bf16<3, 5, 5, true>(q, keys, mask, w1, b1, w2, b2, w3, b3,
                                      out, B, L, D, h1, h2, lo, s);
  return launch_bf16<kKT1Max, kNT1Max / 2, kNT2Max, false>(
      q, keys, mask, w1, b1, w2, b2, w3, b3, out, B, L, D, h1, h2, lo, s);
}

}  // namespace

extern "C" {

// Bytes of shared memory one block of the fp32 pipeline stages for a unit
// of these widths, or -1 when L, D, h1 or h2 is not positive or D, h1, h2
// exceed the register tiles (D <= 64, h1 <= 128, h2 <= 64). Within the
// tiles it never passes a block's 232,448 bytes, whatever L.
long din_attention_smem_bytes(int L, int D, int h1, int h2) {
  if (!within_tiles(L, D, h1, h2)) return -1;
  return (long)bytes_of(layout_f(L, D, h1, h2));
}

// Keys a block of the fp32 pipeline stages and scores at once for these
// widths (a multiple of 16, at most 112), or -1 where
// din_attention_smem_bytes is -1: kernels/din_attention/ops.py refuses
// such a unit.
int din_attention_chunk_keys(int D, int h1, int h2) {
  if (!within_tiles(1, D, h1, h2)) return -1;
  return layout_f(kChunk, D, h1, h2).chunk;
}

// The same two for the bf16 tensor-core pipeline.
long din_attention_bf16_smem_bytes(int L, int D, int h1, int h2) {
  if (!within_tiles(L, D, h1, h2)) return -1;
  return (long)bytes_of(layout_h(L, D, h1, h2));
}

int din_attention_bf16_chunk_keys(int D, int h1, int h2) {
  if (!within_tiles(1, D, h1, h2)) return -1;
  return layout_h(kChunk, D, h1, h2).chunk;
}

// The register tiles' widest unit, D, h1, h2, into widths[0..2] (the
// wrapper's message when it refuses a wider one). Returns 0.
int din_attention_max_widths(int* widths) {
  widths[0] = kKT1Max * 8;
  widths[1] = kNT1Max * 8;
  widths[2] = kNT2Max * 8;
  return 0;
}

// query (B, D), keys (L, D), w1 (4D, h1), b1 (h1), w2 (h1, h2), b2 (h2),
// w3 (h2, 1), b3 (1): contiguous, all fp32 (din_attention_f32) or all bf16
// (din_attention_bf16); mask (L) int32 (0 = masked); out (B, D) of the
// same type. The caller passes B > 0 and widths within the register tiles
// (else cudaErrorInvalidValue). Launches on `stream`, allocates nothing,
// does not synchronise. Returns cudaGetLastError() after the launch (0 =
// launched).
int din_attention_f32(const float* q, const float* keys, const int* mask,
                      const float* w1, const float* b1, const float* w2,
                      const float* b2, const float* w3, const float* b3,
                      float* out, int B, int L, int D, int h1, int h2,
                      void* stream) {
  return dispatch(q, keys, mask, w1, b1, w2, b2, w3, b3, out, B, L, D, h1,
                  h2, stream);
}

int din_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* keys,
                       const int* mask, const __nv_bfloat16* w1,
                       const __nv_bfloat16* b1, const __nv_bfloat16* w2,
                       const __nv_bfloat16* b2, const __nv_bfloat16* w3,
                       const __nv_bfloat16* b3, __nv_bfloat16* out, int B,
                       int L, int D, int h1, int h2, void* stream) {
#ifdef DIN_ATTENTION_BF16_TF32
  return dispatch(q, keys, mask, w1, b1, w2, b2, w3, b3, out, B, L, D, h1,
                  h2, stream);
#else
  return dispatch_bf16(q, keys, mask, w1, b1, w2, b2, w3, b3, out, B, L, D,
                       h1, h2, stream);
#endif
}

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
