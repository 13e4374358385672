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
// and a guarded one for D <= 64, h1 <= 128, h2 <= 64; a wider unit takes
// the wide route (below, din_attention_wide_f32 / _bf16).
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
//
// The wide route (din_attention_wide_f32 / _bf16): any unit past the
// register tiles (D > 64, h1 > 128 or h2 > 64; DIN's public code pools
// item and category embeddings of 64 each, D = 128, through an 80-40 MLP),
// fp32 (3xTF32) and bf16, on wgmma. At D = 128, h1 = 80, h2 = 40 (B =
// 2048, L = 100) its bound is the two per-pair products, 5.5 GFLOP: as
// 3xTF32 at 495 TFLOP/s 0.0334 ms, in bf16 at 989 TFLOP/s 0.0056 ms.
//   Weights prepared once (kernels/din_attention/ops.py,
//           prepare_din_weights, at load time): W1d^T and W2^T K-major as
//           wgmma reads B, in tiles of 128-byte rows with the 128-byte
//           swizzle (fp32 tf32 hi and lo, bf16 exact), W2's rows permuted
//           inside each 8 in fp32 so that GEMM 1's accumulator is GEMM
//           2's A fragment as it lies (the trick of the fp32 pipeline,
//           which holds for wgmma's per-warp layout too); h1 in groups of
//           n1 and h2 in slices of n2 (80 and 40 at DIN's width, else 64
//           and 64, zero padded). Nothing is split on a call.
//   din_wide_fold: K1 = b1 + k (W1a + W1c) of every key and Q1 = q (W1b -
//           W1c) of every row, a thread an output, each sum over d in
//           order (bf16: k W1a and k W1c two f32 terms a step), into the
//           workspace (din_attention_work_bytes).
//   din_wg_kernel: persistent blocks (one an SM) of two warpgroups, each
//           holding 4 query rows (one a warp); per chunk of keys a
//           warpgroup runs one m64 tile (its 4 rows x 16 keys: warp w's
//           16 pairs are its row against the tile's keys) after another:
//           GEMM 1, wgmma.m64n{n1}k8 tf32 x 3 (bf16: k16 x 1), A = k*q
//             formed and split in registers from the staged keys and row,
//             B = the W1d tile from shared memory, C1 from K1[l] + Q1[b];
//             fp32 sums each 32-deep k tile from zero on the tensor cores
//             (lo*hi, hi*lo, hi*hi) and adds it to C1 with fp32 adds, as
//             mari_matmul does; bf16 chains all of D onto C1;
//           relu(C1) is GEMM 2's A in registers (bf16: two n8 columns a
//             k16 step, split into bf16 hi and lo), B = the W2 tile, into
//             C2 from b2 (fp32 by 32-deep k tiles as above);
//           layer 3 per h2 slice on the CUDA cores, each lane's partial
//             sums carried across slices in order, a fixed shuffle tree;
//           each warp then folds its row's scores into the online softmax
//             and its pooled sums in shared memory (kWRows x D floats), as
//             above.
//           The weight tiles come from the prepared buffer by the copy
//           engine (cp.async.bulk on an mbarrier), issued by thread 0:
//           where a round's tiles fit beside the keys (DIN's width: 7
//           tiles, 140 KB fp32) they are staged once a block and stay;
//           else they stream through a ring that both warpgroups walk in
//           the same order, each slot refilled once both have let it go.
// Every sum's order is fixed by the widths, never by B, so a row's result
// depends on its query, the keys and the weights alone. Shared memory bounds
// the widths: 16 keys, the block's query rows and pooled sums and two
// weight tiles must fit a block (din_attention_max_dim); h1 and h2 are
// bounded by nothing but the prepared buffer.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

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

// ---- the wide route (see the note at the top) ------------------------------

constexpr int kWG = 2;                 // warpgroups a block, each one m64
constexpr int kWThreads = 128 * kWG;   // tile (4 query rows x 16 keys) at once
constexpr int kWRows = 4 * kWG;        // query rows a block holds (a warp one)
constexpr int kWMaxSlots = 32;         // ring slots at most

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\n"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
               :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}
// `bytes` (a multiple of 16) from global to shared memory by the copy
// engine, counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// wgmma shared-memory descriptor of a K-major tile of 128-byte rows with
// the 128-byte swizzle (tile base 1024-byte aligned): stride byte offset
// 1024 (eight rows); a 32-byte k step adds 2
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  uint64_t d = (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// keep the compiler from moving accesses of registers an in-flight wgmma
// reads or writes across the fence / commit / wait
template <int R>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// wgmma with A from registers (tf32: 64 x 8; bf16: 64 x 16), one instance
// per N
template <int N>
struct Wg;

template <>
struct Wg<40> {
  // D (64 x 40, f32) += A (64 x 8, tf32, registers) * B (40 x 8 in smem)
  static __device__ __forceinline__ void tf32(float* d, const uint32_t* a,
                                              uint64_t desc_b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
  // D (64 x 40, f32) += A (64 x 16, bf16, registers) * B (40 x 16 in smem)
  static __device__ __forceinline__ void bf16(float* d, const uint32_t* a,
                                              uint64_t desc_b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct Wg<64> {
  // D (64 x 64, f32) += A (64 x 8, tf32, registers) * B (64 x 8 in smem)
  static __device__ __forceinline__ void tf32(float* d, const uint32_t* a,
                                              uint64_t desc_b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
  // D (64 x 64, f32) += A (64 x 16, bf16, registers) * B (64 x 16 in smem)
  static __device__ __forceinline__ void bf16(float* d, const uint32_t* a,
                                              uint64_t desc_b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct Wg<80> {
  // D (64 x 80, f32) += A (64 x 8, tf32, registers) * B (80 x 8 in smem)
  static __device__ __forceinline__ void tf32(float* d, const uint32_t* a,
                                              uint64_t desc_b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
  // D (64 x 80, f32) += A (64 x 16, bf16, registers) * B (80 x 16 in smem)
  static __device__ __forceinline__ void bf16(float* d, const uint32_t* a,
                                              uint64_t desc_b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

// The prepared weights' tile plan (kernels/din_attention/ops.py's
// din_plan mirrors it): W1d^T and W2^T K-major, 128-byte rows of kk values
// with the 128-byte swizzle (16-byte chunk c of row n at c ^ (n % 8)),
// fp32 as tf32 hi then lo, bf16 as it is. h1 in groups of n1 (GEMM 1's N),
// h2 in slices of n2 (GEMM 2's N): DIN's 73..80 x 33..40 in one group of
// 80 and one slice of 40, any other width in groups and slices of 64 (zero
// padded). W1d tile (g, kt): rows c = g n1 .. (hidden units), k = d in kt
// kk ..; W2 tile (s, g, kt2): rows j = s n2 .., k = h1 index g n1 + kt2 kk
// + k, in fp32 permuted inside each 8 (k t <- 2t, k t + 4 <- 2t + 1: GEMM
// 1's accumulator as GEMM 2's A fragment). W1d tiles [g][kt] first, then
// W2 tiles [s][g][kt2]. An m64 tile walks per_round tiles: for each slice,
// for each group, its W1d tiles then its W2 tiles.
struct WidePlan {
  int n1, n2, ng, ns, kk, kt1, kt2, parts, per_round;
  long long t1, t2, w2_off, total;
};

__host__ __device__ inline bool din_widths(int h1, int h2) {
  return h1 > 72 && h1 <= 80 && h2 > 32 && h2 <= 40;
}

inline WidePlan wide_plan(int D, int h1, int h2, bool bf16) {
  WidePlan p;
  const bool din = din_widths(h1, h2);
  p.n1 = din ? 80 : 64;
  p.n2 = din ? 40 : 64;
  p.ng = (h1 + p.n1 - 1) / p.n1;
  p.ns = (h2 + p.n2 - 1) / p.n2;
  p.kk = bf16 ? 64 : 32;
  p.parts = bf16 ? 1 : 2;
  p.kt1 = ((D + p.kk - 1) / p.kk + 1) / 2 * 2;      // even: two a turn
  p.kt2 = (p.n1 + p.kk - 1) / p.kk;
  p.per_round = p.ns * p.ng * (p.kt1 + p.kt2);
  p.t1 = (long long)p.n1 * 128 * p.parts;
  p.t2 = (long long)p.n2 * 128 * p.parts;
  p.w2_off = p.t1 * p.ng * p.kt1;
  p.total = p.w2_off + p.t2 * p.ns * p.ng * p.kt2;
  return p;
}

// the wide block's shared memory, offsets in bytes from its 1024-aligned
// base: the weight tiles (slots of slot bytes: every tile of a round when
// resident, else a ring), keys, query rows, pooled sums (fp32, kWRows x
// dk), scores (fp32), mask; total adds 1024 for the alignment
struct WideLayout {
  int dk, ks, chunk, cs, slots, resident;
  long long slot, k, q, acc, s, m, total;
};

inline long long up16ll(long long n) { return (n + 15) & ~15LL; }

inline WideLayout wide_layout_at(const WidePlan& p, int L, int D, bool bf16,
                                 int chunk, int slots, bool resident) {
  WideLayout o;
  o.dk = bf16 ? (D + 15) / 16 * 16 : (D + 7) / 8 * 8;
  o.ks = bf16 ? ((o.dk / 2) % 8 == 4 ? o.dk : o.dk + 8) : o.dk + 4;
  o.chunk = chunk;
  o.cs = L < chunk ? L : chunk;
  o.slots = slots;
  o.resident = resident;
  o.slot = p.t1 > p.t2 ? p.t1 : p.t2;
  const int es = bf16 ? 2 : 4;
  o.k = slots * o.slot;
  o.q = o.k + up16ll((long long)o.cs * o.ks * es);
  o.acc = o.q + up16ll((long long)kWRows * o.ks * es);
  o.s = o.acc + (long long)kWRows * o.dk * 4;
  o.m = o.s + (long long)kWRows * o.cs * 4;
  o.total = o.m + (long long)o.cs * 4 + 1024;
  return o;
}

// the weights resident (a round's tiles staged once a block) where they
// fit beside a chunk of 16 keys or more, else a ring of 4 slots, else 2;
// each with the largest chunk (a multiple of kM, at most kChunk) that
// fits. A function of the widths and L alone; total > kMaxSmem where not
// even 16 keys and 2 slots fit.
inline WideLayout wide_layout(int L, int D, int h1, int h2, bool bf16) {
  const WidePlan p = wide_plan(D, h1, h2, bf16);
  const int tries[3][2] = {{p.per_round, 1}, {4, 0}, {2, 0}};
  for (const auto& tr : tries) {
    const int slots = tr[0];
    if (slots > kWMaxSlots || (!tr[1] && slots >= p.per_round)) continue;
    for (int c = kChunk; c >= kM; c -= kM) {
      const WideLayout o = wide_layout_at(p, L, D, bf16, c, slots, tr[1]);
      if (o.total <= kMaxSmem) return o;
    }
  }
  return wide_layout_at(p, L, D, bf16, kM, 2, false);
}

// the widest D whose 16-key chunk fits a block beside two slots of either
// instance's tiles
int wide_max_dim(bool bf16) {
  int lo = 1, hi = 1 << 16;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    bool fits = true;
    const int hs[2] = {1, 80};
    for (int h : hs) {
      const WidePlan p = wide_plan(mid, h, h / 2, bf16);
      fits = fits &&
             wide_layout_at(p, kM, mid, bf16, kM, 2, false).total <= kMaxSmem;
    }
    if (fits) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// the workspace, offsets in bytes: K1 (L x hq fp32) and Q1 (B x hq fp32),
// hq = ng n1 (zero past h1)
struct WideWork {
  long long k1, q1, total;
  int hq;
};

inline long long up256(long long n) { return (n + 255) & ~255LL; }

WideWork wide_work(const WidePlan& p, int B, int L) {
  WideWork w;
  w.hq = p.ng * p.n1;
  w.k1 = 0;
  w.q1 = up256((long long)L * w.hq * 4);
  w.total = w.q1 + up256((long long)B * w.hq * 4);
  return w;
}

// K1 = b1 + k (W1a + W1c) of every key and Q1 = q (W1b - W1c) of every row
// (rows past h1 zero, hq apart), a thread an output: its sum over d in
// order (fp32 on the folded blocks; bf16 k W1a and k W1c two f32 terms a
// step, exact products). Neighbouring threads take neighbouring columns,
// so the weights' reads are coalesced and a row's are broadcast.
constexpr int kFoldThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kFoldThreads)
    din_wide_fold(const T* __restrict__ q, const T* __restrict__ keys,
                  const T* __restrict__ w1, const T* __restrict__ b1,
                  float* __restrict__ K1, float* __restrict__ Q1, int B,
                  int L, int D, int h1, int hq) {
  constexpr bool kBF16 = sizeof(T) == 2;
  const long long n = (long long)(L + B) * hq;
  for (long long e = blockIdx.x * (long long)kFoldThreads + threadIdx.x;
       e < n; e += (long long)gridDim.x * kFoldThreads) {
    const int r = (int)(e / hq), c = (int)(e - (long long)r * hq);
    const bool is_key = r < L;
    const int row = is_key ? r : r - L;
    float acc = 0.f;
    if (c < h1) {
      const T* x = (is_key ? keys : q) + (size_t)row * D;
      const T* wa = w1 + (is_key ? 0 : (size_t)D * h1) + c;  // W1a or W1b
      const T* wc = w1 + (size_t)2 * D * h1 + c;             // W1c
      acc = is_key ? wide(b1[c]) : 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float xv = wide(x[d]);
        const float av = wide(wa[(size_t)d * h1]);
        const float cv = wide(wc[(size_t)d * h1]);
        if constexpr (kBF16) {
          acc = fmaf(xv, av, acc);
          acc = fmaf(xv, is_key ? cv : -cv, acc);
        } else {                        // the folded blocks
          acc = fmaf(xv, is_key ? av + cv : av - cv, acc);
        }
      }
    }
    (is_key ? K1 : Q1)[(size_t)row * hq + c] = acc;
  }
}

// the four lanes of a row add their partials in a fixed tree; the two
// scores this lane's row group owns
__device__ __forceinline__ void store_scores(float sa, float sb, float* srow,
                                             int l0, int nl, float bias3) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  sa += __shfl_xor_sync(kFull, sa, 1);
  sb += __shfl_xor_sync(kFull, sb, 1);
  sa += __shfl_xor_sync(kFull, sa, 2);
  sb += __shfl_xor_sync(kFull, sb, 2);
  if (t == 0) {
    if (l0 + g < nl) srow[l0 + g] = sa + bias3;
    if (l0 + g + 8 < nl) srow[l0 + g + 8] = sb + bias3;
  }
}

// C2 = b2 of slice s (each lane's columns, rows g and g + 8 alike)
template <int N2, typename T>
__device__ __forceinline__ void init_c2(float* c2, const T* b2, int s,
                                        int h2) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < N2 / 8; ++j) {
    const int col = s * N2 + 8 * j + 2 * t;
    c2[4 * j] = c2[4 * j + 2] = col < h2 ? wide(b2[col]) : 0.f;
    c2[4 * j + 1] = c2[4 * j + 3] = col + 1 < h2 ? wide(b2[col + 1]) : 0.f;
  }
}

// C1 of group gi = K1[l] + Q1[b] (accumulator register 4j + 2h + e: pair
// row g + 8h, column gi N1 + 8j + 2t + e)
template <int N1>
__device__ __forceinline__ void init_c1(float* c1, const float* k1a,
                                        const float* k1b, const float* q1,
                                        int gi) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < N1 / 8; ++j) {
    const int col = gi * N1 + 8 * j + 2 * t;
    const float2 va = __ldg(reinterpret_cast<const float2*>(k1a + col));
    const float2 vb = __ldg(reinterpret_cast<const float2*>(k1b + col));
    const float2 vq = __ldg(reinterpret_cast<const float2*>(q1 + col));
    c1[4 * j] = va.x + vq.x;
    c1[4 * j + 1] = va.y + vq.y;
    c1[4 * j + 2] = vb.x + vq.x;
    c1[4 * j + 3] = vb.y + vq.y;
  }
}

// layer 3 of slice s into this lane's partial sums of its pairs g (sa) and
// g + 8 (sb), the slices in order
template <int N2, typename T>
__device__ __forceinline__ void layer3(const float* c2, const T* w3, int s,
                                       int h2, float& sa, float& sb) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < N2 / 8; ++j) {
    const int col = s * N2 + 8 * j + 2 * t;
    const float wx = col < h2 ? wide(w3[col]) : 0.f;
    const float wy = col + 1 < h2 ? wide(w3[col + 1]) : 0.f;
    sa = fmaf(fmaxf(c2[4 * j], 0.f), wx, sa);
    sa = fmaf(fmaxf(c2[4 * j + 1], 0.f), wy, sa);
    sb = fmaf(fmaxf(c2[4 * j + 2], 0.f), wx, sb);
    sb = fmaf(fmaxf(c2[4 * j + 3], 0.f), wy, sb);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// the A fragment of GEMM 1's k tile kt in fp32: k step kk's k*q at (pair g,
// d), (g + 8, d), (g, d + 4), (g + 8, d + 4), d = 32 kt + 8 kk + t, split
// into tf32 hi / lo; zero past D (the tile's rows are zero there too, so
// every tile issues its 4 steps and no wgmma sits on a branch)
__device__ __forceinline__ void g1_frags(const float* ka, const float* kb,
                                         const float* sq, int kt, int ksteps,
                                         uint32_t (&ah)[4][4],
                                         uint32_t (&al)[4][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const bool on = kt * 4 + kk < ksteps;
    const int d0 = on ? kt * 32 + 8 * kk + t : 0, d1 = d0 + 4;
    const float z = on ? 1.f : 0.f;
    split(ka[d0] * sq[d0] * z, ah[kk][0], al[kk][0]);
    split(kb[d0] * sq[d0] * z, ah[kk][1], al[kk][1]);
    split(ka[d1] * sq[d1] * z, ah[kk][2], al[kk][2]);
    split(kb[d1] * sq[d1] * z, ah[kk][3], al[kk][3]);
  }
}

// a 32-deep k tile's three products (lo*hi, hi*lo, hi*hi a step, from
// zero) into part, `steps` k steps (a constant), one commit group
template <int N, int STEPS>
__device__ __forceinline__ void k_tile_3x(float* part,
                                          const uint32_t (&ah)[4][4],
                                          const uint32_t (&al)[4][4],
                                          const unsigned char* w) {
  const uint64_t dh = smem_desc(w), dl = smem_desc(w + N * 128);
  fence_regs<N / 2>(part);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
    Wg<N>::tf32(part, al[kk], dh + 2 * kk, kk > 0);        // lo * hi
    Wg<N>::tf32(part, ah[kk], dl + 2 * kk, 1);             // hi * lo
    Wg<N>::tf32(part, ah[kk], dh + 2 * kk, 1);             // hi * hi
  }
  wgmma_commit();
}

// GEMM 2's A fragment of its k tile KT from relu(C1) as it lies: k step
// kk = n tile j = 4 KT + kk of C1, (g, 2t) (g + 8, 2t) (g, 2t + 1) (g + 8,
// 2t + 1) against W2's rows permuted to match, split into hi / lo
template <int N1, int KT>
__device__ __forceinline__ void g2_frags(const float* acc1,
                                         uint32_t (&bh)[4][4],
                                         uint32_t (&bl)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int j = KT * 4 + kk;
    if (j < N1 / 8) {
      split(fmaxf(acc1[4 * j], 0.f), bh[kk][0], bl[kk][0]);
      split(fmaxf(acc1[4 * j + 2], 0.f), bh[kk][1], bl[kk][1]);
      split(fmaxf(acc1[4 * j + 1], 0.f), bh[kk][2], bl[kk][2]);
      split(fmaxf(acc1[4 * j + 3], 0.f), bh[kk][3], bl[kk][3]);
    }
  }
}

// k steps of GEMM 2's k tile KT (N1 / 8 in all, 4 a tile)
template <int N1, int KT>
constexpr int g2_steps = N1 / 8 - 4 * KT < 4 ? N1 / 8 - 4 * KT : 4;

// One m64 tile in fp32 (3xTF32): warp w's 16 pairs are its query row sq
// against keys l0 .. l0 + 15 of the chunk (pair row g: key l0 + g, g + 8:
// l0 + g + 8; keys past nl clamped, never stored). GEMM 1 per W1d tile:
// A = k*q formed and split in registers, B = the tile (hi, lo) from shared
// memory, a 32-deep k tile summed from zero on the tensor cores and added
// to C1 (from K1 + Q1) with fp32 adds; relu(C1) as it lies is GEMM 2's A
// (W2's rows permuted to match), summed the same way into C2 (from b2);
// layer 3 on the CUDA cores. The k tiles go two at a time into two partial
// sums: the second tile's fragment is formed while the first's products
// run, and the first is added while the second's run (wait_group 1), in
// the tiles' order. `tile()` waits for the next weight tile and gives its
// address, `done()` lets its slot go once the products that read it have
// retired.
template <int N1, int N2, typename Tile, typename Done>
__device__ __forceinline__ void score_tile(
    const float* sK, const float* sq, const float* K1c, const float* q1,
    const float* b2, const float* w3, float* srow, int l0, int nl, int h2,
    int ks, int hq, int ksteps, const WidePlan& p, float bias3, Tile tile,
    Done done) {
  constexpr int R1 = N1 / 2, R2 = N2 / 2;
  constexpr int KT2 = (N1 + 31) / 32;
  const int lane = threadIdx.x & 31, g = lane >> 2;
  const int la = min(l0 + g, nl - 1), lb = min(l0 + g + 8, nl - 1);
  const float* ka = sK + la * ks;
  const float* kb = sK + lb * ks;
  const float* k1a = K1c + (size_t)la * hq;
  const float* k1b = K1c + (size_t)lb * hq;
  float sa = 0.f, sb = 0.f;
  for (int s = 0; s < p.ns; ++s) {
    float acc2[R2];
    init_c2<N2>(acc2, b2, s, h2);
    for (int gi = 0; gi < p.ng; ++gi) {
      float acc1[R1], pa[R1], pb[R1];
      init_c1<N1>(acc1, k1a, k1b, q1, gi);
#pragma unroll
      for (int i = 0; i < R1; ++i) pa[i] = pb[i] = 0.f;
      for (int kt = 0; kt < p.kt1; kt += 2) {     // kt1 is even (the plan)
        uint32_t ah[4][4], al[4][4], bh[4][4], bl[4][4];
        g1_frags(ka, kb, sq, kt, ksteps, ah, al);
        k_tile_3x<N1, 4>(pa, ah, al, tile());
        g1_frags(ka, kb, sq, kt + 1, ksteps, bh, bl);
        k_tile_3x<N1, 4>(pb, bh, bl, tile());
        wgmma_wait_n<1>();
        fence_regs<R1>(pa);
        done();
#pragma unroll
        for (int i = 0; i < R1; ++i) acc1[i] += pa[i];
        wgmma_wait_n<0>();
        fence_regs<R1>(pb);
        done();
#pragma unroll
        for (int i = 0; i < R1; ++i) acc1[i] += pb[i];
      }
      float qa[R2], qb[R2];
#pragma unroll
      for (int i = 0; i < R2; ++i) qa[i] = qb[i] = 0.f;
      uint32_t ah[4][4], al[4][4], bh[4][4], bl[4][4];
      g2_frags<N1, 0>(acc1, ah, al);
      k_tile_3x<N2, g2_steps<N1, 0>>(qa, ah, al, tile());
      if constexpr (KT2 > 1) {
        g2_frags<N1, 1>(acc1, bh, bl);
        k_tile_3x<N2, g2_steps<N1, 1>>(qb, bh, bl, tile());
        wgmma_wait_n<1>();
        fence_regs<R2>(qa);
        done();
#pragma unroll
        for (int i = 0; i < R2; ++i) acc2[i] += qa[i];
      }
      if constexpr (KT2 > 2) {
        g2_frags<N1, 2>(acc1, ah, al);
        k_tile_3x<N2, g2_steps<N1, 2>>(qa, ah, al, tile());
        wgmma_wait_n<1>();
        fence_regs<R2>(qb);
        done();
#pragma unroll
        for (int i = 0; i < R2; ++i) acc2[i] += qb[i];
      }
      static_assert(KT2 <= 3, "GEMM 2 takes at most 3 k tiles a group");
      wgmma_wait_n<0>();
      float* last = KT2 == 2 ? qb : qa;
      fence_regs<R2>(last);
      done();
#pragma unroll
      for (int i = 0; i < R2; ++i) acc2[i] += last[i];
    }
    layer3<N2>(acc2, w3, s, h2, sa, sb);
  }
  store_scores(sa, sb, srow, l0, nl, bias3);
}

// The same in bf16 on the bf16 tensor cores: GEMM 1 k16 on bf16(k*q) into
// C1 = K1 + Q1 over all of D; GEMM 2 k16 on relu(C1) split into bf16 hi
// and lo (two n8 columns of C1 a k step, W2 unpermuted) into C2 = b2. The
// products chain on the accumulators, so the k tiles of a GEMM go in back
// to back (two at a time in GEMM 1) with one wait.
__device__ __forceinline__ float2 bf2(const __nv_bfloat16* v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(v));
}

// GEMM 1's A fragment of k tile kt in bf16: k16 step kk's bf16(k*q) at
// (g, 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..), d = 64 kt +
// 16 kk; zero past D
__device__ __forceinline__ void g1_frags(const __nv_bfloat16* ka,
                                         const __nv_bfloat16* kb,
                                         const __nv_bfloat16* sq, int kt,
                                         int ksteps, uint32_t (&a)[4][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const bool on = kt * 4 + kk < ksteps;
    const int d = on ? kt * 64 + 16 * kk + 2 * t : 0;
    const float z = on ? 1.f : 0.f;
    const float2 q0 = bf2(sq + d), q8 = bf2(sq + d + 8);
    const float2 a0 = bf2(ka + d), b0 = bf2(kb + d);
    const float2 a8 = bf2(ka + d + 8), b8 = bf2(kb + d + 8);
    a[kk][0] = pack_rn(a0.x * q0.x * z, a0.y * q0.y * z);
    a[kk][1] = pack_rn(b0.x * q0.x * z, b0.y * q0.y * z);
    a[kk][2] = pack_rn(a8.x * q8.x * z, a8.y * q8.y * z);
    a[kk][3] = pack_rn(b8.x * q8.x * z, b8.y * q8.y * z);
  }
}

template <int N, int STEPS>
__device__ __forceinline__ void k_tile_bf16(float* acc,
                                            const uint32_t (&a)[4][4],
                                            const unsigned char* w) {
  const uint64_t dw = smem_desc(w);
  fence_regs<N / 2>(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) Wg<N>::bf16(acc, a[kk], dw + 2 * kk, 1);
}

// GEMM 2's k tile KT in bf16: k16 step kk covers C1's n tiles 2p, 2p + 1
// (p = 4 KT + kk), relu, split into bf16 hi and lo; lo * W2 then hi * W2
template <int N1, int N2, int KT>
__device__ __forceinline__ void g2_tile_bf16(float* acc2, const float* acc1,
                                             uint32_t (&ah)[4][4],
                                             uint32_t (&al)[4][4],
                                             const unsigned char* w) {
  constexpr int P2 = N1 / 16;
  constexpr int STEPS = P2 - 4 * KT < 4 ? P2 - 4 * KT : 4;
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
    const int pp = KT * 4 + kk;
    float h[2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[0][e] = fmaxf(acc1[8 * pp + e], 0.f);
      h[1][e] = fmaxf(acc1[8 * pp + 4 + e], 0.f);
    }
    split_bf16(h[0][0], h[0][1], ah[kk][0], al[kk][0]);   // g,     k 2t
    split_bf16(h[0][2], h[0][3], ah[kk][1], al[kk][1]);   // g + 8, k 2t
    split_bf16(h[1][0], h[1][1], ah[kk][2], al[kk][2]);   // g,     2t + 8
    split_bf16(h[1][2], h[1][3], ah[kk][3], al[kk][3]);   // g + 8, 2t + 8
  }
  const uint64_t dw = smem_desc(w);
  fence_regs<N2 / 2>(acc2);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
    Wg<N2>::bf16(acc2, al[kk], dw + 2 * kk, 1);           // lo * W2
    Wg<N2>::bf16(acc2, ah[kk], dw + 2 * kk, 1);           // hi * W2
  }
}

template <int N1, int N2, typename Tile, typename Done>
__device__ __forceinline__ void score_tile(
    const __nv_bfloat16* sK, const __nv_bfloat16* sq, const float* K1c,
    const float* q1, const __nv_bfloat16* b2, const __nv_bfloat16* w3,
    float* srow, int l0, int nl, int h2, int ks, int hq, int ksteps,
    const WidePlan& p, float bias3, Tile tile, Done done) {
  constexpr int R1 = N1 / 2, R2 = N2 / 2;
  constexpr int KT2 = (N1 + 63) / 64;
  static_assert(KT2 <= 2, "GEMM 2 takes at most 2 k tiles a group in bf16");
  const int lane = threadIdx.x & 31, g = lane >> 2;
  const int la = min(l0 + g, nl - 1), lb = min(l0 + g + 8, nl - 1);
  const __nv_bfloat16* ka = sK + la * ks;
  const __nv_bfloat16* kb = sK + lb * ks;
  const float* k1a = K1c + (size_t)la * hq;
  const float* k1b = K1c + (size_t)lb * hq;
  float sa = 0.f, sb = 0.f;
  for (int s = 0; s < p.ns; ++s) {
    float acc2[R2];
    init_c2<N2>(acc2, b2, s, h2);
    for (int gi = 0; gi < p.ng; ++gi) {
      float acc1[R1];
      init_c1<N1>(acc1, k1a, k1b, q1, gi);
      for (int kt = 0; kt < p.kt1; kt += 2) {     // kt1 is even (the plan)
        uint32_t a[4][4], b[4][4];
        g1_frags(ka, kb, sq, kt, ksteps, a);
        k_tile_bf16<N1, 4>(acc1, a, tile());
        g1_frags(ka, kb, sq, kt + 1, ksteps, b);
        k_tile_bf16<N1, 4>(acc1, b, tile());
        wgmma_commit();
        wgmma_wait_n<0>();
        fence_regs<R1>(acc1);
        done();
        done();
      }
      uint32_t ah[4][4], al[4][4], bh[4][4], bl[4][4];
      g2_tile_bf16<N1, N2, 0>(acc2, acc1, ah, al, tile());
      if constexpr (KT2 > 1)
        g2_tile_bf16<N1, N2, 1>(acc2, acc1, bh, bl, tile());
      wgmma_commit();
      wgmma_wait_n<0>();
      fence_regs<R2>(acc2);
      done();
      if constexpr (KT2 > 1) done();
    }
    layer3<N2>(acc2, w3, s, h2, sa, sb);
  }
  store_scores(sa, sb, srow, l0, nl, bias3);
}

// the row warp's online softmax over a chunk's nl scores, as softmax_chunk,
// its pooled sums (columns lane, lane + 32, ...) in shared memory
template <typename K>
__device__ __forceinline__ void softmax_chunk_wide(float* srow,
                                                   const int* sM,
                                                   const K* sK, int ks,
                                                   int nl, int D, bool first,
                                                   float& m_run, float& s_run,
                                                   float* acc) {
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
  const float scale = first ? 0.f : expf(m_run - m_new);
  // four columns (d0, + 32, + 64, + 96) a pass: four independent sums,
  // each over l in order
  for (int d0 = lane; d0 < D; d0 += 128) {
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    int dc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) dc[j] = d0 + 32 * j < D ? d0 + 32 * j : d0;
#pragma unroll 2
    for (int l = 0; l < nl; ++l) {
      const float pl = srow[l];
      const K* kr = sK + l * ks;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = fmaf(pl, wide(kr[dc[j]]), o[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + 32 * j;
      if (d < D) acc[d] = first ? o[j] : fmaf(acc[d], scale, o[j]);
    }
  }
  s_run = first ? sc : s_run * scale + sc;
  m_run = m_new;
}

// A persistent block (one an SM) of kWG warpgroups holds kWRows query rows
// at a time, 4 a warpgroup (one a warp), and walks the row groups
// blockIdx.x, + gridDim.x, ...; per chunk of keys each warpgroup scores its
// 4 rows against the chunk's 16-key tiles, one m64 tile (a round of weight
// tiles) at a time, then each warp folds its row's scores into the online
// softmax and the pool. The weight tiles come from the prepared buffer by
// the copy engine (thread 0 issues them): resident, a round's tiles are
// staged once and every tile waits on its slot's first fill; else through
// a ring, every slot freed by both warpgroups before thread 0 refills it
// with the tile `slots` steps on (the warpgroups walk the same tiles in
// the same order).
template <typename T, int N1, int N2, bool RESIDENT>
__global__ void __launch_bounds__(kWThreads, 1)
    din_wg_kernel(const T* __restrict__ q, const T* __restrict__ keys,
                  const int* __restrict__ mask, const T* __restrict__ b2,
                  const T* __restrict__ w3, const T* __restrict__ b3,
                  const unsigned char* __restrict__ wprep,
                  const float* __restrict__ K1, const float* __restrict__ Q1,
                  T* __restrict__ out, int B, int L, int D, int h2,
                  WidePlan p, WideLayout lo, int hq) {
  constexpr bool kBF16 = sizeof(T) == 2;
  __shared__ __align__(8) uint64_t full[kWMaxSlots];
  __shared__ __align__(8) uint64_t empty[kWMaxSlots];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* sK = reinterpret_cast<T*>(smem + lo.k);
  T* sQ = reinterpret_cast<T*>(smem + lo.q);
  float* sAcc = reinterpret_cast<float*>(smem + lo.acc);
  float* sS = reinterpret_cast<float*>(smem + lo.s);
  int* sM = reinterpret_cast<int*>(smem + lo.m);
  const int tid = threadIdx.x, lane = tid & 31;
  const int qr = tid >> 5;                 // this warp's row of the block
  const int nrg = (B + kWRows - 1) / kWRows;
  const int nchunks = (L + lo.chunk - 1) / lo.chunk;
  const int last = L - (nchunks - 1) * lo.chunk;
  const long long per_rg =
      (long long)(nchunks - 1) * (lo.chunk / kM) + (last + kM - 1) / kM;
  const int my_rgs =
      blockIdx.x < nrg ? (nrg - 1 - (int)blockIdx.x) / gridDim.x + 1 : 0;
  const long long steps = (long long)my_rgs * per_rg * p.per_round;
  const int ksteps = kBF16 ? lo.dk / 16 : lo.dk / 8;

  // step i of a round: tile (s, g, k) of the plan's order
  auto issue = [&](long long qs) {
    const int i = (int)(qs % p.per_round);
    const int per_s = p.ng * (p.kt1 + p.kt2);
    const int s = i / per_s, r = i % per_s;
    const int g = r / (p.kt1 + p.kt2), k = r % (p.kt1 + p.kt2);
    const long long off =
        k < p.kt1 ? (g * p.kt1 + k) * p.t1
                  : p.w2_off + ((s * p.ng + g) * p.kt2 + k - p.kt1) * p.t2;
    const uint32_t bytes = (uint32_t)(k < p.kt1 ? p.t1 : p.t2);
    const int slot = (int)(RESIDENT ? i : qs % lo.slots);
    mbar_expect_tx(&full[slot], bytes);
    bulk_load(smem + slot * lo.slot, wprep + off, bytes, &full[slot]);
  };
  if (tid == 0) {
    for (int i = 0; i < lo.slots; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    const long long first = RESIDENT ? p.per_round
                                     : (steps < lo.slots ? steps : lo.slots);
    for (long long qs = 0; qs < first; ++qs) issue(qs);
  }
  if (RESIDENT)                // every tile in place before the first round
    for (int i = 0; i < p.per_round; ++i) mbar_wait(&full[i], 0);
  // the block's weight-tile steps (the warpgroups walk them alike): the
  // next one taken (`tile`) and the next one let go (`done`, in order)
  long long taken = 0, freed = 0;
  // resident, the products wait on nothing and no thread leaves the
  // warpgroup's path (a branch between wgmma makes ptxas serialise them)
  auto tile = [&]() -> const unsigned char* {
    const long long q = taken++;
    if (RESIDENT) return smem + (q % p.per_round) * lo.slot;
    const int slot = (int)(q % lo.slots);
    mbar_wait(&full[slot], (uint32_t)((q / lo.slots) & 1));
    return smem + slot * lo.slot;
  };
  auto done = [&]() {
    const long long q = freed++;
    if (!RESIDENT) {
      const int slot = (int)(q % lo.slots);
      if ((tid & 127) == 0) mbar_arrive(&empty[slot]);
      if (tid == 0 && q + lo.slots < steps) {
        mbar_wait(&empty[slot], (uint32_t)((q / lo.slots) & 1));
        issue(q + lo.slots);
      }
    }
  };

  const float bias3 = wide(b3[0]);
  bool staged = false;
  for (int rg = blockIdx.x; rg < nrg; rg += gridDim.x) {
    const int row = rg * kWRows + qr;
    const bool valid = row < B;
    T* sq = sQ + qr * lo.ks;
    for (int d = lane; d < lo.dk; d += 32) {
      if (valid && d < D)
        stage_elem(sq + d, q + (size_t)row * D, d);
      else
        sq[d] = zero_of<T>();
    }
    __syncwarp();
    const float* q1 = Q1 + (size_t)(valid ? row : B - 1) * hq;
    float* srow = sS + qr * lo.cs;
    float* acc = sAcc + qr * lo.dk;
    float m_run = -INFINITY, s_run = 0.f;
    for (int c0 = 0; c0 < L; c0 += lo.chunk) {
      const int nl = min(lo.chunk, L - c0);
      if (nchunks > 1 || !staged) {
        __syncthreads();                 // the last chunk's keys are read
        for (int i = tid; i < nl * lo.dk; i += kWThreads) {
          const int l = i / lo.dk, d = i - l * lo.dk;
          if (d < D)
            stage_elem(sK + l * lo.ks + d, keys, (c0 + l) * D + d);
          else
            sK[l * lo.ks + d] = zero_of<T>();
        }
        for (int i = tid; i < nl; i += kWThreads) sM[i] = mask[c0 + i];
        __syncthreads();
        staged = true;
      }
      for (int l0 = 0; l0 < nl; l0 += kM)
        score_tile<N1, N2>(sK, sq, K1 + (size_t)c0 * hq, q1, b2, w3, srow,
                           l0, nl, h2, lo.ks, hq, ksteps, p, bias3, tile,
                           done);
      __syncwarp();
          if (valid)
        softmax_chunk_wide(srow, sM, sK, lo.ks, nl, D, c0 == 0, m_run, s_run,
                           acc);
      __syncwarp();
    }
    if (valid) {
      T* orow = out + (size_t)row * D;
      for (int d = lane; d < D; d += 32) st(orow, d, acc[d] / s_run);
    }
    __syncwarp();
  }
}

int sm_count() {
  static std::atomic<int> sms{0};
  int n = sms.load();
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      return 0;
    sms.store(n);
  }
  return n;
}

template <typename T, int N1, int N2, bool RESIDENT>
int launch_wg(const T* q, const T* keys, const int* mask, const T* b2,
              const T* w3, const T* b3, const unsigned char* wprep,
              const float* K1, const float* Q1, T* out, int B, int L, int D,
              int h2, const WidePlan& p, const WideLayout& lo, int hq,
              cudaStream_t s) {
  auto kernel = din_wg_kernel<T, N1, N2, RESIDENT>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lo.total);
  if (e != cudaSuccess) return (int)e;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  const int nrg = (B + kWRows - 1) / kWRows;
  kernel<<<nrg < sms ? nrg : sms, kWThreads, lo.total, s>>>(
      q, keys, mask, b2, w3, b3, wprep, K1, Q1, out, B, L, D, h2, p, lo, hq);
  return 0;
}

template <typename T>
int launch_wide(const T* q, const T* keys, const int* mask, const T* w1,
                const T* b1, const T* b2, const T* w3, const T* b3, T* out,
                int B, int L, int D, int h1, int h2, const void* wprep,
                void* work, void* stream) {
  constexpr bool kBF16 = sizeof(T) == 2;
  if (B <= 0 || L <= 0 || D <= 0 || h1 <= 0 || h2 <= 0 || work == nullptr ||
      wprep == nullptr || D > wide_max_dim(kBF16))
    return (int)cudaErrorInvalidValue;
  const WidePlan p = wide_plan(D, h1, h2, kBF16);
  const WideLayout lo = wide_layout(L, D, h1, h2, kBF16);
  if (lo.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  const WideWork wk = wide_work(p, B, L);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* w = static_cast<unsigned char*>(work);
  float* K1 = reinterpret_cast<float*>(w + wk.k1);
  float* Q1 = reinterpret_cast<float*>(w + wk.q1);
  const long long nfold = (long long)(L + B) * wk.hq;
  const long long fold_blocks = (nfold + kFoldThreads - 1) / kFoldThreads;
  din_wide_fold<T><<<(int)(fold_blocks < 1048576 ? fold_blocks : 1048576),
                     kFoldThreads, 0, s>>>(q, keys, w1, b1, K1, Q1, B, L, D,
                                           h1, wk.hq);
  if (const cudaError_t e = cudaGetLastError()) return (int)e;
  const unsigned char* wp = static_cast<const unsigned char*>(wprep);
  // DIN's width resident (its only layout), any other width either way
  int rc;
  if (din_widths(h1, h2))
    rc = lo.resident
             ? launch_wg<T, 80, 40, true>(q, keys, mask, b2, w3, b3, wp, K1,
                                          Q1, out, B, L, D, h2, p, lo, wk.hq,
                                          s)
             : launch_wg<T, 80, 40, false>(q, keys, mask, b2, w3, b3, wp, K1,
                                           Q1, out, B, L, D, h2, p, lo, wk.hq,
                                           s);
  else
    rc = lo.resident
             ? launch_wg<T, 64, 64, true>(q, keys, mask, b2, w3, b3, wp, K1,
                                          Q1, out, B, L, D, h2, p, lo, wk.hq,
                                          s)
             : launch_wg<T, 64, 64, false>(q, keys, mask, b2, w3, b3, wp, K1,
                                           Q1, out, B, L, D, h2, p, lo, wk.hq,
                                           s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// bytes of the wide route's workspace, or -1 where it cannot take the unit
long wide_work_bytes(int B, int L, int D, int h1, int h2, bool bf16) {
  if (B <= 0 || L <= 0 || D <= 0 || h1 <= 0 || h2 <= 0 ||
      D > wide_max_dim(bf16))
    return -1;
  if (wide_layout(L, D, h1, h2, bf16).total > kMaxSmem) return -1;
  return (long)wide_work(wide_plan(D, h1, h2, bf16), B, L).total;
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

// the fp32 pipeline
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
// of these widths (the wide route's block past the register tiles, D <= 64,
// h1 <= 128, h2 <= 64), or -1 when L, D, h1 or h2 is not positive or D is
// past din_attention_max_dim(0). Never past a block's 232,448 bytes,
// whatever L.
long din_attention_smem_bytes(int L, int D, int h1, int h2) {
  if (within_tiles(L, D, h1, h2))
    return (long)bytes_of(layout_f(L, D, h1, h2));
  if (wide_work_bytes(1, L, D, h1, h2, false) < 0) return -1;
  return (long)wide_layout(L, D, h1, h2, false).total;
}

// Keys a block of the fp32 pipeline stages and scores at once for these
// widths (a multiple of 16, at most 112), or -1 where
// din_attention_smem_bytes is -1.
int din_attention_chunk_keys(int D, int h1, int h2) {
  if (within_tiles(1, D, h1, h2)) return layout_f(kChunk, D, h1, h2).chunk;
  if (wide_work_bytes(1, kChunk, D, h1, h2, false) < 0) return -1;
  return wide_layout(kChunk, D, h1, h2, false).chunk;
}

// The same two for the bf16 entries.
long din_attention_bf16_smem_bytes(int L, int D, int h1, int h2) {
  if (within_tiles(L, D, h1, h2))
    return (long)bytes_of(layout_h(L, D, h1, h2));
  if (wide_work_bytes(1, L, D, h1, h2, true) < 0) return -1;
  return (long)wide_layout(L, D, h1, h2, true).total;
}

int din_attention_bf16_chunk_keys(int D, int h1, int h2) {
  if (within_tiles(1, D, h1, h2)) return layout_h(kChunk, D, h1, h2).chunk;
  if (wide_work_bytes(1, kChunk, D, h1, h2, true) < 0) return -1;
  return wide_layout(kChunk, D, h1, h2, true).chunk;
}

// The widest D the wide route takes (bf16 = 0: fp32, 1: bf16): 16 keys,
// the 16 query rows and their pooled sums fill a block's shared memory.
int din_attention_max_dim(int bf16) { return wide_max_dim(bf16 != 0); }

// Bytes of workspace the wide entry of that type (bf16 = 0: fp32, 1: bf16)
// takes for B rows, L keys and these widths: 0 where the unit is within the
// register tiles (din_attention_f32 / _bf16 take it, with none), -1 where
// B, L, D, h1 or h2 is not positive or D is past din_attention_max_dim.
long din_attention_work_bytes(int B, int L, int D, int h1, int h2,
                              int bf16) {
  if (B > 0 && within_tiles(L, D, h1, h2)) return 0;
  return wide_work_bytes(B, L, D, h1, h2, bf16 != 0);
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
  return dispatch_bf16(q, keys, mask, w1, b1, w2, b2, w3, b3, out, B, L, D,
                       h1, h2, stream);
}

// Bytes of the wide route's prepared weights (the tile plan at the top of
// the wide route; bf16 = 0: fp32, 1: bf16), which the wrapper holds its
// layout to; -1 where a width is not positive.
long din_attention_prep_bytes(int D, int h1, int h2, int bf16) {
  if (D <= 0 || h1 <= 0 || h2 <= 0) return -1;
  return (long)wide_plan(D, h1, h2, bf16 != 0).total;
}

// The wide route, for a unit past the register tiles: the same tensors
// (w2 unread: its prepared tiles stand in), `wprep`, the prepared weights
// (din_attention_prep_bytes, aligned to 16 bytes; kernels/din_attention/
// ops.py prepares them once per set of weights), and `work`,
// din_attention_work_bytes of device memory aligned to 256 bytes
// (scratch: the entry overwrites it). Two launches on `stream` (K1 and
// Q1, then the unit), no allocation, no synchronisation. Returns
// cudaGetLastError() after the launches (0 = launched).
int din_attention_wide_f32(const float* q, const float* keys,
                           const int* mask, const float* w1, const float* b1,
                           const float* w2, const float* b2, const float* w3,
                           const float* b3, float* out, int B, int L, int D,
                           int h1, int h2, const void* wprep, void* work,
                           void* stream) {
  (void)w2;
  return launch_wide(q, keys, mask, w1, b1, b2, w3, b3, out, B, L, D, h1, h2,
                     wprep, work, stream);
}

int din_attention_wide_bf16(const __nv_bfloat16* q,
                            const __nv_bfloat16* keys, const int* mask,
                            const __nv_bfloat16* w1,
                            const __nv_bfloat16* b1,
                            const __nv_bfloat16* w2,
                            const __nv_bfloat16* b2,
                            const __nv_bfloat16* w3,
                            const __nv_bfloat16* b3, __nv_bfloat16* out,
                            int B, int L, int D, int h1, int h2,
                            const void* wprep, void* work, void* stream) {
  (void)w2;
  return launch_wide(q, keys, mask, w1, b1, b2, w3, b3, out, B, L, D, h1, h2,
                     wprep, work, stream);
}

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
