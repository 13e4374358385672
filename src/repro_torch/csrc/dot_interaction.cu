// DLRM dot interaction for Hopper, fp32 and bf16.
//
//   out[b, p] = sum_d x[b, i_p, d] * x[b, j_p, d]
//
// with (i_p, j_p) the upper triangle of the F x F gram in row-major order,
// np.triu_indices(F, k=1) (k=0 with KEEP_SELF). Replaces the TPU Pallas
// kernel dot_interaction_kernel (src/repro/kernels/dot_interaction/
// kernel.py:41), which filled a (bm, F, F) gram in VMEM and picked the
// triangle with a one-hot (F*F, P) matmul on the MXU; here only the
// gram's 4 x 4 tiles on or above the diagonal are computed, and the
// triangle is written directly.
//
// What bounds it on an H100: at the serving path's shape (B up to 4096,
// F = 27, D = 128, P = 351) it moves 4 * (B*F*D + B*P) = 62.4 MB and does
// 2*B*P*D = 0.37 GFLOP: 6 FLOP/byte, below the fp32 ridge (67 TFLOP/s /
// 3.35 TB/s = 20 FLOP/byte), so it is bound by bytes (18.6 us), provided
// the copy of later rows runs while earlier rows are computed. The first
// design did not: a warp per row copied it in with 4-byte cp.async,
// waited, then computed (0.0429 ms). What paces this one is the shared
// memory: a lane's 4 x 4 tile takes 8 16-byte loads per 64 FMAs, and a
// warp's 16-byte load costs the SM 4 cycles of shared-memory bandwidth
// whatever it broadcasts, 1024 cycles a row (PERF.md, section 6).
//
// The design: persistent blocks (one per SM, each walking rows b,
// b + grid, ...), one producer warp and nc consumer warps, consumer w
// taking rows w, w + nc, ... of its block. Two plans: 7 consumers with a
// ring of 2 slots each (the next row's copy runs while one is computed),
// or, for a block of 8 .. 11 rows, 11 consumers of one slot, so that all
// its rows run at once.
//  * Copy. The producer fills a consumer's next slot, once the consumer
//    has released it, with the row laid out as D / 32 column chunks of F
//    rows of 128 bytes, the 128-byte swizzle applied (the 16-byte word w of
//    slot row R lies at word w ^ (R % 8)): one TMA copy per row (a 3-D
//    tensor map, box 32 x F x D / 32, completing on the slot's `full`
//    mbarrier; TMA instance: D % 32 == 0, x 16-byte aligned, F <= 256),
//    or 4-byte cp.async writing the same layout (at most 4-way bank
//    conflicts), each producer lane's copies arriving on `full` through
//    cp.async.mbarrier.arrive.noinc (count 32; any D, any view; the
//    padding columns zeroed once). One copy per row: a cp.async.bulk per
//    512-byte feature row kept the copies far below the card's rate.
//  * Tiles. Features are dealt to T = ceil(F / 4) classes, class c holding
//    features c, c + T, c + 2T, c + 3T (the ones >= F are padding, never
//    stored). Lane t of a consumer owns tile (ti, tj), ti <= tj (row-major
//    over the T x T tile triangle; F = 27: 28 tiles on 28 lanes, more in
//    rounds of 32). Per 4 columns of d it loads one float4 of each of its 8
//    feature rows and does 64 FMAs, fmaf over d = 0 .. D - 1 in order, so
//    a row's result never depends on B. One load instruction of the warp
//    reads features ti + T r (r fixed) over the lanes at one column: slot
//    rows R = q F + f consecutive in f, so the swizzle puts them on
//    distinct bank quads for T <= 8 (ceil(T / 8) words a quad beyond), the
//    lanes of one tile row sharing each word.
//  * Out. The slot is released once read; the triangle, staged per warp in
//    shared memory (scalar stores, at most ceil(T / 2)-way conflicts), is
//    written with coalesced stores.
//
// bf16 (dot_interaction_bf16): the TPU kernel's numerics, bf16 x, every
// product exact and every sum in f32, the output rounded to bf16 once, on
// the bf16 tensor cores. Its bound is bytes, as fp32's, at half of them:
// 2 * (B*F*D + B*P) = 31.2 MB at B = 4096, 9.3 us; the gram's 0.37 GFLOP
// take 0.4 us at the bf16 peak. The same persistent ring, with bf16 slots
// of D / 64 (rounded up) chunks of F rows of 128 bytes, the 128-byte
// swizzle applied: half the bytes of an fp32 slot. One plan: a consumer
// warp per row of the block up to 15, then 15 consumers of two slots
// (F = 27, D = 128: 30 slots, 227 KB): the consumers pace it (a row's 48
// mma, its staging and stores), and on an H100 at B = 4096 fp32's ring
// of 7 took 1.32x as long (PERF.md, section 6).
//  * Copy. One TMA copy a row (box 64 x F x D / 64; D % 64 == 0, x 16-byte
//    aligned, F <= 256); else cp.async into the same layout (16 bytes where
//    D % 8 == 0 and x is 16-byte aligned, 4 where D is even and x 4-byte
//    aligned), arriving on `full` as fp32's; else (an odd D, a view 2 bytes
//    past alignment) the producer's own 2-byte loads and shared stores,
//    arriving on `full` after them. Columns D .. 16 ceil(D / 16) are zeroed
//    once where the copies never write them.
//  * Gram. mma.sync.m16n8k16 bf16 with f32 sums: F padded to a multiple of
//    16 by clamping the rows read (padding rows are never stored), D to a
//    multiple of 16. A consumer warp computes only the m16 x n8 tiles that
//    touch the upper triangle (n tile >= 2 m tile; F = 27: 6 of 8 tiles, 48
//    mma a row, keep_self keeping the diagonal), a pass at a time (one m16
//    tile against up to 8 n8 tiles). One ldmatrix.x4 of 16 feature rows at
//    16 columns gives the A fragment of that m tile and the B fragments of
//    its two n8 tiles alike (the gram is x x^T), so a pass loads one x4
//    per 16 rows per k step; the 8 rows of each 8 x 8 matrix lie in 8
//    consecutive slot rows, on distinct 16-byte bank groups (no conflict).
//  * Numerics. Products of bf16 are exact in f32 and every sum is f32, as
//    on the TPU; the order of the sums is the mma's (a k step's 16 products
//    inside the tensor core, then the k steps in order), so a result is no
//    longer bit for bit the fp32 kernel's on the widened row: it lies one
//    bf16 rounding of an f32 reordering from it. A row's instruction
//    sequence never depends on B, so neither do its bits.
//  * Out. The triangle, staged per warp in shared memory in bf16, is
//    written with coalesced 2-byte stores (P * 2 bytes a row).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// the two plans (consumer warps, slots each): a ring of 2 slots for each
// of 7 consumers, or 11 consumers of one slot when a block has 8 .. 11 rows
// (its rows then all run at once; chip_smoke.py times the ring plan alone
// there, the DOT_INTERACTION_RING_ONLY build)
constexpr int kRingConsumers = 7;
constexpr int kWideConsumers = 11;
// bf16: one plan, as many consumers as a block has rows, up to 15 (two
// slots each of 7 KB at F = 27, D = 128; a 16th warp would not fit)
constexpr int kBf16Consumers = 15;
constexpr int kMaxSmem = 232448;    // a Hopper block's dynamic shared memory
constexpr int kSlotAlign = 1024;    // the 128-byte swizzle's period
constexpr int kPairs = 4;           // bf16: n8 tile pairs (64 columns) a pass
constexpr unsigned kFull = 0xffffffffu;

// how a row reaches its slot
enum Route { kTma = 0, kCpAsync = 1, kSync = 2 };

// shared-memory layout of one launch: 2 mbarriers per consumer and the
// staging rows (P elements per consumer, rounded up to 16 bytes), then the
// slots, each 1024-byte aligned: D / (128 / esize) (rounded up) chunks of F
// rows of 128 bytes; fp32 slots hold 3 rows more that the padding features
// of the last chunk read (bf16 clamps its padding rows instead)
struct Plan {
  int nq, slot_bytes, stage_elems, nc, spw;
  size_t head_bytes, smem;
};

// the plan with up to max_nc consumers of spw slots that fits, for
// elements of esize bytes (4: fp32, 2: bf16)
bool make_plan(int F, int D, int P, int esize, int max_nc, int spw,
               Plan* p) {
  const int cols = 128 / esize;
  p->nq = (D + cols - 1) / cols;
  p->slot_bytes = ((p->nq * F + (esize == 4 ? 3 : 0)) * 128 + kSlotAlign -
                   1) & ~(kSlotAlign - 1);
  p->stage_elems = (P + 16 / esize - 1) & ~(16 / esize - 1);
  p->spw = spw;
  for (p->nc = max_nc; p->nc >= 1; --p->nc) {
    const size_t slots = (size_t)p->nc * spw;
    p->head_bytes = (16 * slots + (size_t)esize * p->nc * p->stage_elems +
                     kSlotAlign - 1) & ~(size_t)(kSlotAlign - 1);
    // the dynamic shared memory starts 16-byte aligned: up to 1008 bytes
    // go to aligning the slots
    p->smem = p->head_bytes + slots * p->slot_bytes + kSlotAlign - 16;
    if (p->smem <= (size_t)kMaxSmem) return true;
  }
  return false;
}

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

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile("{\n.reg .pred p;\n"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
               "selp.u32 %0, 1, 0, p;\n}\n"
               : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done;
}

// the whole warp waits for the phase and leaves the loop converged
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!__all_sync(kFull, mbar_try_wait(bar, parity))) {
  }
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

// the mbarrier counts one arrival once this thread's earlier cp.async
// copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// byte offset in a slot of x[f][d]: chunk q = d / 32 holds slot rows
// R = q F + f of 128 bytes, 16-byte word (d % 32) / 4 of row R at word
// ((d % 32) / 4) ^ (R % 8)
__device__ __forceinline__ uint32_t slot_offset(int f, int d, int F) {
  const int R = (d >> 5) * F + f;
  return (uint32_t)(R * 128 + ((((d & 31) >> 2) ^ (R & 7)) << 4) +
                    ((d & 3) << 2));
}

// the same for a bf16 slot: chunk q = d / 64, word (d % 64) / 8
__device__ __forceinline__ uint32_t slot_offset_bf16(int f, int d, int F) {
  const int R = (d >> 6) * F + f;
  return (uint32_t)(R * 128 + ((((d & 63) >> 3) ^ (R & 7)) << 4) +
                    ((d & 7) << 1));
}

template <bool KEEP_SELF>
__device__ __forceinline__ int pair_index(int i, int j, int F) {
  // start of triangle row i, then the offset of j inside it
  return KEEP_SELF ? i * (2 * F - i + 1) / 2 + (j - i)
                   : i * (2 * F - i - 1) / 2 + (j - i - 1);
}

__device__ __forceinline__ float part(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// tile t of the row in `slot`: 16 dots, written to the warp's staging row
// at their triangle positions
template <bool KEEP_SELF>
__device__ __forceinline__ void tile_dots(const unsigned char* slot, int t,
                                          int T, int F, int nq,
                                          float* stage) {
  int ti = 0, rem = t, len = T;
  while (rem >= len) {
    rem -= len;
    ++ti;
    --len;
  }
  const int tj = ti + rem;
  float acc[4][4] = {};
  for (int q = 0; q < nq; ++q) {
    // row R's 16-byte word w lies at (start of R) ^ (w << 4), the start of
    // R carrying (R % 8) << 4 for the swizzle
    uint32_t a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int ra = q * F + ti + T * r, rb = q * F + tj + T * r;
      a[r] = ra * 128 + ((ra & 7) << 4);
      b[r] = rb * 128 + ((rb & 7) << 4);
    }
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      float4 av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        av[r] = *reinterpret_cast<const float4*>(slot + (a[r] ^ (w << 4)));
        bv[r] = *reinterpret_cast<const float4*>(slot + (b[r] ^ (w << 4)));
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)        // d = 32 q + 4 w + k, in order
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s)
            acc[r][s] = fmaf(part(av[r], k), part(bv[s], k), acc[r][s]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int i = ti + T * r, j = tj + T * s;
      const bool keep = ti != tj || (KEEP_SELF ? r <= s : r < s);
      if (i < F && j < F && keep)
        stage[pair_index<KEEP_SELF>(min(i, j), max(i, j), F)] = acc[r][s];
    }
}

template <bool KEEP_SELF, bool TMA, int MAX_NC>
__global__ void __launch_bounds__(32 * (MAX_NC + 1), 1)
    dot_interaction_kernel(const __grid_constant__ CUtensorMap xmap,
                           const float* __restrict__ x,
                           float* __restrict__ out, int B, int F, int D,
                           int P, Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nslots = pl.nc * pl.spw;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + nslots;
  float* stages = reinterpret_cast<float*>(smem + 16 * nslots);
  unsigned char* slots = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem) + pl.head_bytes + kSlotAlign - 1) &
      ~(uintptr_t)(kSlotAlign - 1));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grid = gridDim.x;
  const int nrows = (int)blockIdx.x < B ? (B - 1 - blockIdx.x) / grid + 1 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < nslots; ++s) {
      mbar_init(&full[s], TMA ? 1 : 32);
      mbar_init(&empty[s], 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!TMA) {
    // columns D .. 32 nq of every slot stay 0 (copies never write them)
    const int pad = 32 * pl.nq - D;
    for (int e = threadIdx.x; e < nslots * F * pad; e += blockDim.x) {
      const int w = e / (F * pad), rest = e - w * F * pad;
      *reinterpret_cast<float*>(
          slots + (size_t)w * pl.slot_bytes +
          slot_offset(rest / pad, D + rest % pad, F)) = 0.f;
    }
  }
  __syncthreads();

  if (warp == pl.nc) {
    // producer: row k of this block goes to consumer k % nc, into its slot
    // (k / nc) % spw, on that slot's (k / nc / spw)-th use
    for (int k = 0; k < nrows; ++k) {
      const int j = k / pl.nc;
      const int w = (k % pl.nc) * pl.spw + j % pl.spw;
      const int use = j / pl.spw;
      if (use > 0) mbar_wait(&empty[w], (use - 1) & 1);
      const int b = blockIdx.x + k * grid;
      unsigned char* dst = slots + (size_t)w * pl.slot_bytes;
      if (TMA) {
        if (lane == 0) {
          mbar_expect_tx(&full[w], (uint32_t)(pl.nq * F * 128));
          tma_load_3d(dst, &xmap, &full[w], 0, b * F, 0);
        }
      } else {
        const float* src = x + (size_t)b * F * D;
        const uint32_t base = smem_u32(dst);
        int f = 0, d = lane;
        while (d >= D) {
          d -= D;
          ++f;
        }
        for (int e = lane; e < F * D; e += 32) {
          cp_async4(base + slot_offset(f, d, F), src + e);
          d += 32;
          while (d >= D) {
            d -= D;
            ++f;
          }
        }
        cp_async_arrive(&full[w]);
      }
    }
    return;
  }

  float* stage = stages + (size_t)warp * pl.stage_elems;
  const int T = (F + 3) / 4;
  const int tiles = T * (T + 1) / 2;
  for (int j = 0, k = warp; k < nrows; ++j, k += pl.nc) {
    const int w = warp * pl.spw + j % pl.spw;
    const unsigned char* slot = slots + (size_t)w * pl.slot_bytes;
    mbar_wait(&full[w], (j / pl.spw) & 1);
    for (int t0 = 0; t0 < tiles; t0 += 32)  // warp-uniform trip count
      if (t0 + lane < tiles)
        tile_dots<KEEP_SELF>(slot, t0 + lane, T, F, pl.nq, stage);
    mbar_arrive(&empty[w]);                  // every lane: count 32
    __syncwarp();
    float* ob = out + ((size_t)blockIdx.x + (size_t)k * grid) * P;
    for (int p0 = 0; p0 < P; p0 += 32)
      if (p0 + lane < P) ob[p0 + lane] = stage[p0 + lane];
    __syncwarp();
  }
}

// ---- bf16 on the tensor cores ------------------------------------------

// four 8 x 8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

// C (16 x 8, f32) += A (16 x 16, bf16) * B (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the ldmatrix.x4 address of this lane for feature rows 16 m .. 16 m + 15
// (clamped to F - 1: padding rows are read, never stored) at columns
// 16 ks .. 16 ks + 15: lanes 0-15 give rows at column 16 ks, lanes 16-31
// the same rows at 16 ks + 8, so the four matrices are A's fragment
// registers (rows 0-7 | 8-15) x (columns 0-7 | 8-15) of the m16 x k16 tile
__device__ __forceinline__ uint32_t frag_addr(uint32_t slot, int m, int ks,
                                              int F, int lane) {
  const int f = min(16 * m + (lane & 15), F - 1);
  const int c = 16 * ks + ((lane >> 4) << 3);
  const int R = (c >> 6) * F + f;
  return slot + R * 128 + ((((c & 63) >> 3) ^ (R & 7)) << 4);
}

// one pass of a consumer: m16 tile mi against the n8 tiles of row groups
// p0 .. p0 + kPairs - 1 (p < MT), over every k step, staged in bf16. B of
// n8 tile 2p (2p + 1) is (r0, r2) ((r1, r3)) of the x4 of rows 16p .. 16p
// + 15, the same registers as A's where p == mi.
template <bool KEEP_SELF>
__device__ __forceinline__ void gram_pass(uint32_t slot, int mi, int p0,
                                          int MT, int KT, int F,
                                          __nv_bfloat16* stage, int lane) {
  float acc[kPairs][2][4];
#pragma unroll
  for (int g = 0; g < kPairs; ++g)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][u][e] = 0.f;
  for (int ks = 0; ks < KT; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, frag_addr(slot, mi, ks, F, lane));
#pragma unroll
    for (int g = 0; g < kPairs; ++g) {
      const int p = p0 + g;
      if (p < MT) {
        uint32_t b[4] = {a[0], a[1], a[2], a[3]};
        if (p != mi) ldsm_x4(b, frag_addr(slot, p, ks, F, lane));
        mma_bf16(acc[g][0], a, b[0], b[2]);
        if (16 * p + 8 < F) mma_bf16(acc[g][1], a, b[1], b[3]);
      }
    }
  }
  // C: lane holds rows g8, g8 + 8 at columns 2 t4, 2 t4 + 1
  const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int g = 0; g < kPairs; ++g)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * mi + g8 + 8 * (e >> 1);
        const int j = 8 * (2 * (p0 + g) + u) + 2 * t4 + (e & 1);
        if (p0 + g < MT && j < F && (KEEP_SELF ? i <= j : i < j))
          stage[pair_index<KEEP_SELF>(i, j, F)] =
              __float2bfloat16_rn(acc[g][u][e]);
      }
}

template <bool KEEP_SELF, bool TMA, int MAX_NC>
__global__ void __launch_bounds__(32 * (MAX_NC + 1), 1)
    dot_interaction_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                                const __nv_bfloat16* __restrict__ x,
                                __nv_bfloat16* __restrict__ out, int B,
                                int F, int D, int P, Plan pl, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nslots = pl.nc * pl.spw;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + nslots;
  __nv_bfloat16* stages =
      reinterpret_cast<__nv_bfloat16*>(smem + 16 * nslots);
  unsigned char* slots = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem) + pl.head_bytes + kSlotAlign - 1) &
      ~(uintptr_t)(kSlotAlign - 1));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grid = gridDim.x;
  const int nrows = (int)blockIdx.x < B ? (B - 1 - blockIdx.x) / grid + 1 : 0;
  const int KT = (D + 15) / 16;

  if (threadIdx.x == 0) {
    for (int s = 0; s < nslots; ++s) {
      mbar_init(&full[s], TMA ? 1 : 32);
      mbar_init(&empty[s], 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!TMA) {
    // columns D .. 16 KT of every slot stay 0 (copies never write them)
    const int pad = 16 * KT - D;
    for (int e = threadIdx.x; e < nslots * F * pad; e += blockDim.x) {
      const int w = e / (F * pad), rest = e - w * F * pad;
      *reinterpret_cast<uint16_t*>(
          slots + (size_t)w * pl.slot_bytes +
          slot_offset_bf16(rest / pad, D + rest % pad, F)) = 0;
    }
  }
  __syncthreads();

  if (warp == pl.nc) {
    // producer: as the fp32 kernel's
    for (int k = 0; k < nrows; ++k) {
      const int j = k / pl.nc;
      const int w = (k % pl.nc) * pl.spw + j % pl.spw;
      const int use = j / pl.spw;
      if (use > 0) mbar_wait(&empty[w], (use - 1) & 1);
      const int b = blockIdx.x + k * grid;
      unsigned char* dst = slots + (size_t)w * pl.slot_bytes;
      if (TMA) {
        if (lane == 0) {
          mbar_expect_tx(&full[w], (uint32_t)(pl.nq * F * 128));
          tma_load_3d(dst, &xmap, &full[w], 0, b * F, 0);
        }
        continue;
      }
      const __nv_bfloat16* src = x + (size_t)b * F * D;
      const uint32_t base = smem_u32(dst);
      if (vec == 16) {               // 8 columns a copy (D % 8 == 0)
        for (int e = lane; e < F * D / 8; e += 32) {
          const int f = (e * 8) / D, d = e * 8 - f * D;
          cp_async16(base + slot_offset_bf16(f, d, F), src + (size_t)e * 8);
        }
      } else if (vec == 4) {         // 2 columns a copy (D even)
        for (int e = lane; e < F * D / 2; e += 32) {
          const int f = (e * 2) / D, d = e * 2 - f * D;
          cp_async4(base + slot_offset_bf16(f, d, F), src + (size_t)e * 2);
        }
      } else {                       // 2-byte loads and stores
        const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
        for (int e = lane; e < F * D; e += 32) {
          const int f = e / D, d = e - f * D;
          *reinterpret_cast<uint16_t*>(dst + slot_offset_bf16(f, d, F)) =
              s16[e];
        }
        mbar_arrive(&full[w]);       // every lane, after its stores: 32
        continue;
      }
      cp_async_arrive(&full[w]);
    }
    return;
  }

  __nv_bfloat16* stage = stages + (size_t)warp * pl.stage_elems;
  const int MT = (F + 15) / 16;
  for (int j = 0, k = warp; k < nrows; ++j, k += pl.nc) {
    const int w = warp * pl.spw + j % pl.spw;
    const uint32_t slot = smem_u32(slots + (size_t)w * pl.slot_bytes);
    mbar_wait(&full[w], (j / pl.spw) & 1);
    for (int mi = 0; mi < MT; ++mi)
      for (int p0 = mi; p0 < MT; p0 += kPairs)
        gram_pass<KEEP_SELF>(slot, mi, p0, MT, KT, F, stage, lane);
    mbar_arrive(&empty[w]);                  // every lane: count 32
    __syncwarp();
    __nv_bfloat16* ob = out + ((size_t)blockIdx.x + (size_t)k * grid) * P;
    for (int p = lane; p < P; p += 32) ob[p] = stage[p];
    __syncwarp();
  }
}

// ---- host side -------------------------------------------------------------
// cuTensorMapEncodeTiled is a driver API; reach it through the runtime so
// the library needs no -lcuda
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

constexpr int ERR_NO_ENCODER = 90000;
constexpr int ERR_ENCODE = 90001;     // + the CUresult

EncodeTiledFn encoder() {
  static EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// x (B * F rows of D elements of esize bytes) as (128 / esize columns,
// B * F rows, D / (128 / esize) chunks), loaded a row of x at a time (box
// 128 bytes x F x chunks) with the 128-byte swizzle
int encode(CUtensorMap* m, const void* x, int B, int F, int D, int esize) {
  EncodeTiledFn fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint32_t cols = 128 / esize;
  cuuint64_t dims[3] = {cols, (cuuint64_t)B * F, (cuuint64_t)D / cols};
  cuuint64_t strides[2] = {(cuuint64_t)D * esize, 128};
  cuuint32_t box[3] = {cols, (cuuint32_t)F, (cuuint32_t)D / cols};
  cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = fn(m, esize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  3, const_cast<void*>(x), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

template <typename T, bool KEEP_SELF, bool TMA, int MAX_NC>
int launch(const CUtensorMap& xm, const T* x, T* out, int B, int F, int D,
           int P, const Plan& pl, int blocks, int vec, cudaStream_t stream) {
  auto kernel = [] {
    if constexpr (sizeof(T) == 4)
      return dot_interaction_kernel<KEEP_SELF, TMA, MAX_NC>;
    else
      return dot_interaction_bf16_kernel<KEEP_SELF, TMA, MAX_NC>;
  }();
  if (pl.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
    if (e != cudaSuccess) return (int)e;
  }
  if constexpr (sizeof(T) == 4)
    kernel<<<blocks, 32 * (pl.nc + 1), pl.smem, stream>>>(xm, x, out, B, F,
                                                           D, P, pl);
  else
    kernel<<<blocks, 32 * (pl.nc + 1), pl.smem, stream>>>(xm, x, out, B, F,
                                                           D, P, pl, vec);
  return (int)cudaGetLastError();
}

// the TMA instance or the other copies', with or without the diagonal
template <typename T, int MAX_NC>
int launch_any(const CUtensorMap& xm, const T* x, T* out, int B, int F,
               int D, int P, const Plan& pl, int blocks, int tma, int vec,
               int keep_self, cudaStream_t s) {
  if (tma)
    return keep_self ? launch<T, true, true, MAX_NC>(xm, x, out, B, F, D, P,
                                                      pl, blocks, vec, s)
                     : launch<T, false, true, MAX_NC>(xm, x, out, B, F, D, P,
                                                       pl, blocks, vec, s);
  return keep_self ? launch<T, true, false, MAX_NC>(xm, x, out, B, F, D, P,
                                                     pl, blocks, vec, s)
                   : launch<T, false, false, MAX_NC>(xm, x, out, B, F, D, P,
                                                      pl, blocks, vec, s);
}

// route: kTma (fp32: D % 32 == 0; bf16: D % 64 == 0; F <= 256, x 16-byte
// aligned), kCpAsync (fp32: any; bf16: D even, x 4-byte aligned) or kSync
// (bf16 only: any)
template <typename T>
int run(const T* x, T* out, int B, int F, int D, int keep_self, int route,
        void* stream) {
  constexpr int esize = sizeof(T);
  const int P = keep_self ? F * (F + 1) / 2 : F * (F - 1) / 2;
  const uintptr_t at = reinterpret_cast<uintptr_t>(x);
  Plan pl;
  if (B <= 0 || D <= 0 || P <= 0 || !make_plan(F, D, P, esize, 1, 1, &pl) ||
      (route == kTma && (D % (128 / esize) != 0 || F > 256 || at % 16 != 0)) ||
      (route == kCpAsync && esize == 2 && (D % 2 != 0 || at % 4 != 0)) ||
      (route == kSync && esize == 4) || route < kTma || route > kSync)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xm;
  memset(&xm, 0, sizeof xm);
  if (route == kTma) {
    const int rc = encode(&xm, x, B, F, D, esize);
    if (rc) return rc;
  }
  // bf16 copy bytes: 16 or 4 (cp.async), 2 (the producer's own)
  const int vec = route == kSync ? 2
                  : D % 8 == 0 && at % 16 == 0 ? 16 : 4;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int blocks = B < sms ? B : sms;
  const int rows = (B + blocks - 1) / blocks;    // rows of a block, at most
  const int tma = route == kTma;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (esize == 2) {
    // a consumer per row up to 15, then a ring of two slots each
    const int nc = rows < kBf16Consumers ? rows : kBf16Consumers;
    if (!make_plan(F, D, P, esize, nc, rows > nc ? 2 : 1, &pl))
      make_plan(F, D, P, esize, nc, 1, &pl);
    return launch_any<T, kBf16Consumers>(xm, x, out, B, F, D, P, pl, blocks,
                                         tma, vec, keep_self, s);
  } else {
#ifndef DOT_INTERACTION_RING_ONLY   // a build chip_smoke.py times beside it
    if (rows > kRingConsumers && rows <= kWideConsumers &&
        make_plan(F, D, P, esize, kWideConsumers, 1, &pl) && pl.nc >= rows)
      return launch_any<T, kWideConsumers>(xm, x, out, B, F, D, P, pl,
                                           blocks, tma, vec, keep_self, s);
#endif
    if (!make_plan(F, D, P, esize, kRingConsumers, 2, &pl))
      make_plan(F, D, P, esize, kRingConsumers, 1, &pl);
    return launch_any<T, kRingConsumers>(xm, x, out, B, F, D, P, pl, blocks,
                                         tma, vec, keep_self, s);
  }
}

}  // namespace

extern "C" {

// x: contiguous row-major (B, F, D) fp32; out: (B, P) fp32 with
// P = F * (F - 1) / 2, or F * (F + 1) / 2 with keep_self. tma = 1 takes
// the TMA instance, which needs D % 32 == 0, F <= 256 and x 16-byte
// aligned; tma = 0 the 4-byte cp.async instance (any D, any view). The
// caller (kernels/dot_interaction/ops.py) passes B, D > 0 and a shape
// whose plan with one consumer fits a block's shared memory. Launches on
// `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() after the launch (0 = launched), cudaErrorInvalidValue
// for a refused shape or a TMA call it cannot take, or an encode error.
int dot_interaction_f32(const float* x, float* out, int B, int F, int D,
                        int keep_self, int tma, void* stream) {
  return run(x, out, B, F, D, keep_self, tma ? kTma : kCpAsync, stream);
}

// The same for bf16 x and out (exact products and f32 sums on the bf16
// tensor cores, out rounded once). route: 0 TMA (D % 64 == 0, F <= 256, x
// 16-byte aligned), 1 cp.async (D even, x 4-byte aligned), 2 the
// producer's 2-byte copies (any D, any view); cudaErrorInvalidValue for a
// route the shape or address cannot take.
int dot_interaction_bf16(const __nv_bfloat16* x, __nv_bfloat16* out, int B,
                         int F, int D, int keep_self, int route,
                         void* stream) {
  return run(x, out, B, F, D, keep_self, route, stream);
}

const char* repro_error_string(int e) {
  if (e == ERR_NO_ENCODER)
    return "cuTensorMapEncodeTiled not found through the runtime";
  if (e >= ERR_ENCODE)
    return "cuTensorMapEncodeTiled refused the descriptor (base, stride or "
           "box not aligned)";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
