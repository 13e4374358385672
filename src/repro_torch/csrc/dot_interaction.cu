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
// product and sum in f32, the output rounded to bf16 once. The producer
// warp widens the row to fp32 as it copies it (16-byte loads of 8 bf16
// where D % 8 == 0 and x is 16-byte aligned, else 2-byte loads), stores
// it into the same swizzled fp32 slot and arrives on `full` (count 32)
// after its stores: the consumers run the fp32 pipeline unchanged, so a
// bf16 row's result is the fp32 kernel's on the widened row, rounded. Its
// bound halves x's bytes, and the producer's loads are no longer
// asynchronous (what a 64-column bf16 TMA box, D % 64 == 0, would cure).
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
constexpr int kMaxSmem = 232448;    // a Hopper block's dynamic shared memory
constexpr int kSlotAlign = 1024;    // the 128-byte swizzle's period
constexpr unsigned kFull = 0xffffffffu;

// shared-memory layout of one launch: 2 mbarriers per consumer and the
// staging rows (ceil4(P) floats per consumer), then the slots, each
// 1024-byte aligned: D / 32 (rounded up) chunks of F rows of 128 bytes,
// and 3 rows more that the padding features of the last chunk read
struct Plan {
  int nq, slot_bytes, stage_floats, nc, spw;
  size_t head_bytes, smem;
};

// the plan with up to max_nc consumers of spw slots that fits
bool make_plan(int F, int D, int P, int max_nc, int spw, Plan* p) {
  p->nq = (D + 31) / 32;
  p->slot_bytes =
      ((p->nq * F + 3) * 128 + kSlotAlign - 1) & ~(kSlotAlign - 1);
  p->stage_floats = (P + 3) & ~3;
  p->spw = spw;
  for (p->nc = max_nc; p->nc >= 1; --p->nc) {
    const size_t slots = (size_t)p->nc * spw;
    p->head_bytes = (16 * slots + 4 * (size_t)p->nc * p->stage_floats +
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

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
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

__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// a bf16 (the low 16 bits of w first) widened exactly: its bits are the
// float's top 16
__device__ __forceinline__ float4 widen4(uint32_t w0, uint32_t w1) {
  return make_float4(__uint_as_float(w0 << 16),
                     __uint_as_float(w0 & 0xffff0000u),
                     __uint_as_float(w1 << 16),
                     __uint_as_float(w1 & 0xffff0000u));
}

// the bf16 producer: row `src` widened into `dst` (VEC8: 8 bf16 a load)
__device__ __forceinline__ void widen_row(unsigned char* dst,
                                          const __nv_bfloat16* src, int F,
                                          int D, bool vec8, int lane) {
  if (vec8) {
#pragma unroll 4
    for (int e = lane; e < F * D / 8; e += 32) {
      const int f = (e * 8) / D, d = e * 8 - f * D;
      const uint4 r = *reinterpret_cast<const uint4*>(src + (size_t)e * 8);
      *reinterpret_cast<float4*>(dst + slot_offset(f, d, F)) =
          widen4(r.x, r.y);
      *reinterpret_cast<float4*>(dst + slot_offset(f, d + 4, F)) =
          widen4(r.z, r.w);
    }
  } else {
#pragma unroll 4
    for (int e = lane; e < F * D; e += 32) {
      const int f = e / D, d = e - f * D;
      *reinterpret_cast<float*>(dst + slot_offset(f, d, F)) =
          __bfloat162float(src[e]);
    }
  }
}

template <typename Elem, bool KEEP_SELF, bool TMA, int MAX_NC>
__global__ void __launch_bounds__(32 * (MAX_NC + 1), 1)
    dot_interaction_kernel(const __grid_constant__ CUtensorMap xmap,
                           const Elem* __restrict__ x, Elem* __restrict__ out,
                           int B, int F, int D, int P, Plan pl, int vec8) {
  constexpr bool kBF16 = sizeof(Elem) == 2;
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
      } else if constexpr (kBF16) {
        widen_row(dst, reinterpret_cast<const __nv_bfloat16*>(x) +
                           (size_t)b * F * D, F, D, vec8, lane);
        mbar_arrive(&full[w]);             // every lane: count 32
      } else {
        const float* src = reinterpret_cast<const float*>(x) +
                           (size_t)b * F * D;
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

  float* stage = stages + (size_t)warp * pl.stage_floats;
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
    Elem* ob = out + ((size_t)blockIdx.x + (size_t)k * grid) * P;
    for (int p0 = 0; p0 < P; p0 += 32)
      if (p0 + lane < P) st(ob + p0 + lane, stage[p0 + lane]);
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

// x (B * F rows of D floats) as (32 columns, B * F rows, D / 32 chunks),
// loaded a row of x at a time (box 32 x F x D / 32) with the 128-byte
// swizzle
int encode(CUtensorMap* m, const float* x, int B, int F, int D) {
  EncodeTiledFn fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  cuuint64_t dims[3] = {32, (cuuint64_t)B * F, (cuuint64_t)D / 32};
  cuuint64_t strides[2] = {(cuuint64_t)D * 4, 128};
  cuuint32_t box[3] = {32, (cuuint32_t)F, (cuuint32_t)D / 32};
  cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                  const_cast<float*>(x), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

template <typename T, bool KEEP_SELF, bool TMA, int MAX_NC>
int launch(const CUtensorMap& xm, const T* x, T* out, int B, int F, int D,
           int P, const Plan& pl, int blocks, int vec8, cudaStream_t stream) {
  auto kernel = dot_interaction_kernel<T, KEEP_SELF, TMA, MAX_NC>;
  if (pl.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, 32 * (pl.nc + 1), pl.smem, stream>>>(xm, x, out, B, F, D,
                                                         P, pl, vec8);
  return (int)cudaGetLastError();
}

// the TMA instance for fp32 rows that take it; cp.async (fp32) or the
// widening copy (bf16) otherwise
template <typename T, int MAX_NC>
int launch_any(const CUtensorMap& xm, const T* x, T* out, int B, int F,
               int D, int P, const Plan& pl, int blocks, int tma, int vec8,
               int keep_self, cudaStream_t s) {
  if constexpr (sizeof(T) == 4) {
    if (tma)
      return keep_self ? launch<T, true, true, MAX_NC>(xm, x, out, B, F, D, P,
                                                        pl, blocks, vec8, s)
                       : launch<T, false, true, MAX_NC>(xm, x, out, B, F, D,
                                                         P, pl, blocks, vec8, s);
  }
  return keep_self ? launch<T, true, false, MAX_NC>(xm, x, out, B, F, D, P,
                                                     pl, blocks, vec8, s)
                   : launch<T, false, false, MAX_NC>(xm, x, out, B, F, D, P,
                                                      pl, blocks, vec8, s);
}

template <typename T>
int run(const T* x, T* out, int B, int F, int D, int keep_self, int tma,
        void* stream) {
  const int P = keep_self ? F * (F + 1) / 2 : F * (F - 1) / 2;
  Plan pl;
  if (B <= 0 || D <= 0 || P <= 0 || !make_plan(F, D, P, 1, 1, &pl) ||
      (tma && (sizeof(T) != 4 || D % 32 != 0 || F > 256 ||
               (uintptr_t)x % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap xm;
  memset(&xm, 0, sizeof xm);
  if (tma) {
    const int rc = encode(&xm, reinterpret_cast<const float*>(x), B, F, D);
    if (rc) return rc;
  }
  const int vec8 = D % 8 == 0 && (uintptr_t)x % 16 == 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int blocks = B < sms ? B : sms;
  const int rows = (B + blocks - 1) / blocks;    // rows of a block, at most
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifndef DOT_INTERACTION_RING_ONLY   // a build chip_smoke.py times beside it
  if (rows > kRingConsumers && rows <= kWideConsumers &&
      make_plan(F, D, P, kWideConsumers, 1, &pl) && pl.nc >= rows)
    return launch_any<T, kWideConsumers>(xm, x, out, B, F, D, P, pl, blocks,
                                         tma, vec8, keep_self, s);
#endif
  if (!make_plan(F, D, P, kRingConsumers, 2, &pl))
    make_plan(F, D, P, kRingConsumers, 1, &pl);
  return launch_any<T, kRingConsumers>(xm, x, out, B, F, D, P, pl, blocks,
                                       tma, vec8, keep_self, s);
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
  return run(x, out, B, F, D, keep_self, tma, stream);
}

// The same for bf16 x and out (f32 products and sums, out rounded once):
// the widening copy, any D, any view.
int dot_interaction_bf16(const __nv_bfloat16* x, __nv_bfloat16* out, int B,
                         int F, int D, int keep_self, void* stream) {
  return run(x, out, B, F, D, keep_self, 0, stream);
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
