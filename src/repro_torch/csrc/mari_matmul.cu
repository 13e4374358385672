// Fused MaRI matmul (Eq. 7) for Hopper: TMA-fed wgmma, fp32 accuracy by
// 3xTF32, and a bf16 entry on the same pipeline.
//
//   out = act(u_init + x (B, K) @ w (K, N))
//
// Replaces the TPU Pallas kernels mari_matmul_kernel and
// mari_matmul_kernel_gather (src/repro/kernels/mari_matmul/kernel.py:77,
// :119). The f32 accumulator starts from the user-side partial instead of
// zero, in one of three layouts (runtime `init`):
//   INIT_ROW    u is one (1, N) row broadcast over all B rows (one user);
//   INIT_BLOCK  u is a row-wise (B, N) block (row b carries its own user);
//   INIT_GATHER u is a stacked (U, N) table and row b starts from
//               u[clamp(idx[b], 0, U - 1)]: the gathered (B, N) block is
//               never written to device memory.
// The activation runs on the accumulator registers in the epilogue, so the
// (B, N) pre-activation never round-trips through device memory.
//
// What bounds it on an H100. At the serving path's main shape (B = 4096,
// K = 1064, N = 512, the paper's expert fc0) the product is 2BKN = 4.46
// GFLOP on ~30 MB of operands. On the fp32 SIMT units (67 TFLOP/s) that is
// 0.067 ms of operations, and cuBLAS's SIMT GEMM reaches ~0.1 ms: the only
// way past it is the tensor cores. TF32 alone keeps ~3 decimal digits and
// misses the port's fp32 parity (2e-4), so each operand is split into a
// TF32 "hi" part and a TF32 "lo" remainder and the product is taken as
// lo(x) w_hi + hi(x) w_lo + hi(x) w_hi (3xTF32, the small terms first):
// 3 x 2BKN at 495 TFLOP/s = 0.027 ms, still operation-bound (the bytes
// take 0.009 ms at 3.35 TB/s).
//
// Design (one output tile of BM x BN per block, BM = 64 per consumer
// warpgroup, one or two consumers; BN = 8 / 32 / 64 / 128 from N alone):
//   * The weight is prepared once (kernels/mari_matmul/ops.py,
//     prepare_mari_weight): tf32 wgmma takes B only K-major, so w (K, N)
//     becomes w_hi = tf32(w)^T and w_lo = tf32(w - tf32(w))^T, two (N,
//     K_pad) arrays; their TMA descriptors are encoded once with it. x's
//     descriptor is encoded per call from its pointer and row stride.
//   * One thread of a loader warpgroup issues TMA loads (128-byte
//     swizzle, BK = 32 fp32 = one 128-byte row; 64 bf16) of x, w_hi and
//     w_lo into a ring of stages in dynamic shared memory, with a full and
//     an empty mbarrier per stage. TMA's out-of-bounds zero fill does the
//     ragged K, B and N edges; stores are masked to (B, N). setmaxnreg
//     gives the loader's registers to the consumers.
//   * Each consumer warpgroup issues, per 8-deep k step, the three
//     wgmma.m64nBNk8.f32.tf32.tf32 with A from registers (its 64 x 32 x
//     fragment, read from shared memory un-swizzling the addresses and
//     split into hi / lo by cvt.rna.tf32.f32) into one tile partial; while
//     they run it waits for the next stage and splits that x fragment
//     into a second register set; then it releases the stage.
//   * The tensor cores' f32 accumulation is not round-to-nearest: one
//     chain over all 3K / 8 steps drifted an order of magnitude further
//     from an fp64 oracle than a plain fp32 sum at K = 1064. So each
//     32-deep k tile sums from zero on its own (scale-d = 0 on its first
//     product) and is added to the running fp32 accumulator with ordinary
//     adds: 12 tensor-core steps per chain (chip_smoke.py's
//     mari_matmul_accuracy line holds the result beside cuBLAS's fp32).
//   * bf16: wgmma.m64nBNk16.f32.bf16.bf16 with A and B from shared
//     memory (w prepared as a (N, K_pad) bf16 transpose), one product per
//     k step, f32 accumulator from the f32 u, bf16 output.
// No split-K and no atomics: every tile walks all of K in the same BK
// steps and the same order, and a row's products never depend on the
// other rows of its tile, so a row's result does not depend on B, U, the
// tile size or the bucket it was packed into.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int ROWS_PER_WG = 64;       // wgmma's M
constexpr int ROW_BYTES = 128;        // one swizzled smem row = BK elements
constexpr int KSTEPS = 4;             // 32-byte k steps per 128-byte row
constexpr int MAX_STAGES = 8;

enum Init { INIT_ROW = 0, INIT_BLOCK = 1, INIT_GATHER = 2 };
enum Act {
  ACT_IDENTITY = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3,
  ACT_SIGMOID = 4, ACT_TANH = 5
};
enum DType { DT_F32 = 0, DT_BF16 = 1 };

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

// ---- PTX helpers ----------------------------------------------------------
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

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows with
// the 128-byte swizzle (tile base 1024-byte aligned): leading byte offset
// unused, stride byte offset 1024 (eight rows). A 32-byte k step adds 2.
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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accesses of registers an in-flight wgmma
// reads or writes across the fence / commit / wait
template <int R>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// ---- wgmma, one instance per tile width ------------------------------------
template <int N>
struct Mma;

template <>
struct Mma<8> {
  // D (64 x 8, f32) += A (64 x 8, tf32, registers) * B (8 x 8 in smem)
  static __device__ __forceinline__ void tf32(float* d, const uint32_t* a,
                                              uint64_t desc_b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
  // D (64 x 8, f32) += A (64 x 16, bf16, smem) * B (8 x 16 in smem)
  static __device__ __forceinline__ void bf16(float* d, uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct Mma<32> {
  // D (64 x 32, f32) += A (64 x 8, tf32, registers) * B (32 x 8 in smem)
  static __device__ __forceinline__ void tf32(float* d, const uint32_t* a,
                                              uint64_t desc_b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
  // D (64 x 32, f32) += A (64 x 16, bf16, smem) * B (32 x 16 in smem)
  static __device__ __forceinline__ void bf16(float* d, uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct Mma<64> {
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
  // D (64 x 64, f32) += A (64 x 16, bf16, smem) * B (64 x 16 in smem)
  static __device__ __forceinline__ void bf16(float* d, uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct Mma<128> {
  // D (64 x 128, f32) += A (64 x 8, tf32, registers) * B (128 x 8 in smem)
  static __device__ __forceinline__ void tf32(float* d, const uint32_t* a,
                                              uint64_t desc_b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
  // D (64 x 128, f32) += A (64 x 16, bf16, smem) * B (128 x 16 in smem)
  static __device__ __forceinline__ void bf16(float* d, uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
};

// ---- the kernel ------------------------------------------------------------
struct Args {
  const float* u;        // (1, N), (B, N) or (U, N) f32
  const int* idx;        // (B,) int32, INIT_GATHER only
  void* out;             // (B, N) f32 or bf16
  int B, K, N, U;
  int init, act;
  int nk;                // k tiles of BK
  int stages;            // ring depth
  uint32_t x_bytes;      // one stage's x tile (BM rows of 128 bytes)
  uint32_t stage_bytes;  // x tile + weight tile(s)
};

__device__ __forceinline__ const float* urow(const Args& a, int r) {
  if (r >= a.B) return nullptr;
  if (a.init == INIT_ROW) return a.u;
  if (a.init == INIT_BLOCK) return a.u + (size_t)r * a.N;
  int s = a.idx[r];
  s = s < 0 ? 0 : (s >= a.U ? a.U - 1 : s);
  return a.u + (size_t)s * a.N;
}

// accumulator register 4j + 2h + e holds (row r0 + 8h, col n0 + 8j + 2t + e)
template <int BN, int DT, int ACT>
__device__ __forceinline__ void store_tile(const float* acc, const Args& a,
                                           int r0, int n0, int t) {
  const bool pairs = (a.N & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= a.B) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * t;
      if (c >= a.N) continue;
      const float v0 = activate<ACT>(acc[4 * j + 2 * h]);
      const float v1 = activate<ACT>(acc[4 * j + 2 * h + 1]);
      const size_t o = (size_t)r * a.N + c;
      if (DT == DT_F32) {
        float* out = static_cast<float*>(a.out);
        if (pairs) {
          *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
        } else {
          out[o] = v0;
          if (c + 1 < a.N) out[o + 1] = v1;
        }
      } else {
        __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(out + o) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          out[o] = __float2bfloat16(v0);
          if (c + 1 < a.N) out[o + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// The x fragment of one k tile for rows rl, rl + 8 of the block tile, split
// into tf32 hi / lo. k step kk holds (rl, 8kk + t), (rl + 8, 8kk + t),
// (rl, 8kk + 4 + t), (rl + 8, 8kk + 4 + t); the 128-byte swizzle XORs the
// 16-byte chunk index with the row's index mod 8, which is g here.
__device__ __forceinline__ void load_split(const uint8_t* st, int rl, int g,
                                           int t, uint32_t (&hi)[KSTEPS][4],
                                           uint32_t (&lo)[KSTEPS][4]) {
  const float* xs = reinterpret_cast<const float*>(st);
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c0 = (((2 * kk) ^ g) << 2) + t;
    const int c1 = (((2 * kk + 1) ^ g) << 2) + t;
    const float v[4] = {xs[rl * 32 + c0], xs[(rl + 8) * 32 + c0],
                        xs[rl * 32 + c1], xs[(rl + 8) * 32 + c1]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hi[kk][i] = tf32_rna(v[i]);
      lo[kk][i] = tf32_rna(v[i] - __uint_as_float(hi[kk][i]));
    }
  }
}

// One fp32 k tile: lo(x) w_hi, hi(x) w_lo, hi(x) w_hi per 8-deep k step
// into `part`; while they run, wait for the next tile and split its x
// fragment into (nhi, nlo); then release the stage and add `part` to acc.
template <int BN>
__device__ __forceinline__ void tf32_step(
    const Args& a, const uint8_t* smem, int kt, int rl, int g, int t,
    const uint32_t (&hi)[KSTEPS][4], const uint32_t (&lo)[KSTEPS][4],
    uint32_t (&nhi)[KSTEPS][4], uint32_t (&nlo)[KSTEPS][4], float* acc,
    float* part, uint64_t* full_bar, uint64_t* empty_bar) {
  constexpr int R = BN / 2;
  const int s = kt % a.stages;
  const uint8_t* st = smem + (size_t)s * a.stage_bytes;
  const uint64_t dhi = smem_desc(st + a.x_bytes);
  const uint64_t dlo = smem_desc(st + a.x_bytes + BN * ROW_BYTES);
  fence_regs<R>(part);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    Mma<BN>::tf32(part, lo[kk], dhi + 2 * kk, kk > 0);
    Mma<BN>::tf32(part, hi[kk], dlo + 2 * kk, 1);
    Mma<BN>::tf32(part, hi[kk], dhi + 2 * kk, 1);
  }
  wgmma_commit();
  if (kt + 1 < a.nk) {
    const int s1 = (kt + 1) % a.stages;
    mbar_wait(&full_bar[s1], ((kt + 1) / a.stages) & 1);
    load_split(smem + (size_t)s1 * a.stage_bytes, rl, g, t, nhi, nlo);
  }
  wgmma_wait_all();
  fence_regs<R>(part);
  if (threadIdx.x % 128 == 0) mbar_arrive(&empty_bar[s]);
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] += part[i];
}

// One (BM = 64 * consumers) x BN output tile per block: warpgroups 0 ..
// consumers - 1 compute, the last warpgroup loads (one thread issues TMA).
// setmaxnreg moves registers from the loader to the consumers, which hold
// the accumulator, the tile partial and two x fragments.
template <int BN, int DT>
__global__ void __launch_bounds__(3 * 128, 1)
mari_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap whimap,
                  const __grid_constant__ CUtensorMap wlomap,
                  const Args a) {
  constexpr int R = BN / 2;                        // accumulators per thread
  constexpr bool F32 = DT == DT_F32;
  constexpr int BK = F32 ? 32 : 64;                // elements per 128 bytes
  constexpr uint32_t W_BYTES = BN * ROW_BYTES;
  __shared__ __align__(8) uint64_t full_bar[MAX_STAGES];
  __shared__ __align__(8) uint64_t empty_bar[MAX_STAGES];
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int nc = blockDim.x / 128 - 1;
  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.y * nc * ROWS_PER_WG;
  const int n0 = blockIdx.x * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], nc);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == nc) {                                  // loader warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x % 128 == 0) {
      for (int kt = 0; kt < a.nk; ++kt) {
        const int s = kt % a.stages;
        if (kt >= a.stages)
          mbar_wait(&empty_bar[s], ((kt / a.stages) - 1) & 1);
        uint8_t* st = smem + (size_t)s * a.stage_bytes;
        mbar_expect_tx(&full_bar[s], a.stage_bytes);
        tma_load_2d(st, &xmap, &full_bar[s], kt * BK, m0);
        tma_load_2d(st + a.x_bytes, &whimap, &full_bar[s], kt * BK, n0);
        if (F32)
          tma_load_2d(st + a.x_bytes + W_BYTES, &wlomap, &full_bar[s],
                      kt * BK, n0);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x % 32;
    const int warp = (threadIdx.x % 128) / 32;
    const int g = lane >> 2, t = lane & 3;
    const int rl = wg * ROWS_PER_WG + warp * 16 + g;  // tile rows rl, rl + 8
    const int r0 = m0 + rl;

    float acc[R];
    {
      const float* u0 = urow(a, r0);
      const float* u1 = urow(a, r0 + 8);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = n0 + 8 * j + 2 * t;
        acc[4 * j + 0] = (u0 && c < a.N) ? u0[c] : 0.f;
        acc[4 * j + 1] = (u0 && c + 1 < a.N) ? u0[c + 1] : 0.f;
        acc[4 * j + 2] = (u1 && c < a.N) ? u1[c] : 0.f;
        acc[4 * j + 3] = (u1 && c + 1 < a.N) ? u1[c + 1] : 0.f;
      }
    }

    // each k tile sums into `part` from zero (scale-d = 0 on its first
    // product) and is added to `acc` with ordinary fp32 adds
    float part[R];
#pragma unroll
    for (int i = 0; i < R; ++i) part[i] = 0.f;
    if constexpr (F32) {
      // two register sets for the x fragment: the next tile's is loaded and
      // split while the tensor cores work on this one's
      uint32_t hA[KSTEPS][4], lA[KSTEPS][4], hB[KSTEPS][4], lB[KSTEPS][4];
      if (a.nk > 0) {
        mbar_wait(&full_bar[0], 0);
        load_split(smem, rl, g, t, hA, lA);
      }
      for (int kt = 0; kt < a.nk; kt += 2) {
        tf32_step<BN>(a, smem, kt, rl, g, t, hA, lA, hB, lB, acc, part,
                      full_bar, empty_bar);
        if (kt + 1 < a.nk)
          tf32_step<BN>(a, smem, kt + 1, rl, g, t, hB, lB, hA, lA, acc, part,
                        full_bar, empty_bar);
      }
    } else {
      for (int kt = 0; kt < a.nk; ++kt) {
        const int s = kt % a.stages;
        mbar_wait(&full_bar[s], (kt / a.stages) & 1);
        const uint8_t* st = smem + (size_t)s * a.stage_bytes;
        const uint64_t da = smem_desc(st + wg * ROWS_PER_WG * ROW_BYTES);
        const uint64_t db = smem_desc(st + a.x_bytes);
        fence_regs<R>(part);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          Mma<BN>::bf16(part, da + 2 * kk, db + 2 * kk, kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<R>(part);
        if (threadIdx.x % 128 == 0) mbar_arrive(&empty_bar[s]);
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i] += part[i];
      }
    }

    switch (a.act) {
      case ACT_RELU: store_tile<BN, DT, ACT_RELU>(acc, a, r0, n0, t); break;
      case ACT_GELU: store_tile<BN, DT, ACT_GELU>(acc, a, r0, n0, t); break;
      case ACT_SILU: store_tile<BN, DT, ACT_SILU>(acc, a, r0, n0, t); break;
      case ACT_SIGMOID:
        store_tile<BN, DT, ACT_SIGMOID>(acc, a, r0, n0, t);
        break;
      case ACT_TANH: store_tile<BN, DT, ACT_TANH>(acc, a, r0, n0, t); break;
      default: store_tile<BN, DT, ACT_IDENTITY>(acc, a, r0, n0, t); break;
    }
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
constexpr int ERR_ARGS = 1;           // cudaErrorInvalidValue

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

// a 2-D row-major (outer, inner) tensor with a row stride of ld elements,
// loaded as (box_outer, box_inner) tiles with the 128-byte swizzle; reads
// outside the tensor fill with zeros
int encode(CUtensorMap* m, int dtype, const void* base, uint64_t inner,
           uint64_t outer, uint64_t ld, uint32_t box_inner,
           uint32_t box_outer) {
  EncodeTiledFn fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const uint64_t es = dtype == DT_F32 ? 4 : 2;
  cuuint64_t dims[2] = {inner, outer};
  cuuint64_t strides[1] = {ld * es};
  cuuint32_t box[2] = {box_inner, box_outer};
  cuuint32_t estr[2] = {1, 1};
  CUresult r = fn(m, dtype == DT_F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  2, const_cast<void*>(base), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

template <int BN, int DT>
int launch(const CUtensorMap& xm, const CUtensorMap& hm, const CUtensorMap& lm,
           const Args& a, int nc, cudaStream_t stream) {
  const size_t smem = (size_t)a.stages * a.stage_bytes + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      mari_wgmma_kernel<BN, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.N + BN - 1) / BN,
                  (a.B + nc * ROWS_PER_WG - 1) / (nc * ROWS_PER_WG));
  mari_wgmma_kernel<BN, DT><<<grid, (nc + 1) * 128, smem, stream>>>(xm, hm,
                                                                    lm, a);
  return (int)cudaGetLastError();
}

template <int DT>
int run(const void* x, long long ldx, const void* wmaps, const float* u,
        const int* idx, void* out, int B, int K, int N, int U, int init,
        int act, int bm, int bn, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (init < INIT_ROW || init > INIT_GATHER || act < ACT_IDENTITY ||
      act > ACT_TANH || (bm != 64 && bm != 128) || K < 0 || ldx < K)
    return ERR_ARGS;
  constexpr int BK = DT == DT_F32 ? 32 : 64;
  const int nc = bm / ROWS_PER_WG;
  Args a;
  a.u = u; a.idx = idx; a.out = out;
  a.B = B; a.K = K; a.N = N; a.U = U; a.init = init; a.act = act;
  a.nk = (K + BK - 1) / BK;
  a.x_bytes = (uint32_t)bm * ROW_BYTES;
  a.stage_bytes =
      a.x_bytes + (uint32_t)bn * ROW_BYTES * (DT == DT_F32 ? 2 : 1);
  // as deep a ring as ~200 KB of shared memory holds (one block per SM)
  int stages = (200 * 1024) / (int)a.stage_bytes;
  a.stages = stages < 2 ? 2 : (stages > MAX_STAGES ? MAX_STAGES : stages);

  CUtensorMap xm, hm, lm;
  memset(&xm, 0, sizeof xm);
  if (a.nk > 0) {
    const int rc = encode(&xm, DT, x, (uint64_t)K, (uint64_t)B,
                          (uint64_t)ldx, BK, (uint32_t)bm);
    if (rc) return rc;
  }
  memcpy(&hm, wmaps, sizeof hm);
  memcpy(&lm, static_cast<const char*>(wmaps) + (DT == DT_F32 ? sizeof hm : 0),
         sizeof lm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 8: return launch<8, DT>(xm, hm, lm, a, nc, s);
    case 32: return launch<32, DT>(xm, hm, lm, a, nc, s);
    case 64: return launch<64, DT>(xm, hm, lm, a, nc, s);
    case 128: return launch<128, DT>(xm, hm, lm, a, nc, s);
    default: return ERR_ARGS;
  }
}

}  // namespace

extern "C" {

// Encode the TMA descriptor of a row-major (outer, inner) fp32 (dtype 0) or
// bf16 (dtype 1) tensor with a row stride of ld elements, box (box_outer,
// box_inner), into the 128 bytes at `out`. Returns 0 or an error code.
int mari_encode_map(void* out, const void* base, int dtype, long long inner,
                    long long outer, long long ld, int box_inner,
                    int box_outer) {
  CUtensorMap m;
  const int rc = encode(&m, dtype, base, (uint64_t)inner, (uint64_t)outer,
                        (uint64_t)ld, (uint32_t)box_inner,
                        (uint32_t)box_outer);
  if (rc == 0) memcpy(out, &m, sizeof m);
  return rc;
}

// fp32 operands through 3xTF32. x: (B, K) fp32 with row stride ldx (16-byte
// aligned base and stride); wmaps: the descriptors of w_hi and w_lo ((N,
// K_pad), box (bn, 32)), 128 bytes each; u f32; idx int32 (INIT_GATHER
// only, else may be null); out (B, N) fp32. bm is 64 or 128, bn 8 / 32 /
// 64 / 128. Launches on `stream`, allocates nothing, does not synchronise.
// Returns 0 when launched, else a cudaError_t or an encode error code.
int mari_matmul_f32(const float* x, long long ldx, const void* wmaps,
                    const float* u, const int* idx, float* out, int B, int K,
                    int N, int U, int init, int act, int bm, int bn,
                    void* stream) {
  return run<DT_F32>(x, ldx, wmaps, u, idx, out, B, K, N, U, init, act, bm,
                     bn, stream);
}

// bf16 operands (wmaps: the descriptor of the (N, K_pad) bf16 transpose of
// w, box (bn, 64)), f32 accumulator from the f32 u, bf16 out.
int mari_matmul_bf16(const void* x, long long ldx, const void* wmaps,
                     const float* u, const int* idx, void* out, int B, int K,
                     int N, int U, int init, int act, int bm, int bn,
                     void* stream) {
  return run<DT_BF16>(x, ldx, wmaps, u, idx, out, B, K, N, U, init, act, bm,
                      bn, stream);
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
