// Gather-aware einsum for Hopper, fp32 and bf16:
// einsum(spec, x, table[clamp(idx)])
// with the per-row gather folded into the operand load.
//
// Replaces the TPU Pallas kernel gather_einsum_kernel
// (src/repro/kernels/gather_einsum/kernel.py:79). Three specs, the
// decomposed DIN attention contractions:
//   SPEC_Q_T      "bd,uldh->blh"  q (B,D) against T (U,L,D,H)  -> (B,L,H)
//   SPEC_W_KEYS   "bl,uld->bd"    weights (B,L) against keys (U,L,D) -> (B,D)
//   SPEC_ROWS_VEC "blh,uh->bl"    x (B,L,H) against a vector table (U,H)
// Every row clamps its own index to [0, U-1] and reads that user's table
// row: the gathered (B, ...) operand (for SPEC_Q_T a (B, L, D, H) block)
// never exists in device memory.
//
// What bounds it on an H100. SPEC_Q_T writes (B, L, H) floats at 2*D = 36
// FLOP each. At DIN width (B = 4096, U = 8, L = 100, D = 18, H = 80) the
// output is 131 MB, 0.0406 ms at 3.35 TB/s, and the arithmetic 1.18 GFLOP,
// 0.018 ms at 67 TFLOP/s fp32: bound by the bytes it writes. So the fp32
// FMAs stay exact fp32 on the CUDA cores; tensor cores would buy nothing
// against the store stream. SPEC_W_KEYS reads (B, L), writes (B, D) and
// does 2 * B * L * D = 15 MFLOP: its bound (0.0006 ms) is below a launch's
// latency, so it is bound by the latency of its loads and sums.
// SPEC_ROWS_VEC reads x once (131 MB at DIN width): bound by that stream.
//
// SPEC_Q_T's design: what must not happen is each row reading its user's
// whole (L, D, H) slice (576 KB at DIN width) on its own. A block owns 64
// consecutive rows and 8 tiles of 64 columns of L*H. It numbers the
// distinct users of its rows once (warp match and ballots). A lane owns 2
// columns, keeps a user's (20 d x 2) slice in registers and reads each
// row's x as 16-byte shared-memory broadcasts; when a warp's 8 rows share
// one user they run unbranched, otherwise the slice is reloaded where the
// user changes. Where the tile's rows hold at most 8 users (the engine's
// runs at its default of 8 users a pack, any order over 8 slots), the
// block orders its rows by user, stably (the engine's runs are already in
// order and skip it), so a warp's 8 rows share one or two users in any
// index order, and walks steps, each copied to shared memory by
// cp.async one step ahead of the step being computed (two buffers, 90
// KB): a step holds the (20 d x 64 column) slices of T of all the tile's
// users and the rows' x for the same d; with D <= 20 (DIN) a step covers
// as many column tiles as 8 slices allow (up to 4), so the engine's runs
// take two steps a block. So each user's slice is read once per row
// tile, whatever the order of the rows. Where the rows hold more users
// (a random order over the device tier's 64 slots, packs of short runs),
// a slice would serve a row or two of the tile, and staging 8 users at a
// time measured slower than reading from L2: each warp reads its users'
// slices straight from L2 into registers, once per run of one user among
// its 8 rows. Those rows keep their order: ordered by user they measured
// twice as slow in a random order over 64 slots. Each
// output is summed over d = 0..D-1 in that order by one thread (fmaf from
// 0; the zero padding of the last chunk adds exact zeros) on either
// route, so a row's result does not depend on B, U, the tile it lands in
// or its neighbours' users. Lanes pair up through one shuffle so that
// every store is 16 bytes where L*H is a multiple of 4 (scalar stores
// guard the ragged edges).
//
// SPEC_W_KEYS: one warp per row, for latency: lane j sums the keys l = j,
// j + 32, ... of its row's user (each a contiguous row of D values, so the
// warp's loads are coalesced), weighted by the row's weights, into 32
// columns in registers; then a reduce-scatter of shuffles in a fixed tree
// leaves column d's sum in lane d. The order over l is fixed (per lane,
// then the tree), whatever B. Each chunk of 32 keys and their weights is
// copied to shared memory by cp.async (16 bytes where the chunk is one
// aligned run, else 8 or 4, else value by value), one chunk ahead of the
// one summed.
//
// SPEC_ROWS_VEC: a row (b, l) is H contiguous values. A warp walks a
// contiguous range of rows, four at a time: 8 lanes a row, each taking
// chunks of 8 values (16-byte loads: two in fp32, one in bf16) c = j, j +
// 8, ...; a warp step issues the loads of two such passes (four in bf16,
// the same bytes in flight) before it sums them. Lane j sums its chunks
// in order (fmaf from 0, zeros past H), then a fixed tree of three
// shuffles adds the 8 lanes' partials: the order depends on H alone, not
// on B, the grid or the route. Up to H = 128 a
// lane keeps its chunks of the user's table row in registers and reloads
// them only where b changes (every L rows); past that it reads them per
// row (from L1). H or a pointer off 16 bytes takes value-by-value loads
// in the same order.
//
// bf16 (gather_einsum_bf16): x, table and out in bf16, every product and
// sum in f32 (the TPU kernel's preferred_element_type), the output rounded
// once. SPEC_W_KEYS and SPEC_ROWS_VEC are the fp32 kernels instantiated for
// bf16: operands are read (and staged) as bf16 and widened where the FMA
// reads them, the arithmetic and its order the fp32 kernel's, so a bf16
// call gives the fp32 kernel's result on the widened operands, rounded.
// SPEC_Q_T's bf16 entry runs on the bf16 tensor cores (q_t_mma_kernel):
// its bf16 bound is the 65.5 MB it writes (0.0196 ms), which the CUDA
// cores' 590 M exact fp32 FMAs (0.018 ms at their peak; q_t_kernel issues
// them at about a fifth of it) cannot come near. mma.sync m16n8k16 +
// m16n8k8 with D padded by zeros to 24 a chunk: A (m16) is 16 columns of
// the user's staged (d, column) slice, read by ldmatrix.trans; B (n8) is
// the warp's 8 rows of x (d contiguous). Products are exact and sums f32, in the mma's
// order, so the result is no longer bit for bit the widened fp32 kernel's.
// Where a warp's 8 rows hold several users, one pass per user feeds every
// row's current sums as C and keeps the rows of that user; so each (row,
// column) sees the same mma sequence (k16 then k8 per chunk, from zero) on
// both routes: the staged one (slices copied as bf16 by cp.async, rows
// ordered by user as above) and the one for more than 8 users a tile,
// where each warp copies its users' slices from L2 into its own staging.
// The C fragments go through shared memory so that stores are 16 bytes
// along L*H.
//
// SPEC_Q_T in fp32 past D = 40 (gather_einsum_q_t_tc_f32, the wrapper's
// route there). Each output's 2 D FLOP on the CUDA cores (67 TFLOP/s)
// outgrow its 4-byte store (3.35 TB/s) past D = 40: at DIN's public D =
// 128 (B = 4096, U = 8, L = 100, H = 80) the 8.39 GFLOP take 0.125 ms
// there, and q_t_kernel reached about a tenth of that rate. On the tensor
// cores in 3xTF32 the bound is 0.051 ms by operations (3 x 8.39 GFLOP at
// 495 TFLOP/s), level with the bytes' 0.0495. The design:
//   * Rows grouped by user across the whole batch: a stable counting sort
//     of the clamped index on the card (ge_sort_hist / _scan / _scatter:
//     per-tile counts, their scan, a ranked scatter, as embedding_bag's CSR
//     preparation), then row tiles of up to TC_WG x nr rows of one user.
//     Each user's T slice is read once per row tile, whatever the order.
//   * Swap-AB: tf32 wgmma reads B only K-major, and T (U, L, D, H) has H
//     innermost, so T is A: 64 columns (l, h) of L*H by an 8-deep d step,
//     staged (d, column) by cp.async TC_STAGES - 1 k tiles ahead, read into
//     registers and split into tf32 hi / lo there (mari_matmul's A); B is
//     the tile's x rows (d innermost: K-major), split into hi / lo once a
//     block into shared memory with the 128-byte swizzle; N = nr rows (64
//     at D <= 128, fewer for wider D, zero rows past the user's). Two
//     warpgroups a block share each staged A tile, each with its own nr
//     rows; one warpgroup's next fragment is loaded while its products run.
//   * The sum over d in a fixed order: each 32-deep k tile sums from zero
//     on the tensor cores (lo*hi, hi*lo, hi*hi a step) and is added to the
//     fp32 sum with ordinary adds, mari_matmul's rule. The order depends on
//     D alone: a row's bits depend neither on B, nor on the rows' order,
//     nor on its neighbours (a deliberate divergence from the CUDA-core
//     order, held within 2e-4 of the plain version).
//   * The accumulator (columns x rows) is staged transposed in shared
//     memory and each row's 64 columns stored at the row's own place in
//     16-byte stores, while the next column tile's first products run.
// The workspace (gather_einsum_q_t_work_bytes: counts, row tiles,
// permutation) is the wrapper's. Past D = 1024 (x's rows no longer fit)
// and up to D = 40 q_t_kernel keeps SPEC_Q_T.
//
// Every other spec parse_spec accepts (the TPU kernel runs any
// "b...,u...->b..." spec through one jnp.einsum on the gathered tile) takes
// the generic route (gather_einsum_generic_f32 / _bf16): a plan that
// kernels/gather_einsum/ops.py's generic_plan works out from the spec and
// the shapes arrives by value (GePlan: at most GE_MAX_DIMS output dims and
// as many summed ones, adjacent dims merged where they stay contiguous on
// every operand, a dim absent from an operand at stride 0 there). One
// thread an output element (b, ...): it clamps its row's index, walks the
// summed index space in row-major order of the plan's summed dims (the
// last one innermost) and sums x * table in f32 with fmaf from 0, so its
// bits depend on neither B nor its neighbours' users; bf16 reads bf16, the
// same arithmetic, and rounds once (bit for bit the fp32 route on the
// widened operands). No model forms such a spec (the TPU kernel's tests
// alone do): a simple kernel, right first; what bounds it is the spec's
// bytes or operations (chip_smoke.py times it beside its plain version).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

// the generic route's plan, mirrored by kernels/gather_einsum/ops.py's
// GePlan (ctypes): strides in elements; out dims in the output's order,
// summed dims in the order the sum walks them (the last innermost). At
// namespace scope: an extern "C" entry takes it
constexpr int GE_MAX_DIMS = 8;

struct GePlan {
  int n_out, n_sum;
  long long x_row, t_row, out_row, out_count, sum_count;
  long long out_size[GE_MAX_DIMS], out_x[GE_MAX_DIMS], out_t[GE_MAX_DIMS],
      out_o[GE_MAX_DIMS];
  long long sum_size[GE_MAX_DIMS], sum_x[GE_MAX_DIMS], sum_t[GE_MAX_DIMS];
};

namespace {

using bf16 = __nv_bfloat16;

enum Spec { SPEC_Q_T = 0, SPEC_W_KEYS = 1, SPEC_ROWS_VEC = 2 };
constexpr int THREADS = 256;
constexpr int MAX_GRID_Y = 65535;
constexpr unsigned FULL = 0xffffffffu;

// SPEC_Q_T tiling
constexpr int QT_RPW = 8;                       // rows a warp
constexpr int QT_ROWS = THREADS / 32 * QT_RPW;  // 64 rows a block
constexpr int QT_COLS = 64;                     // columns a tile, 2 a lane
constexpr int QT_TILES = 8;                     // column tiles per block
constexpr int QT_KC = 20;                       // d per staged chunk
constexpr int QT_SLOTS = 8;                     // users staged at once

// SPEC_Q_T bf16 on the tensor cores: d per chunk (one k16 and one k8 mma),
// the row strides of a staged slice (d rows of 64 columns), of the staged x
// and of a warp's output staging, in bf16 (8 past 64: the 8 rows an
// ldmatrix reads fall in distinct banks)
constexpr int QM_KC = 24;
constexpr int QM_TS = QT_COLS + 8;
constexpr int QM_XS = QM_KC;
constexpr int QM_OS = QT_COLS + 8;
constexpr int QM_SLICE = QM_KC * QM_TS;
constexpr int QM_BUF = QT_SLOTS * QM_SLICE + QT_ROWS * QM_XS;

// a variant without the row sort of tiles of at most QT_SLOTS users, built
// with -DGATHER_EINSUM_NO_ROW_SORT only for chip_smoke.py to time beside
// the default
#ifdef GATHER_EINSUM_NO_ROW_SORT
constexpr bool kRowSort = false;
#else
constexpr bool kRowSort = true;
#endif

constexpr int WK_D = 32;                        // SPEC_W_KEYS: d per pass
constexpr int WK_WARPS = 4;                     // SPEC_W_KEYS: rows a block

constexpr int RV_G = 8;                         // SPEC_ROWS_VEC: lanes a row
constexpr int RV_V = 8;                         // values a chunk
constexpr int RV_NC = 2;                        // chunks a lane keeps

__device__ __forceinline__ int clamp_slot(int s, int U) {
  return s < 0 ? 0 : (s >= U ? U - 1 : s);
}

// N bytes from global to shared memory, asynchronously (both aligned to N);
// 16 bytes bypass L1 unless kL1
template <int N, bool kL1 = false>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (N == 16 && !kL1)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// loads of an operand, widened to fp32: 1 value, 2 or 4 consecutive fp32
// values (aligned to their size)
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ bf16 bf16_zero() { return __float2bfloat16_rn(0.f); }

// a copy of one value into shared memory, as it is: asynchronously, but a
// bf16 (2 bytes, below cp.async's 4) by the thread itself
__device__ __forceinline__ void stage1(float* dst, const float* src) {
  cp_async<4>(dst, src);
}
__device__ __forceinline__ void stage1(bf16* dst, const bf16* src) {
  *dst = *src;
}

// n consecutive values from src to dst (16-byte aligned shared memory) by
// the lanes of a warp, asynchronously and through L1 (the warps of a block
// often read one user's keys): 16 bytes at once where src and n allow,
// else 8, else 4, else value by value
template <typename T>
__device__ __forceinline__ void warp_stage_run(T* dst, const T* src, int n,
                                               int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const int bytes = n * (int)sizeof(T);
  if (bytes % 16 == 0 && a % 16 == 0) {
    for (int i = lane; i < bytes / 16; i += 32)
      cp_async<16, true>(reinterpret_cast<char*>(dst) + 16 * i,
                         reinterpret_cast<const char*>(src) + 16 * i);
  } else if (bytes % 8 == 0 && a % 8 == 0) {
    for (int i = lane; i < bytes / 8; i += 32)
      cp_async<8>(reinterpret_cast<char*>(dst) + 8 * i,
                  reinterpret_cast<const char*>(src) + 8 * i);
  } else if (bytes % 4 == 0 && a % 4 == 0) {
    for (int i = lane; i < bytes / 4; i += 32)
      cp_async<4>(reinterpret_cast<char*>(dst) + 4 * i,
                  reinterpret_cast<const char*>(src) + 4 * i);
  } else {
    for (int i = lane; i < n; i += 32) stage1(dst + i, src + i);
  }
}

// stores of an output: fp32 as it is, bf16 rounded once
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// ---- SPEC_Q_T: the rows of a block and their users ------------------------

// Numbers the distinct users of the block's rows in row order (sUser), each
// row's user as that ordinal (sOrd, -1 past B), and with at most QT_SLOTS
// users orders the rows by ordinal, stably (sPerm: position -> row; the
// engine's runs are in order already and keep it); returns the number of
// distinct users. A warp per 32 rows finds each row's first row of its
// user (match within its 32, then a scan of the rows before them), ballots
// count the firsts.
__device__ __forceinline__ int qt_users(const int* __restrict__ idx, int row0,
                                        int nrows, int U, int* sIdx,
                                        int* sOrd, int* sUser, int* sFirsts,
                                        int* sPerm) {
  constexpr int kGroups = QT_ROWS / 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid < QT_ROWS)
    sIdx[tid] = tid < nrows ? clamp_slot(idx[row0 + tid], U) : -1;
  __syncthreads();
  int u = -1, first_row = -1;
  unsigned firsts = 0;
  if (warp < kGroups) {
    const int row = warp * 32 + lane;
    u = sIdx[row];
    first_row = warp * 32 + __ffs(__match_any_sync(FULL, u)) - 1;
    for (int j = 0; j < warp * 32; ++j)
      if (sIdx[j] == u) {
        first_row = j;
        break;
      }
    firsts = __ballot_sync(FULL, u >= 0 && first_row == row);
    if (lane == 0) sFirsts[warp] = __popc(firsts);
  }
  __syncthreads();
  if (warp < kGroups && u >= 0 && first_row == warp * 32 + lane) {
    int o = __popc(firsts & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) o += sFirsts[w];
    sOrd[first_row] = o;
    sUser[o] = u;
  }
  __syncthreads();
  if (warp < kGroups && (u < 0 || first_row != warp * 32 + lane))
    sOrd[warp * 32 + lane] = u >= 0 ? sOrd[first_row] : -1;
  int distinct = 0;
#pragma unroll
  for (int w = 0; w < kGroups; ++w) distinct += sFirsts[w];
  __syncthreads();
  // with at most QT_SLOTS users, the rows ordered by their user's ordinal,
  // stably (the engine's runs keep their order): a warp's 8 rows then
  // share one or two users in any index order; rows past B keep their
  // places at the end
  const bool sorted = __syncthreads_and(
      tid == 0 || tid >= nrows || tid >= QT_ROWS || sOrd[tid - 1] <= sOrd[tid]);
  if (tid < QT_ROWS) {
    const int o = sOrd[tid];
    int pos = tid;
    if (o >= 0 && !sorted && kRowSort && distinct <= QT_SLOTS) {
      pos = 0;
      for (int r = 0; r < nrows; ++r) {
        const int orr = sOrd[r];
        pos += orr < o || (orr == o && r < tid);
      }
    }
    sPerm[pos] = tid;
  }
  __syncthreads();
  return distinct;
}

// ---- SPEC_Q_T fp32 on the CUDA cores ---------------------------------------

// one staged step of SPEC_Q_T: T[user, l(e), d, h(e)] of the tile's nk
// users for QT_KC values of d and ntc tiles of QT_COLS columns (slot
// tc * nk + k),
// and the rows' x for the same d, copied asynchronously (4 values at once
// where H is a multiple of 4, so that a quad of columns lies in one l;
// zeros past D and L*H)
__device__ __forceinline__ void qt_stage(
    float* sT, float* sX, const float* __restrict__ x,
    const float* __restrict__ t, const int* sUser, int row0, int nrows,
    int e0, int ntc, int nk, int d0, int D, int H, int LH, int vec_t) {
  for (int i = threadIdx.x; i < ntc * nk * QT_KC * (QT_COLS / 4);
       i += THREADS) {
    const int q = i % (QT_COLS / 4), rest = i / (QT_COLS / 4);
    const int dd = rest % QT_KC, slot = rest / QT_KC;
    const int tc = slot / nk, k = slot - tc * nk;
    const int d = d0 + dd, e = e0 + tc * QT_COLS + 4 * q;
    float* dst = sT + (slot * QT_KC + dd) * QT_COLS + 4 * q;
    const float* tu = t + (size_t)sUser[k] * LH * D;
    if (vec_t && d < D && e < LH) {
      const int l = e / H, h = e - l * H;
      cp_async<16>(dst, tu + ((size_t)l * D + d) * H + h);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int l = (e + j) / H, h = e + j - l * H;
        if (d < D && e + j < LH)
          stage1(dst + j, tu + ((size_t)l * D + d) * H + h);
        else
          dst[j] = 0.f;
      }
    }
  }
  for (int i = threadIdx.x; i < QT_ROWS * QT_KC; i += THREADS) {
    const int r = i / QT_KC, dd = i - r * QT_KC;
    if (r < nrows && d0 + dd < D)
      stage1(sX + i, x + (size_t)(row0 + r) * D + d0 + dd);
    else
      sX[i] = 0.f;
  }
}

// acc (a row's 2 columns) += x row (QT_KC values) times a lane's (QT_KC x
// 2) slice of T, d in order
__device__ __forceinline__ void qt_fma_row(float* acc, const float* xr,
                                           const float2* tv) {
#pragma unroll
  for (int dd = 0; dd < QT_KC; dd += 4) {
    const float4 xv = ld4(xr + dd);
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[0] = fmaf(xs[j], tv[dd + j].x, acc[0]);
      acc[1] = fmaf(xs[j], tv[dd + j].y, acc[1]);
    }
  }
}

// a lane's (QT_KC x 2) slice of T from global memory (L2): columns e, e + 1
// for d0 .. d0 + QT_KC - 1, zeros past D and L*H (2 values at once where H
// is a multiple of 4, so that both columns lie in one l)
__device__ __forceinline__ void qt_load(float2* tv, const float* tu, int e,
                                        int d0, int D, int H, int LH,
                                        int vec_t) {
  const int l0 = e / H, h0 = e - l0 * H;
  const int l1 = (e + 1) / H, h1 = e + 1 - l1 * H;
#pragma unroll
  for (int dd = 0; dd < QT_KC; ++dd) {
    const int d = d0 + dd;
    float2 v = make_float2(0.f, 0.f);
    if (d < D && vec_t && e < LH) {
      v = ld2(tu + ((size_t)l0 * D + d) * H + h0);
    } else if (d < D) {
      if (e < LH) v.x = ld(tu + ((size_t)l0 * D + d) * H + h0);
      if (e + 1 < LH) v.y = ld(tu + ((size_t)l1 * D + d) * H + h1);
    }
    tv[dd] = v;
  }
}

// a warp's 8 rows of one column tile from column c, then acc zeroed: lanes
// 2m / 2m+1 swap halves so each writes 4 columns of one row (the even lane
// the warp's row i, the odd lane row i + 1), 16 bytes where aligned
__device__ __forceinline__ void qt_store(float (*acc)[2], const int* rows,
                                         int nrows, float* out, int LH, int c,
                                         bool vec_out, int lane) {
  const bool odd = lane & 1;
  const int c0 = c + 4 * (lane >> 1);
#pragma unroll
  for (int i = 0; i < QT_RPW; i += 2) {
    const float sx = odd ? acc[i][0] : acc[i + 1][0];
    const float sy = odd ? acc[i][1] : acc[i + 1][1];
    const float gx = __shfl_xor_sync(FULL, sx, 1);
    const float gy = __shfl_xor_sync(FULL, sy, 1);
    const float4 v = odd ? make_float4(gx, gy, acc[i + 1][0], acc[i + 1][1])
                         : make_float4(acc[i][0], acc[i][1], gx, gy);
    const int r = odd ? rows[i + 1] : rows[i];
    if (r < nrows) {
      float* o = out + (size_t)r * LH + c0;
      if (vec_out && c0 + 3 < LH) {
        st4(o, v);
      } else {
        const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < LH) st(o + j, vs[j]);
      }
    }
    acc[i][0] = acc[i][1] = acc[i + 1][0] = acc[i + 1][1] = 0.f;
  }
}

// out[b, l, h] = sum_d x[b, d] * t[u_b, l, d, h], fp32
__global__ void __launch_bounds__(THREADS, 2)
q_t_kernel(const float* __restrict__ x, const float* __restrict__ t,
           const int* __restrict__ idx, float* __restrict__ out, int B,
           int U, int L, int D, int H, int vec_t, int vec_out) {
  // two buffers of (QT_SLOTS x QT_KC x QT_COLS) of T and (QT_ROWS x QT_KC)
  // of x
  extern __shared__ __align__(16) float smem[];
  constexpr int kT = QT_SLOTS * QT_KC * QT_COLS, kX = QT_ROWS * QT_KC;
  __shared__ int sIdx[QT_ROWS];    // a row's clamped user (-1: past B)
  __shared__ int sOrd[QT_ROWS];    // a row's user, as an ordinal of the tile
  __shared__ int sUser[QT_ROWS];   // the tile's distinct users, in row order
  __shared__ int sFirsts[QT_ROWS / 32];
  __shared__ int sPerm[QT_ROWS];   // rows by user ordinal (stable)
  const int LH = L * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.y * QT_ROWS;
  const int ebase = blockIdx.x * QT_TILES * QT_COLS;
  if (row0 >= B || ebase >= LH) return;
  const int nrows = min(QT_ROWS, B - row0);
  const int distinct =
      qt_users(idx, row0, nrows, U, sIdx, sOrd, sUser, sFirsts, sPerm);
  int rows[QT_RPW], ord[QT_RPW];         // this warp's rows (ord -1: past B)
#pragma unroll
  for (int i = 0; i < QT_RPW; ++i) {
    rows[i] = sPerm[warp * QT_RPW + i];
    ord[i] = sOrd[rows[i]];
  }
  bool same = ord[QT_RPW - 1] >= 0;      // one user for all 8 rows
#pragma unroll
  for (int i = 1; i < QT_RPW; ++i) same = same && ord[i] == ord[0];

  const int nchunk = (D + QT_KC - 1) / QT_KC;
  const int ntile = min(QT_TILES, (LH - ebase + QT_COLS - 1) / QT_COLS);
  float acc[QT_RPW][2];
#pragma unroll
  for (int i = 0; i < QT_RPW; ++i) acc[i][0] = acc[i][1] = 0.f;

  if (distinct > QT_SLOTS) {
    // ---- more users than a step stages (a random order over many slots,
    // short runs): a warp reads its rows' slices of T straight from L2,
    // once per run of one user among its 8 rows (in their order); the
    // rows' x from shared memory, one chunk of d at a time ---------------
    float* sX = smem;
    for (int ct = 0; ct < ntile; ++ct) {
      const int e = ebase + ct * QT_COLS + 2 * lane;
      for (int c = 0; c < nchunk; ++c) {
        const int d0 = c * QT_KC;
        if (ct == 0 || nchunk > 1) {
          __syncthreads();               // the last chunk's x is read
          for (int i = tid; i < QT_ROWS * QT_KC; i += THREADS) {
            const int r = i / QT_KC, dd = i - r * QT_KC;
            sX[i] = r < nrows && d0 + dd < D
                        ? x[(size_t)(row0 + r) * D + d0 + dd] : 0.f;
          }
          __syncthreads();
        }
        float2 tv[QT_KC];
        int cur = -1;
#pragma unroll
        for (int i = 0; i < QT_RPW; ++i) {
          if (ord[i] < 0) continue;
          if (ord[i] != cur) {
            qt_load(tv, t + (size_t)sUser[ord[i]] * LH * D, e, d0, D, H, LH,
                    vec_t);
            cur = ord[i];
          }
          qt_fma_row(acc[i], sX + rows[i] * QT_KC, tv);
        }
      }
      qt_store(acc, rows, nrows, out + (size_t)row0 * LH, LH,
               ebase + ct * QT_COLS, vec_out, lane);
    }
    return;
  }

  // ---- at most QT_SLOTS users: steps, each staged one ahead of the one
  // computed. With one chunk of d (DIN: D = 18) a step covers as many
  // column tiles as the buffer holds slices of the tile's users (up to
  // QT_TILES / 2), so the engine's runs take two steps a block; otherwise
  // a step is one (column tile, chunk of d).
  const bool multi = nchunk == 1;
  const int tps = multi ? max(1, min(QT_SLOTS / distinct, QT_TILES / 2)) : 1;
  const int nsteps = multi ? (ntile + tps - 1) / tps : ntile * nchunk;
  struct Step { int ct0, ntc, d0; bool complete; };
  auto step_of = [&](int st) {
    Step p;
    if (multi) {
      p.ct0 = st * tps;
      p.ntc = min(tps, ntile - p.ct0);
      p.d0 = 0;
      p.complete = true;
    } else {
      p.ct0 = st / nchunk;
      p.ntc = 1;
      p.d0 = (st - p.ct0 * nchunk) * QT_KC;
      p.complete = st - p.ct0 * nchunk == nchunk - 1;
    }
    return p;
  };
  auto stage = [&](int st) {
    const Step p = step_of(st);
    float* buf = smem + (st & 1) * (kT + kX);
    qt_stage(buf, buf + kT, x, t, sUser, row0, nrows,
             ebase + p.ct0 * QT_COLS, p.ntc, distinct, p.d0, D, H, LH, vec_t);
    cp_async_commit();
  };
  stage(0);
  for (int st = 0; st < nsteps; ++st) {
    if (st + 1 < nsteps) {
      stage(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                     // step st's slices are in place
    const Step p = step_of(st);
    const float* sX = smem + (st & 1) * (kT + kX) + kT;
    for (int tc = 0; tc < p.ntc; ++tc) {
      const float* sT = smem + (st & 1) * (kT + kX)
                    + tc * distinct * QT_KC * QT_COLS;
      float2 tv[QT_KC];
      if (same) {
        // the engine's layout: all 8 rows read one user, no branch between
#pragma unroll
        for (int dd = 0; dd < QT_KC; ++dd)
          tv[dd] = ld2(sT + (ord[0] * QT_KC + dd) * QT_COLS + 2 * lane);
#pragma unroll
        for (int i = 0; i < QT_RPW; ++i)
          qt_fma_row(acc[i], sX + rows[i] * QT_KC, tv);
      } else {
        int cur = -1;
#pragma unroll
        for (int i = 0; i < QT_RPW; ++i) {
          if (ord[i] < 0) continue;
          if (ord[i] != cur) {           // a new user: its slice to registers
#pragma unroll
            for (int dd = 0; dd < QT_KC; ++dd)
              tv[dd] = ld2(sT + (ord[i] * QT_KC + dd) * QT_COLS + 2 * lane);
            cur = ord[i];
          }
          qt_fma_row(acc[i], sX + rows[i] * QT_KC, tv);
        }
      }
      if (p.complete)
        qt_store(acc, rows, nrows, out + (size_t)row0 * LH, LH,
                 ebase + (p.ct0 + tc) * QT_COLS, vec_out, lane);
    }
    __syncthreads();                     // the buffer is free for step st+2
  }
}

// ---- SPEC_Q_T bf16 on the tensor cores -------------------------------------

// four (two) 8 x 8 b16 matrices, transposed; lane l gives the row address
// of matrix l / 8
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, "
               "[%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
}

// C (16 x 8, f32) += A (16 x 16, bf16) * B (16 x 8, bf16)
__device__ __forceinline__ void mma_k16(float* c, const uint32_t* a,
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// C (16 x 8, f32) += A (16 x 8, bf16) * B (8 x 8, bf16)
__device__ __forceinline__ void mma_k8(float* c, const uint32_t* a,
                                       uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// one user's slice for a chunk of d into dst ((QM_KC d) x (64 columns),
// row stride QM_TS): T[user, l(e), d, h(e)] for d0 .. d0 + QM_KC - 1 and
// e0 .. e0 + 63, zeros past D and L*H, by threads i0, i0 + step, ...: 16
// bytes (8 columns of one l) by cp.async where vec_t (H % 8 == 0, t
// 16-byte aligned), else value by value
__device__ __forceinline__ void qm_slice(bf16* dst, const bf16* tu, int e0,
                                         int d0, int D, int H, int LH,
                                         int vec_t, int i0, int step) {
  for (int i = i0; i < QM_KC * (QT_COLS / 8); i += step) {
    const int dd = i / (QT_COLS / 8), q = i - dd * (QT_COLS / 8);
    const int d = d0 + dd, e = e0 + 8 * q;
    bf16* o = dst + dd * QM_TS + 8 * q;
    if (d >= D || e >= LH) {
      *reinterpret_cast<uint4*>(o) = make_uint4(0, 0, 0, 0);
    } else if (vec_t) {
      const int l = e / H, h = e - l * H;
      cp_async<16>(o, tu + ((size_t)l * D + d) * H + h);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int l = (e + j) / H, h = e + j - l * H;
        o[j] = e + j < LH ? tu[((size_t)l * D + d) * H + h] : bf16_zero();
      }
    }
  }
}

// the rows' x for a chunk of d into sX (QT_ROWS x QM_XS), zeros past D and
// B: pairs by cp.async where vec_x (D even, x 4-byte aligned)
__device__ __forceinline__ void qm_stage_x(bf16* sX, const bf16* x, int row0,
                                           int nrows, int d0, int D,
                                           int vec_x) {
  for (int i = threadIdx.x; i < QT_ROWS * QM_KC / 2; i += THREADS) {
    const int r = i / (QM_KC / 2), dd = 2 * (i - r * (QM_KC / 2));
    const int d = d0 + dd;
    bf16* o = sX + r * QM_XS + dd;
    const bf16* src = x + (size_t)(row0 + r) * D + d;
    if (r < nrows && vec_x && d < D) {
      cp_async<4>(o, src);
    } else {
      o[0] = r < nrows && d < D ? src[0] : bf16_zero();
      o[1] = r < nrows && d + 1 < D ? src[1] : bf16_zero();
    }
  }
}

// B fragments of the warp's 8 rows for a chunk: lane (g, t) holds x[row g]
// at k = 2t, 2t + 1 (+ 8) for the k16 mma and at 16 + 2t, 17 + 2t for the
// k8 mma
__device__ __forceinline__ void qm_b(uint32_t* b, const bf16* sX, int rowg,
                                     int lane) {
  const bf16* xr = sX + rowg * QM_XS + 2 * (lane & 3);
  b[0] = *reinterpret_cast<const uint32_t*>(xr);
  b[1] = *reinterpret_cast<const uint32_t*>(xr + 8);
  b[2] = *reinterpret_cast<const uint32_t*>(xr + 16);
}

// acc (4 m16 tiles: columns 16 m .. 16 m + 15 of the column tile, by the
// warp's 8 rows) through one chunk of a user's slice at sT: C = acc, then
// k16 and k8; the rows in `keep` (bit n: the warp's row n) take the result,
// the others keep theirs. A lane's C: columns g and g + 8 of rows 2t, 2t+1.
__device__ __forceinline__ void qm_mma(float (*acc)[4], const bf16* sT,
                                       const uint32_t* b, unsigned keep,
                                       int lane) {
  const int t = lane & 3;
  const bool k0 = (keep >> (2 * t)) & 1, k1 = (keep >> (2 * t + 1)) & 1;
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(sT);
  const int col = ((lane >> 3) & 1) * 8;
  const uint32_t a16 =
      base + 2 * ((((lane >> 4) << 3) + (lane & 7)) * QM_TS + col);
  const uint32_t a8 = base + 2 * ((16 + (lane & 7)) * QM_TS + col);
#pragma unroll
  for (int mt = 0; mt < QT_COLS / 16; ++mt) {
    uint32_t a[4], a2[2];
    ldsm_x4_t(a, a16 + 32 * mt);
    ldsm_x2_t(a2, a8 + 32 * mt);
    float c[4] = {acc[mt][0], acc[mt][1], acc[mt][2], acc[mt][3]};
    mma_k16(c, a, b[0], b[1]);
    mma_k8(c, a2, b[2]);
    acc[mt][0] = k0 ? c[0] : acc[mt][0];
    acc[mt][1] = k1 ? c[1] : acc[mt][1];
    acc[mt][2] = k0 ? c[2] : acc[mt][2];
    acc[mt][3] = k1 ? c[3] : acc[mt][3];
  }
}

// a chunk for the warp's rows: one pass per distinct user among them (ordl:
// lane n < 8 holds the ordinal of the warp's row n, -1 past B; the same
// for every row: one pass); slice(k) is user ordinal k's slice
template <typename Slice>
__device__ __forceinline__ void qm_passes(float (*acc)[4], const uint32_t* b,
                                          int ordl, bool same, int lane,
                                          Slice slice) {
  if (same) {
    qm_mma(acc, slice(__shfl_sync(FULL, ordl, 0)), b, 0xffu, lane);
    return;
  }
  unsigned todo = __ballot_sync(FULL, lane < QT_RPW && ordl >= 0);
  while (todo) {
    const int k = __shfl_sync(FULL, ordl, __ffs(todo) - 1);
    const unsigned keep = __ballot_sync(FULL, lane < QT_RPW && ordl == k);
    qm_mma(acc, slice(k), b, keep, lane);
    todo &= ~keep;
  }
}

// the warp's 8 rows of one column tile from column c, rounded to bf16 into
// the warp's staging so (8 rows x QM_OS), then 16 bytes a lane along L*H
// where aligned; acc zeroed. wperm: the warp's rows in the tile.
__device__ __forceinline__ void qm_store(float (*acc)[4], bf16* so,
                                         const int* wperm, int nrows,
                                         bf16* out, int LH, int c,
                                         bool vec_out, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < QT_COLS / 16; ++mt) {
    bf16* s = so + 2 * t * QM_OS + 16 * mt + g;
    s[0] = __float2bfloat16_rn(acc[mt][0]);
    s[QM_OS] = __float2bfloat16_rn(acc[mt][1]);
    s[8] = __float2bfloat16_rn(acc[mt][2]);
    s[QM_OS + 8] = __float2bfloat16_rn(acc[mt][3]);
    acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
  }
  __syncwarp();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = (lane >> 3) + 4 * half, q = lane & 7;
    const int r = wperm[i], c0 = c + 8 * q;
    if (r < nrows) {
      const bf16* s = so + i * QM_OS + 8 * q;
      bf16* o = out + (size_t)r * LH + c0;
      if (vec_out && c0 + 7 < LH) {
        *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(s);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c0 + j < LH) o[j] = s[j];
      }
    }
  }
  __syncwarp();                          // so is free for the next tile
}

// out[b, l, h] = sum_d x[b, d] * t[u_b, l, d, h], bf16 on the tensor cores
__global__ void __launch_bounds__(THREADS, 2)
q_t_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ t,
               const int* __restrict__ idx, bf16* __restrict__ out, int B,
               int U, int L, int D, int H, int vec_t, int vec_out,
               int vec_x) {
  // two buffers of QT_SLOTS slices and the rows' x, then the warps'
  // output staging
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  __shared__ int sIdx[QT_ROWS];
  __shared__ int sOrd[QT_ROWS];
  __shared__ int sUser[QT_ROWS];
  __shared__ int sFirsts[QT_ROWS / 32];
  __shared__ int sPerm[QT_ROWS];
  const int LH = L * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.y * QT_ROWS;
  const int ebase = blockIdx.x * QT_TILES * QT_COLS;
  if (row0 >= B || ebase >= LH) return;
  const int nrows = min(QT_ROWS, B - row0);
  const int distinct =
      qt_users(idx, row0, nrows, U, sIdx, sOrd, sUser, sFirsts, sPerm);
  const int* wperm = sPerm + warp * QT_RPW;
  const int rowg = wperm[lane >> 2];     // the row this lane feeds to B
  const int ordl = lane < QT_RPW ? sOrd[wperm[lane]] : -1;
  const int ord0 = __shfl_sync(FULL, ordl, 0);
  const bool same = __all_sync(FULL, lane >= QT_RPW || (ordl == ord0 &&
                                                         ordl >= 0));
  bf16* so = smem + 2 * QM_BUF + warp * QT_RPW * QM_OS;
  bf16* outt = out + (size_t)row0 * LH;

  const int nchunk = (D + QM_KC - 1) / QM_KC;
  const int ntile = min(QT_TILES, (LH - ebase + QT_COLS - 1) / QT_COLS);
  float acc[QT_COLS / 16][4];
#pragma unroll
  for (int mt = 0; mt < QT_COLS / 16; ++mt)
    acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
  uint32_t b[3];

  if (distinct > QT_SLOTS) {
    // ---- more users than a step stages: the rows' x for a chunk staged
    // by the block, each user's slice copied from L2 into the warp's own
    // staging, once per user among its 8 rows
    bf16* sX = smem;
    bf16* sW = smem + QT_ROWS * QM_XS + warp * QM_SLICE;
    for (int ct = 0; ct < ntile; ++ct) {
      const int e0 = ebase + ct * QT_COLS;
      for (int c = 0; c < nchunk; ++c) {
        const int d0 = c * QM_KC;
        if (ct == 0 || nchunk > 1) {
          __syncthreads();               // the last chunk's x is read
          qm_stage_x(sX, x, row0, nrows, d0, D, vec_x);
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
          qm_b(b, sX, rowg, lane);
        }
        qm_passes(acc, b, ordl, same, lane, [&](int k) {
          __syncwarp();                  // the last pass's reads are done
          qm_slice(sW, t + (size_t)sUser[k] * LH * D, e0, d0, D, H, LH,
                   vec_t, lane, 32);
          cp_async_commit();
          cp_async_wait<0>();
          __syncwarp();
          return sW;
        });
      }
      qm_store(acc, so, wperm, nrows, outt, LH, e0, vec_out, lane);
    }
    return;
  }

  // ---- at most QT_SLOTS users: steps as q_t_kernel's, each staged by
  // cp.async one ahead of the one computed
  const bool multi = nchunk == 1;
  const int tps = multi ? max(1, min(QT_SLOTS / distinct, QT_TILES / 2)) : 1;
  const int nsteps = multi ? (ntile + tps - 1) / tps : ntile * nchunk;
  auto ct0_of = [&](int st) { return multi ? st * tps : st / nchunk; };
  auto stage = [&](int st) {
    const int ct0 = ct0_of(st);
    const int ntc = multi ? min(tps, ntile - ct0) : 1;
    const int d0 = multi ? 0 : (st - ct0 * nchunk) * QM_KC;
    bf16* buf = smem + (st & 1) * QM_BUF;
    for (int s = 0; s < ntc * distinct; ++s) {
      const int tc = s / distinct, k = s - tc * distinct;
      qm_slice(buf + s * QM_SLICE, t + (size_t)sUser[k] * LH * D,
               ebase + (ct0 + tc) * QT_COLS, d0, D, H, LH, vec_t, tid,
               THREADS);
    }
    qm_stage_x(buf + QT_SLOTS * QM_SLICE, x, row0, nrows, d0, D, vec_x);
    cp_async_commit();
  };
  stage(0);
  for (int st = 0; st < nsteps; ++st) {
    if (st + 1 < nsteps) {
      stage(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                     // step st's slices are in place
    const int ct0 = ct0_of(st);
    const int ntc = multi ? min(tps, ntile - ct0) : 1;
    const bool complete = multi || st - ct0 * nchunk == nchunk - 1;
    const bf16* buf = smem + (st & 1) * QM_BUF;
    qm_b(b, buf + QT_SLOTS * QM_SLICE, rowg, lane);
    for (int tc = 0; tc < ntc; ++tc) {
      qm_passes(acc, b, ordl, same, lane, [&](int k) {
        return buf + (tc * distinct + k) * QM_SLICE;
      });
      if (complete)
        qm_store(acc, so, wperm, nrows, outt, LH,
                 ebase + (ct0 + tc) * QT_COLS, vec_out, lane);
    }
    __syncthreads();                     // the buffer is free for step st+2
  }
}

// ---- SPEC_W_KEYS ----------------------------------------------------------

// one level of the lanes' reduce-scatter: lane pairs W apart swap halves of
// acc[0 .. 2W) and add, so acc[i] then holds column i (+ W if lane & W)
template <int W>
__device__ __forceinline__ void scatter_half(float* acc, int lane) {
  const bool upper = lane & W;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float give = upper ? acc[i] : acc[i + W];
    const float keep = upper ? acc[i + W] : acc[i];
    acc[i] = keep + __shfl_xor_sync(FULL, give, W);
  }
}

// out[b, d] = sum_l w[b, l] * t[u_b, l, d]
template <typename T>
__global__ void __launch_bounds__(32 * WK_WARPS)
w_keys_kernel(const T* __restrict__ x, const T* __restrict__ t,
              const int* __restrict__ idx, T* __restrict__ out, int B,
              int U, int L, int D) {
  // per warp, two buffers of 32 key rows of up to 32 columns and their 32
  // weights, as they are (bf16: widened where the FMAs read them); the
  // unguarded sums of the last row read into the weights, never stored
  constexpr int kBuf = 32 * WK_D + 32;
  __shared__ __align__(16)
      unsigned char sbuf[WK_WARPS][2][kBuf * sizeof(T)];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int b = blockIdx.x * WK_WARPS + warp; b < B;
       b += gridDim.x * WK_WARPS) {
    const T* xr = x + (size_t)b * L;
    const T* tu = t + (size_t)clamp_slot(idx[b], U) * L * D;
    for (int d0 = 0; d0 < D; d0 += WK_D) {
      const int nd = min(WK_D, D - d0);
      // chunk c's keys and weights, copied asynchronously: as one run
      // where the chunk's keys are one (D <= 32), else value by value
      auto stage = [&](int c) {
        T* sk = reinterpret_cast<T*>(sbuf[warp][c & 1]);
        const int l0 = c * 32, nl = min(32, L - l0), n = nl * nd;
        const T* src = tu + (size_t)l0 * D + d0;
        if (nd == D) {
          warp_stage_run(sk, src, n, lane);
        } else {
          for (int i = lane; i < n; i += 32) {
            const int l = i / nd;
            stage1(sk + i, src + (size_t)l * D + (i - l * nd));
          }
        }
        warp_stage_run(sk + 32 * WK_D, xr + l0, nl, lane);
        cp_async_commit();
      };
      float acc[WK_D];
#pragma unroll
      for (int j = 0; j < WK_D; ++j) acc[j] = 0.f;
      const int nchunk = (L + 31) / 32;
      __syncwarp();                      // the last row's reads are done
      stage(0);
      for (int c = 0; c < nchunk; ++c) {
        if (c + 1 < nchunk) {
          stage(c + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncwarp();
        // lane sums key 32 c + lane over 32 columns, unguarded (columns
        // past nd are never stored)
        const T* sk = reinterpret_cast<const T*>(sbuf[warp][c & 1]);
        if (c * 32 + lane < L) {
          const float w = ld(sk + 32 * WK_D + lane);
#pragma unroll
          for (int j = 0; j < WK_D; ++j)
            acc[j] = fmaf(w, ld(sk + lane * nd + j), acc[j]);
        }
        __syncwarp();                    // the buffer is free for c + 2
      }
      // reduce-scatter across the 32 lanes in a fixed tree: at each level
      // a lane keeps half its columns and adds its partner's; lane j ends
      // with column j's sum
      scatter_half<16>(acc, lane);
      scatter_half<8>(acc, lane);
      scatter_half<4>(acc, lane);
      scatter_half<2>(acc, lane);
      scatter_half<1>(acc, lane);
      if (lane < nd) st(out + (size_t)b * D + d0 + lane, acc[0]);
    }
  }
}

// ---- SPEC_ROWS_VEC --------------------------------------------------------

// passes of 4 rows a warp step: 16 bytes of each lane's chunk in flight per
// pass in bf16, 32 in fp32, so 4 passes in bf16 and 2 in fp32 put the same
// bytes in flight
template <typename T>
constexpr int kRvPass = 8 / (int)sizeof(T);
template <typename T>
constexpr int kRvRows = 32 / RV_G * kRvPass<T>;

// a chunk of a row at p (n > 0 of its values left in the row) as it is, in
// 32-bit words (8 in fp32, 4 in bf16), zeros past n: 16-byte loads where
// vec and the chunk is whole
template <typename T>
__device__ __forceinline__ void rv_raw(uint32_t* w, const T* p, int n,
                                       bool vec) {
  if (vec && n >= RV_V) {
#pragma unroll
    for (int i = 0; i < RV_V * (int)sizeof(T) / 16; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = v.x; w[4 * i + 1] = v.y; w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < RV_V; ++i) w[i] = i < n ? __float_as_uint(p[i]) : 0u;
  } else {
#pragma unroll
    for (int i = 0; i < RV_V / 2; ++i) {
      const uint32_t lo = 2 * i < n ? __bfloat16_as_ushort(p[2 * i]) : 0u;
      const uint32_t hi =
          2 * i + 1 < n ? __bfloat16_as_ushort(p[2 * i + 1]) : 0u;
      w[i] = lo | hi << 16;
    }
  }
}

// value i of a raw chunk, widened
template <typename T>
__device__ __forceinline__ float rv_val(const uint32_t* w, int i) {
  if constexpr (sizeof(T) == 4)
    return __uint_as_float(w[i]);
  else
    return __uint_as_float(i & 1 ? w[i >> 1] & 0xffff0000u : w[i >> 1] << 16);
}

// out[b, l] = sum_h x[b, l, h] * t[u_b, h]; a warp takes rows [per * w,
// per * (w + 1)). NC > 0: a lane's chunks (at most NC) of the table row in
// registers, reloaded where b changes; NC == 0: read per row.
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
rows_vec_kernel(const T* __restrict__ x, const T* __restrict__ t,
                const int* __restrict__ idx, T* __restrict__ out, int B,
                int U, int L, int H, int vec, long long per) {
  constexpr int PASS = kRvPass<T>, W = RV_V * (int)sizeof(T) / 4;
  const long long n = (long long)B * L;
  const int lane = threadIdx.x & 31, g = lane / RV_G, j = lane % RV_G;
  const int nchunk = (H + RV_V - 1) / RV_V;
  const long long w = (long long)blockIdx.x * (THREADS / 32)
                      + (threadIdx.x >> 5);
  const long long r_end = min(n, per * (w + 1));
  uint32_t tv[NC > 0 ? NC : 1][W];
  int tb = -1;                           // the b whose table row tv holds
  for (long long r0 = per * w; r0 < r_end; r0 += kRvRows<T>) {
    float acc[PASS];
    if constexpr (NC > 0) {
      uint32_t xv[PASS][NC][W];
#pragma unroll
      for (int p = 0; p < PASS; ++p) {
        const long long r = r0 + p * (32 / RV_G) + g;
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          const int c = j + RV_G * k;
          if (r < r_end && c < nchunk)
            rv_raw(xv[p][k], x + r * H + c * RV_V, H - c * RV_V, vec);
        }
      }
#pragma unroll
      for (int p = 0; p < PASS; ++p) {
        const long long r = r0 + p * (32 / RV_G) + g;
        acc[p] = 0.f;
        if (r < r_end) {
          const int b = (int)(r / L);
          if (b != tb) {
            const T* tp = t + (size_t)clamp_slot(idx[b], U) * H;
#pragma unroll
            for (int k = 0; k < NC; ++k) {
              const int c = j + RV_G * k;
              if (c < nchunk) rv_raw(tv[k], tp + c * RV_V, H - c * RV_V, vec);
            }
            tb = b;
          }
#pragma unroll
          for (int k = 0; k < NC; ++k)
            if (j + RV_G * k < nchunk) {
#pragma unroll
              for (int i = 0; i < RV_V; ++i)
                acc[p] = fmaf(rv_val<T>(xv[p][k], i), rv_val<T>(tv[k], i),
                              acc[p]);
            }
        }
      }
    } else {
#pragma unroll
      for (int p = 0; p < PASS; ++p) {
        const long long r = r0 + p * (32 / RV_G) + g;
        acc[p] = 0.f;
        if (r < r_end) {
          const T* tp = t + (size_t)clamp_slot(idx[r / L], U) * H;
          for (int c = j; c < nchunk; c += RV_G) {
            uint32_t xv[W];
            rv_raw(xv, x + r * H + c * RV_V, H - c * RV_V, vec);
            rv_raw(tv[0], tp + c * RV_V, H - c * RV_V, vec);
#pragma unroll
            for (int i = 0; i < RV_V; ++i)
              acc[p] = fmaf(rv_val<T>(xv, i), rv_val<T>(tv[0], i), acc[p]);
          }
        }
      }
    }
    // the row's 8 partials in a fixed tree: ((0+4)+(2+6)) + ((1+5)+(3+7))
#pragma unroll
    for (int p = 0; p < PASS; ++p) {
      acc[p] += __shfl_xor_sync(FULL, acc[p], 4);
      acc[p] += __shfl_xor_sync(FULL, acc[p], 2);
      acc[p] += __shfl_xor_sync(FULL, acc[p], 1);
      const long long r = r0 + p * (32 / RV_G) + g;
      if (j == 0 && r < r_end) st(out + r, acc[p]);
    }
  }
}

int grid_1d(size_t n, int per_block) {
  const size_t blocks = (n + per_block - 1) / per_block;
  return (int)(blocks < 1048576 ? blocks : 1048576);
}

// whether p starts a run of `bytes` bytes (a power of 2) aligned to them
template <typename T>
bool aligned(const T* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <typename T, int NC>
int launch_rows_vec(const T* x, const T* t, const int* idx, T* out, int B,
                    int U, int L, int H, cudaStream_t s) {
  // as many blocks as the card holds at once (worked out at the first
  // launch; callers may launch from several threads), each warp a
  // contiguous range of rows (a multiple of its rows a step)
  static std::atomic<int> resident{0};
  int blocks = resident.load();
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, rows_vec_kernel<T, NC>, THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    blocks = sms * per_sm;
    if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
    resident.store(blocks);
  }
  const long long n = (long long)B * L;
  const long long steps = (n + kRvRows<T> - 1) / kRvRows<T>;
  const long long warps_max = (long long)blocks * (THREADS / 32);
  const long long per =
      (steps + warps_max - 1) / warps_max * (long long)kRvRows<T>;
  const long long warps = (n + per - 1) / per;
  const int grid = (int)((warps + THREADS / 32 - 1) / (THREADS / 32));
  const int vec = (H * (int)sizeof(T)) % 16 == 0 && aligned(x, 16) &&
                  aligned(t, 16);
  rows_vec_kernel<T, NC><<<grid, THREADS, 0, s>>>(x, t, idx, out, B, U, L,
                                                  H, vec, per);
  return 0;
}

// ---- SPEC_Q_T fp32 past D = 40: the tensor cores, rows grouped by user ----

// Up to D = 40 each output's 2 D CUDA-core FLOP (at 67 TFLOP/s) stay under
// its 4-byte store (at 3.35 TB/s), so q_t_kernel stands there; past that
// the products take the tensor cores (see the note at the top)
constexpr int TC_MIN_D = 41;
constexpr int TC_COLS = 64;            // wgmma's M: columns of L*H a tile
constexpr int TC_KT = 32;              // d a k tile: one 128-byte row of x
constexpr int TC_KS = TC_KT / 8;       // 8-deep k steps a k tile
constexpr int TC_AS = TC_COLS + 8;     // row stride of a staged A k tile
constexpr int TC_OS = TC_COLS + 4;     // row stride of the output staging
constexpr int TC_STAGES = 4;           // A k tiles in flight
constexpr int TC_WG = 2;               // warpgroups a block, sharing A
constexpr int TC_THREADS = 128 * TC_WG;
constexpr int TC_X_BYTES = 128 * 1024; // the block's x rows, hi and lo
constexpr int TC_BLOCKS_PER_SM = 4;    // blocks aimed at, for a block's run
constexpr int GS_TILE = 256;           // rows a tile of the counting sort

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
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

// wgmma with A (64 x 8 tf32) from registers, one instance per N
template <int N>
struct Wg;

template <>
struct Wg<8> {
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
};

template <>
struct Wg<16> {
  // D (64 x 16, f32) += A (64 x 8, tf32, registers) * B (16 x 8 in smem)
  static __device__ __forceinline__ void tf32(float* d, const uint32_t* a,
                                              uint64_t desc_b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
};

template <>
struct Wg<32> {
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
};


// rows of x a warpgroup holds (wgmma's N) at this D: the most of 64, 32,
// 16, 8 whose hi and lo (D padded to k tiles) for the block's TC_WG
// warpgroups fit TC_X_BYTES; 0 past D = 1024
__host__ __device__ inline int tc_rows(int D) {
  const long long dp = (D + TC_KT - 1) / TC_KT * TC_KT;
  for (int nr = 64; nr >= 8; nr /= 2)
    if (TC_WG * nr * dp * 8 <= TC_X_BYTES) return nr;
  return 0;
}

// bytes of the tile kernel's dynamic shared memory: x's hi and lo (k tiles
// of TC_WG nr rows of 128 bytes), the A ring, each warpgroup's output
// staging, and 1024 to align the swizzled tiles
inline size_t tc_smem_bytes(int D, int nr) {
  const size_t kt = (D + TC_KT - 1) / TC_KT;
  return 1024 + 2 * kt * TC_WG * nr * TC_KT * sizeof(float) +
         (size_t)TC_STAGES * TC_KT * TC_AS * sizeof(float) +
         (size_t)TC_WG * nr * TC_OS * sizeof(float);
}

inline long long up256(long long n) { return (n + 255) & ~255LL; }

// the route's workspace, offsets in bytes: counts (n_t x U int: per sort
// tile and user, then each one's first position), the row tiles (start,
// rows, user: max_tiles x 3 int), their number (1 int), the permutation
// (B int: sorted position -> row)
struct TcWork {
  int n_t, max_tiles;
  long long counts, tiles, ntiles, perm, total;
};

TcWork tc_work(int B, int U, int nr) {
  TcWork w;
  w.n_t = (B + GS_TILE - 1) / GS_TILE;
  w.max_tiles = (B + nr - 1) / nr + (U < B ? U : B);
  w.counts = 0;
  w.tiles = up256(4LL * w.n_t * U);
  w.ntiles = w.tiles + up256(12LL * w.max_tiles);
  w.perm = w.ntiles + 256;
  w.total = w.perm + up256(4LL * B);
  return w;
}

// exclusive scan of v over the block (blockDim.x a multiple of 32); *total
// the block's sum
__device__ __forceinline__ int block_scan(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(FULL, inc, off);
    if (lane >= off) inc += o;
  }
  if (lane == 31) scratch[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const int x = scratch[w];
    if (w < warp) before += x;
    all += x;
  }
  __syncthreads();
  *total = all;
  return before + inc - v;
}

// the stable counting sort of the clamped user index, in three launches:
// (1) each sort tile of GS_TILE rows counts its users into its row of
// counts (integer atomics: their order cannot change a count)
__global__ void __launch_bounds__(GS_TILE)
    ge_sort_hist(const int* __restrict__ idx, int B, int U,
                 int* __restrict__ counts) {
  int* row = counts + (size_t)blockIdx.x * U;
  for (int k = threadIdx.x; k < U; k += GS_TILE) row[k] = 0;
  __syncthreads();
  const int b = blockIdx.x * GS_TILE + threadIdx.x;
  if (b < B) atomicAdd(&row[clamp_slot(idx[b], U)], 1);
}

// (2) one block: a user's count in each tile becomes its rows in earlier
// tiles plus the rows of smaller users (its first sorted position in that
// tile); each user's rows are cut into row tiles of nr, listed in user
// order (start, rows, user), and their number written to *ntiles
__global__ void __launch_bounds__(1024)
    ge_sort_scan(int* __restrict__ counts, int n_t, int U, int nr,
                 int* __restrict__ tiles, int* __restrict__ ntiles) {
  __shared__ int scratch[32];
  int base_rows = 0, base_tiles = 0;
  for (int u0 = 0; u0 < U; u0 += blockDim.x) {
    const int u = u0 + threadIdx.x;
    int total = 0;
    if (u < U)                     // 8 tiles' counts loaded before any is
      for (int t0 = 0; t0 < n_t; t0 += 8) {      // rewritten
        int v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = t0 + j < n_t ? counts[(size_t)(t0 + j) * U + u] : 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (t0 + j < n_t) counts[(size_t)(t0 + j) * U + u] = total;
          total += v[j];
        }
      }
    const int nt = (total + nr - 1) / nr;
    int sum_rows, sum_tiles;
    const int off = base_rows + block_scan(total, scratch, &sum_rows);
    const int toff = base_tiles + block_scan(nt, scratch, &sum_tiles);
    if (u < U) {
      for (int t0 = 0; t0 < n_t; t0 += 8) {
        int v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = t0 + j < n_t ? counts[(size_t)(t0 + j) * U + u] : 0;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (t0 + j < n_t) counts[(size_t)(t0 + j) * U + u] = v[j] + off;
      }
      for (int i = 0; i < nt; ++i) {
        int* p = tiles + 3 * (size_t)(toff + i);
        p[0] = off + i * nr;
        p[1] = min(nr, total - i * nr);
        p[2] = u;
      }
    }
    base_rows += sum_rows;
    base_tiles += sum_tiles;
  }
  if (threadIdx.x == 0) *ntiles = base_tiles;
}

// (3) each row goes to its user's first position in its tile plus the
// rows of that user before it in the tile
__global__ void __launch_bounds__(GS_TILE)
    ge_sort_scatter(const int* __restrict__ idx, int B, int U,
                    const int* __restrict__ counts, int* __restrict__ perm) {
  __shared__ int sk[GS_TILE];
  const int b = blockIdx.x * GS_TILE + threadIdx.x;
  const int key = b < B ? clamp_slot(idx[b], U) : -1;
  sk[threadIdx.x] = key;
  __syncthreads();
  if (b < B) {
    int rank = 0;
    for (int j = 0; j < (int)threadIdx.x; ++j) rank += sk[j] == key;
    perm[counts[(size_t)blockIdx.x * U + key] + rank] = b;
  }
}

// out[b, e] for the rows of one row tile (TC_WG NR rows of one user, in
// sorted order; warpgroup w takes NR of them) and a run of column tiles,
// each (64 columns of L*H) x (NR rows) a warpgroup on the tensor cores: A
// = the user's T slice (column e = l*H + h, d), staged by cp.async a k
// tile at a time (one copy for both warpgroups) and split into tf32 hi /
// lo in registers; B = the warpgroup's x rows, split once into hi / lo and
// kept in shared memory (K-major, 128-byte swizzle); each 32-deep k tile
// summed from zero (lo*hi, hi*lo, hi*hi per 8-deep step) and added to the
// fp32 sum with ordinary adds; the sum staged (row, column) in shared
// memory for 16-byte row stores
template <int NR>
__global__ void __launch_bounds__(TC_THREADS)
    q_t_tc_kernel(const float* __restrict__ x, const float* __restrict__ t,
                  const int* __restrict__ perm, const int* __restrict__ tiles,
                  const int* __restrict__ ntiles, float* __restrict__ out,
                  int L, int D, int H, int cg, int vec_x, int vec_t,
                  int vec_out) {
  constexpr int R = NR / 2;                   // accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align x's tiles to it
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tile = blockIdx.x;
  if (tile >= *ntiles) return;
  const int LH = L * H;
  const int nct = (LH + TC_COLS - 1) / TC_COLS;
  const int ct0 = blockIdx.y * cg;
  if (ct0 >= nct) return;
  const int nc = min(cg, nct - ct0);
  const int start = tiles[3 * tile], nrows = tiles[3 * tile + 1];
  const float* tu = t + (size_t)tiles[3 * tile + 2] * LH * D;
  const int kt_n = (D + TC_KT - 1) / TC_KT;
  constexpr int XR = TC_WG * NR;               // the block's x rows
  float* xhi = reinterpret_cast<float*>(smem);
  float* xlo = xhi + kt_n * XR * TC_KT;
  float* sA = xlo + kt_n * XR * TC_KT;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp = (tid >> 5) & 3, g = lane >> 2, tq = lane & 3;
  const int ml = warp * 16 + g;               // A rows (columns) ml, ml + 8
  float* sO = sA + TC_STAGES * TC_KT * TC_AS + wg * NR * TC_OS;
  const int r0 = wg * NR;                     // this warpgroup's first row

  // step s: column tile ct0 + s / kt_n, k tile s % kt_n; its A (TC_KT d x
  // 64 columns, zeros past D and L*H) to ring slot s % TC_STAGES
  const int nsteps = nc * kt_n;
  auto stage = [&](int s) {
    if (s < nsteps) {
      const int e0 = (ct0 + s / kt_n) * TC_COLS, d0 = (s % kt_n) * TC_KT;
      float* dst = sA + (s % TC_STAGES) * TC_KT * TC_AS;
      for (int i = tid; i < TC_KT * (TC_COLS / 4); i += TC_THREADS) {
        const int dd = i / (TC_COLS / 4), q = i % (TC_COLS / 4);
        const int d = d0 + dd, e = e0 + 4 * q;
        float* o = dst + dd * TC_AS + 4 * q;
        if (vec_t && d < D && e < LH) {
          const int l = e / H, h = e - l * H;
          cp_async<16>(o, tu + ((size_t)l * D + d) * H + h);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int l = (e + j) / H, h = e + j - l * H;
            if (d < D && e + j < LH)
              cp_async<4>(o + j, tu + ((size_t)l * D + d) * H + h);
            else
              o[j] = 0.f;
          }
        }
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < TC_STAGES - 1; ++i) stage(i);

  // the tile's x rows, hi and lo, value (r, d) at k tile d / 32, row r,
  // 16-byte chunk (d % 32 / 4) ^ (r % 8); zero rows past the tile's. A
  // thread takes chunks of 4 d, TC_XB of them loaded (16 bytes each where
  // x allows) before any is split, so the loads are in flight together
  constexpr int TC_XB = 8;
  const int nq = XR * kt_n * (TC_KT / 4);
  for (int i0 = 0; i0 < nq; i0 += TC_XB * TC_THREADS) {
    float4 v[TC_XB];
#pragma unroll
    for (int u = 0; u < TC_XB; ++u) {
      const int i = i0 + u * TC_THREADS + tid;
      const int r = i / (kt_n * (TC_KT / 4));
      const int d = 4 * (i - r * (kt_n * (TC_KT / 4)));
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < nq && r < nrows && d < D) {
        const float* xr = x + (size_t)perm[start + r] * D;
        if (vec_x) {
          v[u] = ld4(xr + d);
        } else {
          v[u].x = xr[d];
          if (d + 1 < D) v[u].y = xr[d + 1];
          if (d + 2 < D) v[u].z = xr[d + 2];
          if (d + 3 < D) v[u].w = xr[d + 3];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < TC_XB; ++u) {
      const int i = i0 + u * TC_THREADS + tid;
      if (i < nq) {
        const int r = i / (kt_n * (TC_KT / 4));
        const int d = 4 * (i - r * (kt_n * (TC_KT / 4)));
        const int c = (d % TC_KT) >> 2;
        const int o =
            ((d / TC_KT) * XR + r) * TC_KT + ((c ^ (r & 7)) << 2);
        const float vs[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
        float4 hi4, lo4;
        float* h = &hi4.x;
        float* l = &lo4.x;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t hb = tf32_rna(vs[j]);
          h[j] = __uint_as_float(hb);
          l[j] = __uint_as_float(tf32_rna(vs[j] - __uint_as_float(hb)));
        }
        *reinterpret_cast<float4*>(xhi + o) = hi4;
        *reinterpret_cast<float4*>(xlo + o) = lo4;
      }
    }
  }

  // x's tiles are written by the threads and read by wgmma (the async
  // proxy): make the writes visible to it before the first barrier
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  // step s's A fragment to (ah, al), once its stage has landed: k step kk
  // holds (ml, 8kk + tq), (ml + 8, 8kk + tq), (ml, 8kk + tq + 4), (ml + 8,
  // 8kk + tq + 4), split into tf32 hi / lo (zeros past D are staged, so
  // every k tile issues its 4 steps and no wgmma sits on a branch). The
  // barrier also frees step s - 1's slot, which takes step s + 2.
  auto frags = [&](int s, uint32_t (&ah)[TC_KS][4],
                   uint32_t (&al)[TC_KS][4]) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();
    stage(s + TC_STAGES - 1);
    const float* as = sA + (s % TC_STAGES) * TC_KT * TC_AS;
#pragma unroll
    for (int kk = 0; kk < TC_KS; ++kk) {
      const float* a0 = as + (8 * kk + tq) * TC_AS + ml;
      const float* a1 = a0 + 4 * TC_AS;
      const float v[4] = {a0[0], a0[8], a1[0], a1[8]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ah[kk][i] = tf32_rna(v[i]);
        al[kk][i] = tf32_rna(v[i] - __uint_as_float(ah[kk][i]));
      }
    }
  };
  float acc[R], part[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = part[i] = 0.f;
  // step s on the tensor cores from (ah, al); while its products run, step
  // s + 1's fragment is loaded into (nh, nl); then the sum, and at a column
  // tile's last k tile its store
  // column tile ct's sums: accumulator register 4j + 2h + c holds (column
  // ml + 8h, row 8j + 2tq + c), staged (row, column), then each row's 64
  // columns stored; acc zeroed
  auto store = [&](int ct) {
    const int e0 = (ct0 + ct) * TC_COLS;
#pragma unroll
    for (int j = 0; j < NR / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          sO[(8 * j + 2 * tq + c) * TC_OS + ml + 8 * h] =
              acc[4 * j + 2 * h + c];
    __syncthreads();
    for (int i = tid & 127; i < NR * (TC_COLS / 4); i += 128) {
      const int n = i / (TC_COLS / 4), q = i % (TC_COLS / 4);
      const int e = e0 + 4 * q;
      if (r0 + n < nrows && e < LH) {
        float* o = out + (size_t)perm[start + r0 + n] * LH + e;
        const float4 v =
            *reinterpret_cast<const float4*>(sO + n * TC_OS + 4 * q);
        if (vec_out) {
          st4(o, v);
        } else {
          const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (e + j < LH) o[j] = vs[j];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
  };
  // step s on the tensor cores from (ah, al); while its products run, step
  // s + 1's fragment is loaded into (nh, nl) and, at a column tile's first
  // k tile, the last column tile stored; then the sum
  auto step = [&](int s, const uint32_t (&ah)[TC_KS][4],
                  const uint32_t (&al)[TC_KS][4], uint32_t (&nh)[TC_KS][4],
                  uint32_t (&nl)[TC_KS][4]) {
    const int kt = s % kt_n;
    const uint64_t dhi = smem_desc(xhi + (kt * XR + r0) * TC_KT);
    const uint64_t dlo = smem_desc(xlo + (kt * XR + r0) * TC_KT);
    fence_regs<R>(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_KS; ++kk) {
      Wg<NR>::tf32(part, al[kk], dhi + 2 * kk, kk > 0);   // lo * hi
      Wg<NR>::tf32(part, ah[kk], dlo + 2 * kk, 1);        // hi * lo
      Wg<NR>::tf32(part, ah[kk], dhi + 2 * kk, 1);        // hi * hi
    }
    wgmma_commit();
    if (s + 1 < nsteps) frags(s + 1, nh, nl);
    if (kt == 0 && s > 0) store(s / kt_n - 1);
    wgmma_wait_all();
    fence_regs<R>(part);
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] += part[i];
  };
  // two fragment sets, alternating (a register array indexed by a
  // runtime value would live in local memory)
  uint32_t hA[TC_KS][4], lA[TC_KS][4], hB[TC_KS][4], lB[TC_KS][4];
  frags(0, hA, lA);
  for (int s = 0; s < nsteps; s += 2) {
    step(s, hA, lA, hB, lB);
    if (s + 1 < nsteps) step(s + 1, hB, lB, hA, lA);
  }
  store(nc - 1);
  cp_async_wait<0>();
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

// bytes of the tensor-core route's workspace, or 0 where it does not take
// (B, U, D): D <= 40 (q_t_kernel) or past tc_rows' reach
long long tc_work_bytes(int B, int U, int D) {
  if (B <= 0 || U <= 0 || D < TC_MIN_D || tc_rows(D) == 0) return 0;
  return tc_work(B, U, TC_WG * tc_rows(D)).total;
}

template <int NR>
int launch_q_t_tc(const float* x, const float* t, const TcWork& w,
                  unsigned char* work, float* out, int B, int L, int D,
                  int H, cudaStream_t s) {
  const int LH = L * H;
  const int nct = (LH + TC_COLS - 1) / TC_COLS;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  // a run of column tiles a block: enough blocks to fill the card many
  // times over, each reading its rows' x once for its whole run
  const long long want = (long long)sms * TC_BLOCKS_PER_SM;
  int cg = (int)(((long long)w.max_tiles * nct + want - 1) / want);
  cg = max(cg, (nct + MAX_GRID_Y - 1) / MAX_GRID_Y);
  cg = min(max(cg, 1), nct);
  const size_t smem = tc_smem_bytes(D, NR);
  cudaError_t e = cudaFuncSetAttribute(
      q_t_tc_kernel<NR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(w.max_tiles, (nct + cg - 1) / cg);
  const int vec_x = D % 4 == 0 && aligned(x, 16);
  const int vec_t = H % 4 == 0 && aligned(t, 16);
  const int vec_out = LH % 4 == 0 && aligned(out, 16);
  q_t_tc_kernel<NR><<<grid, TC_THREADS, smem, s>>>(
      x, t, reinterpret_cast<const int*>(work + w.perm),
      reinterpret_cast<const int*>(work + w.tiles),
      reinterpret_cast<const int*>(work + w.ntiles), out, L, D, H, cg, vec_x,
      vec_t, vec_out);
  return 0;
}

int run_q_t_tc(const float* x, const float* t, const int* idx, float* out,
               int B, int U, int L, int D, int H, void* work, void* stream) {
  if (B <= 0) return 0;
  const int nr = tc_rows(D);
  if (U <= 0 || D < TC_MIN_D || nr == 0 || work == nullptr ||
      (long long)L * H <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TcWork w = tc_work(B, U, TC_WG * nr);
  unsigned char* wk = static_cast<unsigned char*>(work);
  int* counts = reinterpret_cast<int*>(wk + w.counts);
  ge_sort_hist<<<w.n_t, GS_TILE, 0, s>>>(idx, B, U, counts);
  ge_sort_scan<<<1, 1024, 0, s>>>(counts, w.n_t, U, TC_WG * nr,
                                  reinterpret_cast<int*>(wk + w.tiles),
                                  reinterpret_cast<int*>(wk + w.ntiles));
  ge_sort_scatter<<<w.n_t, GS_TILE, 0, s>>>(
      idx, B, U, counts, reinterpret_cast<int*>(wk + w.perm));
  if (const cudaError_t e = cudaGetLastError()) return (int)e;
  int rc;
  switch (nr) {
    case 64: rc = launch_q_t_tc<64>(x, t, w, wk, out, B, L, D, H, s); break;
    case 32: rc = launch_q_t_tc<32>(x, t, w, wk, out, B, L, D, H, s); break;
    case 16: rc = launch_q_t_tc<16>(x, t, w, wk, out, B, L, D, H, s); break;
    default: rc = launch_q_t_tc<8>(x, t, w, wk, out, B, L, D, H, s); break;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

template <typename T>
int run(int spec, const T* x, const T* t, const int* idx, T* out, int B,
        int U, int d1, int d2, int d3, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (spec) {
    case SPEC_Q_T: {
      const int L = d1, D = d2, H = d3;
      const int LH = L * H;
      const int row_tiles = (B + QT_ROWS - 1) / QT_ROWS;
      const int span = QT_COLS * QT_TILES;
      if (row_tiles > MAX_GRID_Y) return (int)cudaErrorInvalidConfiguration;
      const dim3 grid((LH + span - 1) / span, row_tiles);
      if constexpr (sizeof(T) == 2) {
        const size_t smem = sizeof(bf16) *
                            (2 * QM_BUF + THREADS / 32 * QT_RPW * QM_OS);
        cudaError_t e = cudaFuncSetAttribute(
            q_t_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
        q_t_mma_kernel<<<grid, THREADS, smem, s>>>(
            x, t, idx, out, B, U, L, D, H, H % 8 == 0 && aligned(t, 16),
            LH % 8 == 0 && aligned(out, 16), D % 2 == 0 && aligned(x, 4));
      } else {
        const size_t smem = 2 * sizeof(float) *
                            (QT_SLOTS * QT_KC * QT_COLS + QT_ROWS * QT_KC);
        cudaError_t e = cudaFuncSetAttribute(
            q_t_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
        q_t_kernel<<<grid, THREADS, smem, s>>>(
            x, t, idx, out, B, U, L, D, H, H % 4 == 0 && aligned(t, 16),
            LH % 4 == 0 && aligned(out, 16));
      }
      break;
    }
    case SPEC_W_KEYS:
      w_keys_kernel<T><<<grid_1d((size_t)B, WK_WARPS), 32 * WK_WARPS, 0, s>>>(
          x, t, idx, out, B, U, d1, d2);
      break;
    case SPEC_ROWS_VEC: {
      const int L = d2, H = d1;
      const int rc = H <= RV_G * RV_NC * RV_V
          ? launch_rows_vec<T, RV_NC>(x, t, idx, out, B, U, L, H, s)
          : launch_rows_vec<T, 0>(x, t, idx, out, B, U, L, H, s);
      if (rc != 0) return rc;
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---- the generic route: any spec parse_spec accepts ------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
    generic_kernel(const T* __restrict__ x, const T* __restrict__ t,
                   const int* __restrict__ idx, T* __restrict__ out, int B,
                   int U, const GePlan p) {
  const long long n = (long long)B * p.out_count;
  const int ns = p.n_sum;
  const long long inner = ns ? p.sum_size[ns - 1] : 1;
  const long long ix = ns ? p.sum_x[ns - 1] : 0, it = ns ? p.sum_t[ns - 1] : 0;
  const long long outer = inner ? p.sum_count / inner : 0;
  for (long long e = blockIdx.x * (long long)THREADS + threadIdx.x; e < n;
       e += (long long)gridDim.x * THREADS) {
    const long long b = e / p.out_count;
    long long rem = e - b * p.out_count;
    const int u = clamp_slot(idx[b], U);
    long long xo = b * p.x_row, to = u * p.t_row, oo = b * p.out_row;
#pragma unroll
    for (int i = GE_MAX_DIMS - 1; i >= 0; --i) {
      if (i < p.n_out) {
        const long long c = rem % p.out_size[i];
        rem /= p.out_size[i];
        xo += c * p.out_x[i];
        to += c * p.out_t[i];
        oo += c * p.out_o[i];
      }
    }
    float acc = 0.f;
    for (long long o = 0; o < outer; ++o) {
      long long r = o, xs = xo, ts = to;
#pragma unroll
      for (int i = GE_MAX_DIMS - 2; i >= 0; --i) {
        if (i < ns - 1) {
          const long long c = r % p.sum_size[i];
          r /= p.sum_size[i];
          xs += c * p.sum_x[i];
          ts += c * p.sum_t[i];
        }
      }
      for (long long k = 0; k < inner; ++k)
        acc = fmaf(ld(x + xs + k * ix), ld(t + ts + k * it), acc);
    }
    st(out + oo, acc);
  }
}

template <typename T>
int run_generic(const T* x, const T* t, const int* idx, T* out, int B,
                int U, const GePlan* plan, void* stream) {
  if (B <= 0) return 0;
  if (U <= 0 || plan == nullptr || plan->n_out < 0 ||
      plan->n_out > GE_MAX_DIMS || plan->n_sum < 0 ||
      plan->n_sum > GE_MAX_DIMS || plan->out_count <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)B * (size_t)plan->out_count;
  generic_kernel<T><<<grid_1d(n, THREADS), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, t, idx, out, B,
                                                           U, *plan);
  return (int)cudaGetLastError();
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
  return run(spec, x, t, idx, out, B, U, d1, d2, d3, stream);
}

// The same for bf16 x / table / out (f32 products and sums, out rounded
// once).
int gather_einsum_bf16(int spec, const __nv_bfloat16* x,
                       const __nv_bfloat16* t, const int* idx,
                       __nv_bfloat16* out, int B, int U, int d1, int d2,
                       int d3, void* stream) {
  return run(spec, x, t, idx, out, B, U, d1, d2, d3, stream);
}

// Any other spec (see the note at the top): x, table and out contiguous,
// int32 idx (B,), the plan by pointer (copied into the launch). Launches
// on `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError() after the launch (0 = launched).
int gather_einsum_generic_f32(const float* x, const float* t, const int* idx,
                              float* out, int B, int U, const GePlan* plan,
                              void* stream) {
  return run_generic(x, t, idx, out, B, U, plan, stream);
}

// The same for bf16 x / table / out (f32 products and sums, out rounded
// once).
int gather_einsum_generic_bf16(const __nv_bfloat16* x,
                               const __nv_bfloat16* t, const int* idx,
                               __nv_bfloat16* out, int B, int U,
                               const GePlan* plan, void* stream) {
  return run_generic(x, t, idx, out, B, U, plan, stream);
}

// The tensor-core route of SPEC_Q_T in fp32 (x (B, D), table (U, L, D,
// H), out (B, L, H), int32 idx (B,); see the note at the top): bytes of
// the workspace it takes, or 0 where it does not take the call (D <= 40,
// where gather_einsum_f32's CUDA-core kernel runs, or D past 1024).
long gather_einsum_q_t_work_bytes(int B, int U, int D) {
  return (long)tc_work_bytes(B, U, D);
}

// That route: `work` (gather_einsum_q_t_work_bytes of device memory,
// aligned to 256 bytes) is scratch. Four launches on `stream` (the
// counting sort's three, then the tiles), no allocation, no
// synchronisation. Returns cudaGetLastError() after the launches (0 =
// launched).
int gather_einsum_q_t_tc_f32(const float* x, const float* t, const int* idx,
                             float* out, int B, int U, int L, int D, int H,
                             void* work, void* stream) {
  return run_q_t_tc(x, t, idx, out, B, U, L, D, H, work, stream);
}

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
