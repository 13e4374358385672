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
// 0.018 ms at 67 TFLOP/s fp32: bound by the bytes it writes. So the FMAs
// stay exact fp32 on the CUDA cores; tensor cores would buy nothing
// against the store stream. SPEC_W_KEYS reads (B, L), writes (B, D) and
// does 2 * B * L * D = 15 MFLOP: its bound (0.0006 ms) is below a launch's
// latency, so it is bound by the latency of its loads and sums.
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
// j + 32, ... of its row's user (each a contiguous row of D floats, so the
// warp's loads are coalesced), weighted by the row's weights, into 32
// columns in registers; then a reduce-scatter of shuffles in a fixed tree
// leaves column d's sum in lane d. The order over l is fixed (per lane,
// then the tree), whatever B. SPEC_ROWS_VEC (on no path): one thread per
// (row, l), looping over H.
//
// bf16 (gather_einsum_bf16): x, table and out in bf16, every product and
// sum in f32 (the TPU kernel's preferred_element_type), the output rounded
// once. The same kernels, instantiated for bf16: each operand is widened
// to fp32 as it is loaded, into the same shared-memory buffers and
// registers (the staged copies then go through registers instead of
// cp.async, so a step's loads no longer overlap the step before). The
// arithmetic and its order are the fp32 kernel's, so a bf16 call gives the
// fp32 kernel's result on the widened operands, rounded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ int clamp_slot(int s, int U) {
  return s < 0 ? 0 : (s >= U ? U - 1 : s);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
      (unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
      (unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// loads of an operand, widened to fp32: 1, 2 or 4 consecutive values (2
// and 4 aligned to their size)
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(r.x << 16),
                     __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16),
                     __uint_as_float(r.y & 0xffff0000u));
}

// copies of an operand into fp32 shared memory: fp32 asynchronously
// (cp.async), bf16 widened through registers
__device__ __forceinline__ void stage1(float* dst, const float* src) {
  cp_async4(dst, src);
}
__device__ __forceinline__ void stage1(float* dst, const __nv_bfloat16* src) {
  *dst = ld(src);
}
__device__ __forceinline__ void stage4(float* dst, const float* src) {
  cp_async16(dst, src);
}
__device__ __forceinline__ void stage4(float* dst, const __nv_bfloat16* src) {
  *reinterpret_cast<float4*>(dst) = ld4(src);
}

// stores of an output: fp32 as it is, bf16 rounded once
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// one staged step of SPEC_Q_T: T[user, l(e), d, h(e)] of the tile's nk
// users for QT_KC values of d and ntc tiles of QT_COLS columns (slot
// tc * nk + k),
// and the rows' x for the same d, copied asynchronously (16 bytes where H
// is a multiple of 4, so that a quad of columns lies in one l; zeros past
// D and L*H)
template <typename T>
__device__ __forceinline__ void qt_stage(
    float* sT, float* sX, const T* __restrict__ x,
    const T* __restrict__ t, const int* sUser, int row0, int nrows,
    int e0, int ntc, int nk, int d0, int D, int H, int LH, int vec_t) {
  for (int i = threadIdx.x; i < ntc * nk * QT_KC * (QT_COLS / 4);
       i += THREADS) {
    const int q = i % (QT_COLS / 4), rest = i / (QT_COLS / 4);
    const int dd = rest % QT_KC, slot = rest / QT_KC;
    const int tc = slot / nk, k = slot - tc * nk;
    const int d = d0 + dd, e = e0 + tc * QT_COLS + 4 * q;
    float* dst = sT + (slot * QT_KC + dd) * QT_COLS + 4 * q;
    const T* tu = t + (size_t)sUser[k] * LH * D;
    if (vec_t && d < D && e < LH) {
      const int l = e / H, h = e - l * H;
      stage4(dst, tu + ((size_t)l * D + d) * H + h);
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
    const float4 xv = *reinterpret_cast<const float4*>(xr + dd);
    const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[0] = fmaf(xs[j], tv[dd + j].x, acc[0]);
      acc[1] = fmaf(xs[j], tv[dd + j].y, acc[1]);
    }
  }
}

// a lane's (QT_KC x 2) slice of T from global memory (L2): columns e, e + 1
// for d0 .. d0 + QT_KC - 1, zeros past D and L*H (8 bytes where H is a
// multiple of 4, so that both columns lie in one l)
template <typename T>
__device__ __forceinline__ void qt_load(float2* tv, const T* tu, int e,
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
template <typename T>
__device__ __forceinline__ void qt_store(float (*acc)[2], const int* rows,
                                         int nrows, T* out, int LH, int c,
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
      T* o = out + (size_t)r * LH + c0;
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

// out[b, l, h] = sum_d x[b, d] * t[u_b, l, d, h]
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
q_t_kernel(const T* __restrict__ x, const T* __restrict__ t,
           const int* __restrict__ idx, T* __restrict__ out, int B,
           int U, int L, int D, int H, int vec_t, int vec_out) {
  // two buffers of (QT_SLOTS x QT_KC x QT_COLS) T and (QT_ROWS x QT_KC) x
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

  // ---- the distinct users of the rows, numbered in row order: a warp
  // per 32 rows finds each row's first row of its user (match within its
  // 32, then a scan of the rows before them), ballots count the firsts ---
  constexpr int kGroups = QT_ROWS / 32;
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
                        ? ld(x + (size_t)(row0 + r) * D + d0 + dd) : 0.f;
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
             ebase + p.ct0 * QT_COLS, p.ntc, distinct, p.d0, D, H, LH,
             vec_t);
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
          tv[dd] = *reinterpret_cast<const float2*>(
              sT + (ord[0] * QT_KC + dd) * QT_COLS + 2 * lane);
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
              tv[dd] = *reinterpret_cast<const float2*>(
                  sT + (ord[i] * QT_KC + dd) * QT_COLS + 2 * lane);
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
  // weights; the unguarded sums of the last row read into the weights,
  // never stored
  constexpr int kBuf = 32 * WK_D + 32;
  __shared__ __align__(16) float sbuf[WK_WARPS][2][kBuf];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int b = blockIdx.x * WK_WARPS + warp; b < B;
       b += gridDim.x * WK_WARPS) {
    const T* xr = x + (size_t)b * L;
    const T* tu = t + (size_t)clamp_slot(idx[b], U) * L * D;
    for (int d0 = 0; d0 < D; d0 += WK_D) {
      const int nd = min(WK_D, D - d0);
      // chunk c's keys and weights, copied asynchronously (bf16: widened
      // through registers): 4 values at once where the chunk is one
      // aligned run (D <= 32 and 4 | 32 * D)
      auto stage = [&](int c) {
        float* sk = sbuf[warp][c & 1];
        const int l0 = c * 32, nl = min(32, L - l0), n = nl * nd;
        const T* src = tu + (size_t)l0 * D + d0;
        if (nd == D && n % 4 == 0 &&
            (reinterpret_cast<uintptr_t>(src) & (4 * sizeof(T) - 1)) == 0) {
          for (int i = lane; i < n / 4; i += 32)
            stage4(sk + 4 * i, src + 4 * i);
        } else {
          for (int i = lane; i < n; i += 32) {
            const int l = i / nd;
            stage1(sk + i, src + (size_t)l * D + (i - l * nd));
          }
        }
        if (lane < nl) stage1(sk + 32 * WK_D + lane, xr + l0 + lane);
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
        const float* sk = sbuf[warp][c & 1];
        if (c * 32 + lane < L) {
          const float w = sk[32 * WK_D + lane];
#pragma unroll
          for (int j = 0; j < WK_D; ++j)
            acc[j] = fmaf(w, sk[lane * nd + j], acc[j]);
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

// out[b, l] = sum_h x[b, l, h] * t[u_b, h]
template <typename T>
__global__ void __launch_bounds__(THREADS)
rows_vec_kernel(const T* __restrict__ x, const T* __restrict__ t,
                const int* __restrict__ idx, T* __restrict__ out,
                int B, int U, int L, int H) {
  const size_t n = (size_t)B * L;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(e / L);
    const T* xp = x + e * H;
    const T* tp = t + (size_t)clamp_slot(idx[b], U) * H;
    float acc = 0.f;
    for (int h = 0; h < H; ++h) acc = fmaf(ld(xp + h), ld(tp + h), acc);
    st(out + e, acc);
  }
}

int grid_1d(size_t n, int per_block) {
  const size_t blocks = (n + per_block - 1) / per_block;
  return (int)(blocks < 1048576 ? blocks : 1048576);
}

// whether p starts a run of 4 values of T (16 bytes of fp32, 8 of bf16)
template <typename T>
bool aligned4(const T* p) {
  return (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(T) - 1)) == 0;
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
      const size_t smem = 2 * sizeof(float) *
                          (QT_SLOTS * QT_KC * QT_COLS + QT_ROWS * QT_KC);
      cudaError_t e = cudaFuncSetAttribute(
          q_t_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
      const dim3 grid((LH + span - 1) / span, row_tiles);
      q_t_kernel<T><<<grid, THREADS, smem, s>>>(
          x, t, idx, out, B, U, L, D, H, H % 4 == 0 && aligned4(t),
          LH % 4 == 0 && aligned4(out));
      break;
    }
    case SPEC_W_KEYS:
      w_keys_kernel<T><<<grid_1d((size_t)B, WK_WARPS), 32 * WK_WARPS, 0, s>>>(
          x, t, idx, out, B, U, d1, d2);
      break;
    case SPEC_ROWS_VEC:
      rows_vec_kernel<T><<<grid_1d((size_t)B * d2, THREADS), THREADS, 0, s>>>(
          x, t, idx, out, B, U, d2, d1);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
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

const char* repro_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
