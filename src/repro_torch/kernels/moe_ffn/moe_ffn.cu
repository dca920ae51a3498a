// Fused per-expert SwiGLU over capacity-dispatched tokens, for sm_90a.
//
// Replaces the Pallas TPU kernel `moe_expert_ffn` (src/repro/kernels/
// moe_ffn/kernel.py, body `_moe_ffn_kernel`), which the JAX model reaches
// from moe._expert_ffn on every MoE layer of a prefill and of a decode step.
// Same function as the JAX package's `expert_ffn_ref`: for each group g,
// expert e and capacity row c,
//   out[g,e,c,:] = (silu(x[g,e,c,:] Wg_e) * (x[g,e,c,:] Wu_e)) Wd_e
// with x (G,E,C,D), Wg/Wu (E,D,F), Wd (E,F,D) of one dtype (fp32 or
// bf16), every sum in fp32, the result in that dtype. A row of zeros (an
// empty or dropped capacity slot) gives a row of zeros.
//
// What bounds it on this card: the expert weights. At granite-moe-1b's
// serving shapes (G=1, E=32, D=1024, F=512, bf16) one launch reads
// 3*E*D*F*2 B = 100.7 MB of weights -> 30.0 us at 3.35 TB/s, whatever C is
// (C = 4 per decode tick, 10/20/30 per prefill bucket); the 0.4-3.0 GFLOP
// take 0.4-3.1 us at the bf16 tensor-core peak. With 4096 tokens (G=8,
// C=160) the 129 GFLOP take 0.130 ms at that peak: operations bound.
//
// What the design does about it:
// - one thread-block cluster per (expert, tile of capacity rows). The rows
//   of a tile are the expert's rows across all groups (row m = g*C + c), so
//   at G > 1 a weight tile is reused by every row of the tile instead of
//   being streamed once per group; at the serving shapes (G=1, C <= 30) one
//   tile holds all rows and each weight byte is read once per launch;
// - the cluster's nf blocks split F for the gate/up products (block r owns
//   h[:, r*fr : (r+1)*fr]) and then D for the down-projection (block r owns
//   out[:, r*dr : (r+1)*dr]). Between the two, every block copies its
//   peers' parts of h through distributed shared memory, so each block sums
//   its outputs over all of F itself, in one fixed order: no scratch in
//   device memory, no second kernel, no atomics, and a run repeats itself
//   bit for bit (a one-ulp change in a layer can flip a later top-k
//   choice). At the serving shapes: 32 clusters of 4 blocks;
// - weights stream through a ring of four shared-memory stages filled by
//   16-byte cp.async from all threads (~56 KB in flight a block). The depth
//   chunks of the gate/up products and of the down-projection form one
//   sequence, so Wd's first chunks are in flight while the cluster
//   exchanges h. A block of 16 or 32 rows takes at most half an SM's shared
//   memory: at one block an SM the H100 cannot hold all 32 clusters of 4 at
//   once, and a second wave doubles the time;
// - bf16: both products on the tensor cores (mma.sync m16n8k16, bf16
//   operands, fp32 accumulators; fragments by ldmatrix, .trans for the
//   k-major weights). silu(g) * u is taken in fp32 in registers and h is
//   rounded to bf16 as the A operand of the down-projection, as the
//   attention kernels round P before P.V. Rows are padded to 16;
// - fp32: FMA on the CUDA cores (TF32 would miss the fp32 limit), each
//   thread a 4 x 4 register tile per output, operands read as float4, h
//   kept in fp32.
// The h of one row tile, (bm, F), stays in shared memory. Where it cannot
// (F beyond ~4.8k in bf16 at 16 rows, ~2.4k at 32, ~1.2k in fp32; grok-1's
// F is 32768), the block cuts F
// into slabs of nf * fr columns whose h fits and runs the two phases once a
// slab; the D columns it owns are summed over a slab as above and across
// slabs, in slab order, through an fp32 workspace in device memory that
// only the owning thread reads and writes. Still one launch, no atomics.
// The wrapper's plan (ops.py) picks the slab width and passes the shared
// memory size it expects, which the entry checks against Smem::bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "../sm90.cuh"

namespace {

using namespace sm90;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;       // ring of staged depth chunks
constexpr int kPassA = 128;      // F columns of one gate/up pass
constexpr int kPassB = 256;      // D columns of one down-projection pass
constexpr int kMaxCluster = 8;   // portable cluster size
constexpr size_t kMaxSmem = 232448;  // per block, sm_90

// Tile geometry of a dtype. BK: depth of a staged chunk (64 bytes of an x
// row). PAD: elements added to every shared-memory row, so that a row
// stride is an odd number of 16-byte groups and the 8 rows of an ldmatrix
// (or 8 lanes of a float4 phase) hit 8 different bank groups.
template <typename T>
struct Geo;
template <>
struct Geo<bf16> {
  static constexpr int BK = 32, PAD = 8;
};
template <>
struct Geo<float> {
  static constexpr int BK = 16, PAD = 4;
};

// Shared memory of a block: bm row offsets, kStages stages of [sX (bm,
// LDX) | sWg, sWu (BK, LDA) each, or sWd (BK, LDB)], then h (bm, ldh) of
// fw columns (F, or the slab width where F is cut). The wrapper's plan
// (ops.py) mirrors bytes().
template <typename T>
struct Smem {
  static constexpr int BK = Geo<T>::BK, PAD = Geo<T>::PAD;
  static constexpr int LDX = BK + PAD;
  static constexpr int LDA = kPassA + PAD;
  static constexpr int LDB = kPassB + PAD;
  static constexpr int W = 2 * BK * LDA > BK * LDB ? 2 * BK * LDA : BK * LDB;
  // depth of the down-projection: F rounded up to BK
  __host__ __device__ static int kf(int F) { return (F + BK - 1) / BK * BK; }
  __host__ __device__ static int ldh(int F) { return (F + 31) / 32 * 32 + PAD; }
  __host__ __device__ static int stage(int bm) { return bm * LDX + W; }
  static size_t bytes(int bm, int fw) {
    return sizeof(long long) * bm +
           sizeof(T) * ((size_t)kStages * stage(bm) + (size_t)bm * ldh(fw));
  }
};

template <typename T>
struct Args {
  const T* x;
  const T* wg;
  const T* wu;
  const T* wd;
  T* out;
  float* ws;   // (G,E,C,D) fp32 sums across slabs; null with one slab
  int G, E, C, D, F;
  int fr, dr;  // F and D columns per block of a cluster
  int fs;      // F columns of a slab (nf * fr)
  bool vec;    // 16-byte copies (D, F and the pointers allow them)
};

// Stage a (rows, COLS) tile into dst (row stride ld): element (r, c) from
// src(r) + c, zero where src(r) is null or c >= valid. With vec, 16-byte
// cp.async (COLS and valid are multiples of 16 bytes); else plain loads.
template <typename T, int COLS, typename Src>
__device__ __forceinline__ void stage_tile(T* dst, int ld, int rows,
                                           int valid, bool vec,
                                           const T* any, Src src) {
  if (vec) {
    constexpr int V = 16 / sizeof(T), PER = COLS / V;
    for (int i = threadIdx.x; i < rows * PER; i += kThreads) {
      const int r = i / PER, c = (i % PER) * V;
      const T* s = src(r);
      const bool ok = s != nullptr && c < valid;
      cp_async<16>(dst + r * ld + c, ok ? s + c : any, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * COLS; i += kThreads) {
      const int r = i / COLS, c = i % COLS;
      const T* s = src(r);
      dst[r * ld + c] = (s != nullptr && c < valid) ? s[c] : zero_of<T>();
    }
  }
}

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

__device__ __forceinline__ float at(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Output element i of a slab's sum v: added to the earlier slabs' sum in
// the workspace, and stored there, or in out after the last slab. With one
// slab (first and last) it goes straight to out.
template <typename T>
__device__ __forceinline__ void emit(T* out, float* ws, long long i, float v,
                                     bool first, bool last) {
  if (!first) v += ws[i];
  if (last)
    store_f(out + i, v);
  else
    ws[i] = v;
}

// ---- bf16: tensor cores. Warp w owns columns [16w, 16w + 16) of a
// gate/up pass (two n-tiles of 8 per product) and [32w, 32w + 32) of a
// down-projection pass (four n-tiles), all rows.

template <int MT>
__device__ __forceinline__ void tc_a(float (&g)[MT][2][4],
                                     float (&u)[MT][2][4], const bf16* sX,
                                     const bf16* sWg, const bf16* sWu) {
  using S = Smem<bf16>;
  const int w = threadIdx.x >> 5;
#pragma unroll
  for (int kk = 0; kk < S::BK / 16; ++kk) {
    uint32_t av[MT][4], bg[4], bu[4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(av[mt], sX + (16 * mt + a_row()) * S::LDX + kk * 16 + a_col());
    ldsm_x4_t(bg, sWg + (kk * 16 + v_row()) * S::LDA + w * 16 + v_col());
    ldsm_x4_t(bu, sWu + (kk * 16 + v_row()) * S::LDA + w * 16 + v_col());
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_bf16(g[mt][0], av[mt], bg[0], bg[1]);
      mma_bf16(g[mt][1], av[mt], bg[2], bg[3]);
      mma_bf16(u[mt][0], av[mt], bu[0], bu[1]);
      mma_bf16(u[mt][1], av[mt], bu[2], bu[3]);
    }
  }
}

// h = silu(g) * u of the pass at column col0 into sH (bf16), columns < kf.
template <int MT>
__device__ __forceinline__ void tc_a_done(float (&g)[MT][2][4],
                                          float (&u)[MT][2][4], bf16* sH,
                                          int ldh, int col0, int kf) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = col0 + w * 16 + 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = 16 * mt + (lane >> 2) + 8 * hi;
        if (col < kf)
          *reinterpret_cast<uint32_t*>(sH + row * ldh + col) =
              pack_bf16(silu_mul(g[mt][j][2 * hi], u[mt][j][2 * hi]),
                        silu_mul(g[mt][j][2 * hi + 1], u[mt][j][2 * hi + 1]));
        g[mt][j][2 * hi] = g[mt][j][2 * hi + 1] = 0.f;
        u[mt][j][2 * hi] = u[mt][j][2 * hi + 1] = 0.f;
      }
    }
}

template <int MT>
__device__ __forceinline__ void tc_b(float (&o)[MT][4][4], const bf16* sH,
                                     int ldh, int k0, const bf16* sWd) {
  using S = Smem<bf16>;
  const int c0 = (threadIdx.x >> 5) * 32;
#pragma unroll
  for (int kk = 0; kk < S::BK / 16; ++kk) {
    uint32_t av[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(av[mt], sH + (16 * mt + a_row()) * ldh + k0 + kk * 16 + a_col());
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, sWd + (kk * 16 + v_row()) * S::LDB + c0 + np * 16 + v_col());
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(o[mt][2 * np], av[mt], b[0], b[1]);
        mma_bf16(o[mt][2 * np + 1], av[mt], b[2], b[3]);
      }
    }
  }
}

template <int MT>
__device__ __forceinline__ void tc_b_done(float (&o)[MT][4][4], bf16* out,
                                          float* ws, bool first, bool last,
                                          const long long* sRow, int rows,
                                          int col0, int D) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = 16 * mt + (lane >> 2) + 8 * hi;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + w * 32 + 8 * j + 2 * (lane & 3);
        if (row < rows) {
          const long long i = sRow[row] + col;
          if (col < D) emit(out, ws, i, o[mt][j][2 * hi], first, last);
          if (col + 1 < D)
            emit(out, ws, i + 1, o[mt][j][2 * hi + 1], first, last);
        }
        o[mt][j][2 * hi] = o[mt][j][2 * hi + 1] = 0.f;
      }
    }
}

// ---- fp32: CUDA cores. Thread (ty =
// warp, tx = lane) owns rows 4ty..4ty+3 and columns 4tx..4tx+3 of a gate/up
// pass (both products), and columns 4tx..4tx+3 and 128+4tx..128+4tx+3 of
// a down-projection pass.

__device__ __forceinline__ void fma_a(float (&g)[4][4], float (&u)[4][4],
                                      const float* sX, const float* sWg,
                                      const float* sWu) {
  using S = Smem<float>;
  const int ty = threadIdx.x >> 5, tx = threadIdx.x & 31;
#pragma unroll
  for (int k4 = 0; k4 < S::BK; k4 += 4) {
    float4 xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      xv[i] = *reinterpret_cast<const float4*>(sX + (4 * ty + i) * S::LDX + k4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 wg =
          *reinterpret_cast<const float4*>(sWg + (k4 + kk) * S::LDA + 4 * tx);
      const float4 wu =
          *reinterpret_cast<const float4*>(sWu + (k4 + kk) * S::LDA + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xs = at(xv[i], kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          g[i][j] = fmaf(xs, at(wg, j), g[i][j]);
          u[i][j] = fmaf(xs, at(wu, j), u[i][j]);
        }
      }
    }
  }
}

__device__ __forceinline__ void fma_a_done(float (&g)[4][4], float (&u)[4][4],
                                           float* sH, int ldh, int col0,
                                           int kf) {
  const int ty = threadIdx.x >> 5, tx = threadIdx.x & 31;
  const int col = col0 + 4 * tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (col < kf)
      *reinterpret_cast<float4*>(sH + (4 * ty + i) * ldh + col) = make_float4(
          silu_mul(g[i][0], u[i][0]), silu_mul(g[i][1], u[i][1]),
          silu_mul(g[i][2], u[i][2]), silu_mul(g[i][3], u[i][3]));
#pragma unroll
    for (int j = 0; j < 4; ++j) g[i][j] = u[i][j] = 0.f;
  }
}

__device__ __forceinline__ void fma_b(float (&o)[4][8], const float* sH,
                                      int ldh, int k0, const float* sWd) {
  using S = Smem<float>;
  const int ty = threadIdx.x >> 5, tx = threadIdx.x & 31;
#pragma unroll
  for (int k4 = 0; k4 < S::BK; k4 += 4) {
    float4 hv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      hv[i] = *reinterpret_cast<const float4*>(sH + (4 * ty + i) * ldh + k0 +
                                               k4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* wrow = sWd + (k4 + kk) * S::LDB + 4 * tx;
      const float4 w0 = *reinterpret_cast<const float4*>(wrow);
      const float4 w1 = *reinterpret_cast<const float4*>(wrow + kPassB / 2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float hs = at(hv[i], kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          o[i][j] = fmaf(hs, at(w0, j), o[i][j]);
          o[i][4 + j] = fmaf(hs, at(w1, j), o[i][4 + j]);
        }
      }
    }
  }
}

__device__ __forceinline__ void fma_b_done(float (&o)[4][8], float* out,
                                           float* ws, bool first, bool last,
                                           const long long* sRow, int rows,
                                           int col0, int D) {
  const int ty = threadIdx.x >> 5, tx = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + 4 * tx + (j & 3) + (j >> 2) * (kPassB / 2);
      if (row < rows && col < D)
        emit(out, ws, sRow[row] + col, o[i][j], first, last);
      o[i][j] = 0.f;
    }
  }
}

// One block: rank r of the cluster of (row tile blockIdx.y, expert
// blockIdx.z). MT: 16-row tiles of a bf16 block (fp32 blocks hold 32 rows).
// SLABS: F is cut into slabs (else one slab holds it, and the per-chunk
// slab arithmetic folds away: at decode a chunk is little work, so it
// would show).
template <typename T, int MT, bool SLABS>
__global__ void __launch_bounds__(kThreads, 2)
    moe_ffn_kernel(const Args<T> a) {
  using S = Smem<T>;
  constexpr bool kTc = std::is_same<T, bf16>::value;
  constexpr int BM = kTc ? 16 * MT : 32;
  constexpr int BK = S::BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* sRow = reinterpret_cast<long long*>(smem_raw);
  T* sStage = reinterpret_cast<T*>(smem_raw + sizeof(long long) * BM);
  T* sH = sStage + kStages * S::stage(BM);
  const int D = a.D, F = a.F, fs = a.fs;
  const int ldh = S::ldh(min(fs, F));

  const int rank = blockIdx.x, nf = gridDim.x, e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int rows = min(BM, a.G * a.C - m0);
  // the tile's rows: row m = g*C + c of expert e, -1 past the last
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    long long off = -1;
    if (r < rows) {
      const int m = m0 + r, g = m / a.C, c = m - g * a.C;
      off = ((long long)(g * a.E + e) * a.C + c) * a.D;
    }
    sRow[r] = off;
  }
  __syncthreads();

  // Per slab (F columns [s*fs, s*fs + fs)): the depth of its
  // down-projection (its columns rounded up to BK), its gate/up chunks and
  // its down chunks; of the first slab (*0) and the last (*1), the only one
  // that may be narrower.
  const int f0 = rank * a.fr, d0 = rank * a.dr;
  const int slabs = SLABS ? (F + fs - 1) / fs : 1, fs1 = (slabs - 1) * fs;
  const int npb = (max(0, min(a.dr, D - d0)) + kPassB - 1) / kPassB;
  const int nka = (D + BK - 1) / BK;
  const int kf0 = S::kf(min(fs, F)), kf1 = S::kf(F - fs1);
  const int na0 = (max(0, min(a.fr, F - f0)) + kPassA - 1) / kPassA * nka;
  const int na1 =
      (max(0, min(a.fr, F - fs1 - f0)) + kPassA - 1) / kPassA * nka;
  const int len0 = na0 + npb * (kf0 / BK);  // chunks of a whole slab
  const int n = (slabs - 1) * len0 + na1 + npb * (kf1 / BK);
  const T* wg = a.wg + (size_t)e * D * F;
  const T* wu = a.wu + (size_t)e * D * F;
  const T* wd = a.wd + (size_t)e * F * D;

  // issue the copies of depth chunk i (a slab's gate/up chunks, then its
  // down chunks, slab after slab)
  auto issue = [&](int i) {
    if (i < n) {
      T* st = sStage + (i % kStages) * S::stage(BM);
      const int s = SLABS ? min(i / len0, slabs - 1) : 0, j = i - s * len0;
      const int fs0 = s * fs, nas = s < slabs - 1 ? na0 : na1;
      if (j < nas) {
        const int k0 = (j % nka) * BK, fc = fs0 + f0 + (j / nka) * kPassA;
        stage_tile<T, BK>(st, S::LDX, BM, D - k0, a.vec, wg,
                          [&](int r) -> const T* {
                            return sRow[r] < 0 ? nullptr : a.x + sRow[r] + k0;
                          });
        T* sw = st + BM * S::LDX;
        stage_tile<T, kPassA>(sw, S::LDA, BK, F - fc, a.vec, wg,
                          [&](int r) -> const T* {
                            return k0 + r < D ? wg + (size_t)(k0 + r) * F + fc
                                              : nullptr;
                          });
        stage_tile<T, kPassA>(sw + BK * S::LDA, S::LDA, BK, F - fc, a.vec, wg,
                          [&](int r) -> const T* {
                            return k0 + r < D ? wu + (size_t)(k0 + r) * F + fc
                                              : nullptr;
                          });
      } else {
        const int nkb = (s < slabs - 1 ? kf0 : kf1) / BK, jb = j - nas;
        const int k0 = fs0 + (jb % nkb) * BK, dc = d0 + (jb / nkb) * kPassB;
        stage_tile<T, kPassB>(st + BM * S::LDX, S::LDB, BK, D - dc, a.vec, wg,
                          [&](int r) -> const T* {
                            return k0 + r < F ? wd + (size_t)(k0 + r) * D + dc
                                              : nullptr;
                          });
      }
    }
    cp_async_commit();
  };
  // wait for chunk i, then refill the stage that chunk i - 1 used
  auto next = [&](int i) -> const T* {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(i + kStages - 1);
    return sStage + (i % kStages) * S::stage(BM);
  };

  for (int s = 0; s < kStages - 1; ++s) issue(s);

  for (int s = 0, i = 0; s < slabs; ++s) {
    const bool whole = s < slabs - 1;
    const int nas = whole ? na0 : na1, kfs = whole ? kf0 : kf1;
    const int nkb = kfs / BK, nbs = npb * nkb;
    const bool first = s == 0, last = s == slabs - 1;
    // the peers have copied this block's h of the last slab
    if (!first) cluster_wait();

    // ---- gate and up for the block's F columns of the slab, h into sH
    if constexpr (kTc) {
      float g[MT][2][4] = {}, u[MT][2][4] = {};
      for (int j = 0; j < nas; ++j, ++i) {
        const T* st = next(i);
        const T* sw = st + BM * S::LDX;
        tc_a<MT>(g, u, st, sw, sw + BK * S::LDA);
        if (j % nka == nka - 1)
          tc_a_done<MT>(g, u, sH, ldh, f0 + (j / nka) * kPassA, kfs);
      }
    } else {
      float g[4][4] = {}, u[4][4] = {};
      for (int j = 0; j < nas; ++j, ++i) {
        const T* st = next(i);
        const T* sw = st + BM * S::LDX;
        fma_a(g, u, st, sw, sw + BK * S::LDA);
        if (j % nka == nka - 1)
          fma_a_done(g, u, sH, ldh, f0 + (j / nka) * kPassA, kfs);
      }
    }

    // ---- every block copies its peers' parts of h (distributed shared
    // memory); then none may change its h, or leave, before all have
    // copied (the wait of the next slab, or the final one)
    cluster_arrive();
    cluster_wait();
    constexpr int V = 16 / sizeof(T);
    for (int q = 0; q < nf; ++q) {
      const int c0 = q * a.fr, c1 = min(kfs, c0 + a.fr);
      if (q == rank || c1 <= c0) continue;
      const int per = (c1 - c0) / V;
      for (int t = threadIdx.x; t < BM * per; t += kThreads) {
        const int r = t / per;
        T* p = sH + r * ldh + c0 + (t - r * per) * V;
        *reinterpret_cast<uint4*>(p) = ld_peer16(peer_addr(p, q));
      }
    }
    __syncthreads();
    cluster_arrive();

    // ---- the block's D columns, summed over the slab's F
    if constexpr (kTc) {
      float o[MT][4][4] = {};
      for (int j = 0; j < nbs; ++j, ++i) {
        const T* st = next(i);
        tc_b<MT>(o, sH, ldh, (j % nkb) * BK, st + BM * S::LDX);
        if (j % nkb == nkb - 1)
          tc_b_done<MT>(o, a.out, a.ws, first, last, sRow, rows,
                        d0 + (j / nkb) * kPassB, D);
      }
    } else {
      float o[4][8] = {};
      for (int j = 0; j < nbs; ++j, ++i) {
        const T* st = next(i);
        fma_b(o, sH, ldh, (j % nkb) * BK, st + BM * S::LDX);
        if (j % nkb == nkb - 1)
          fma_b_done(o, a.out, a.ws, first, last, sRow, rows,
                     d0 + (j / nkb) * kPassB, D);
      }
    }
  }
  cp_async_wait<0>();
  cluster_wait();
}

template <typename T, int MT>
int launch(const Args<T>& a, int nf, size_t smem, cudaStream_t stream) {
  constexpr int BM = std::is_same<T, bf16>::value ? 16 * MT : 32;
  if (smem != Smem<T>::bytes(BM, min(a.fs, a.F)) || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  auto kernel = a.fs < a.F ? moe_ffn_kernel<T, MT, true>
                           : moe_ffn_kernel<T, MT, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nf, (a.G * a.C + BM - 1) / BM, a.E);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nf;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* wg, const void* wu, const void* wd,
             void* out, void* ws, int G, int E, int C, int D, int F, int nf,
             int fr, int dr, int bm, size_t smem, cudaStream_t stream) {
  const int es = (int)sizeof(T);
  bool vec = (D * es) % 16 == 0 && (F * es) % 16 == 0;
  for (const void* p : {x, wg, wu, wd}) vec = vec && (uintptr_t)p % 16 == 0;
  const Args<T> a{(const T*)x, (const T*)wg, (const T*)wu, (const T*)wd,
                  (T*)out,     (float*)ws,   G, E, C, D, F, fr, dr, nf * fr,
                  vec};
  if constexpr (std::is_same<T, float>::value) {
    if (bm != 32) return (int)cudaErrorInvalidValue;
    return launch<float, 2>(a, nf, smem, stream);
  } else {
    if (bm == 16) return launch<bf16, 1>(a, nf, smem, stream);
    if (bm == 32) return launch<bf16, 2>(a, nf, smem, stream);
    return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (G,E,C,D), wg/wu (E,D,F), wd (E,F,D), out (G,E,C,D), all contiguous
// and of one dtype (0 = float32, 1 = bfloat16). The plan (ops.py::plan):
// clusters of nf blocks, block r owning F columns [r*fr, (r+1)*fr) of each
// slab of nf*fr columns and D columns [r*dr, (r+1)*dr) (multiples of 128
// and 256); tiles of bm capacity rows (16 or 32 in bf16, 32 in fp32); smem
// bytes of shared memory a block, checked against the kernel's own count.
// ws: an fp32 (G,E,C,D) workspace where F takes more than one slab, else
// null. Launches on `stream` and returns the CUDA error code (0 = ok).
extern "C" int moe_ffn_launch(const void* x, const void* wg, const void* wu,
                              const void* wd, void* out, void* ws, int G,
                              int E, int C, int D, int F, int dtype, int nf,
                              int fr, int dr, int bm, long long smem,
                              void* stream) {
  if (G <= 0 || E <= 0 || C <= 0 || D <= 0 || F <= 0 || E > 65535 ||
      nf < 1 || nf > kMaxCluster || fr <= 0 || fr % kPassA != 0 ||
      dr <= 0 || dr % kPassB != 0 || (long long)nf * dr < D ||
      (ws == nullptr && (long long)nf * fr < F) || bm <= 0 || smem <= 0 ||
      ((long long)G * C + bm - 1) / bm > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(x, wg, wu, wd, out, ws, G, E, C, D, F, nf, fr, dr,
                           bm, (size_t)smem, s);
  if (dtype == 1)
    return dispatch<bf16>(x, wg, wu, wd, out, ws, G, E, C, D, F, nf, fr, dr,
                          bm, (size_t)smem, s);
  return (int)cudaErrorInvalidValue;
}
