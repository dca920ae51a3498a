// Shared pieces of the two attention kernels (flash_attention.cu,
// flash_decode.cu).
//
// Row mapping, both kernels and both dtypes: for one (batch, kv head) the
// query rows are flattened as (position t, group head g), row r = t * G + g.
// A block or a warp takes a fixed number of consecutive rows whatever G is:
// with G = 4 a 64-row tile is 16 positions, with G = 48 one position's heads
// fill 48 of its rows. In the (B, S, H, Hd) layout the G heads of one
// position are contiguous, so a row's address is base + r / G * H * Hd +
// (r % G) * Hd.
//
// Two tile routines fold a staged tile of keys into a warp's rows:
// - TcWarp (bf16): a warp owns 16 or 32 rows. Q.K^T and P.V run on the
//   tensor cores (mma.sync m16n8k16, bf16 operands, fp32 accumulators),
//   with K and V brought from shared memory by ldmatrix (.trans for V) and
//   Q held in registers (QRegs) or read from shared memory (QSmem). The
//   online softmax runs on the accumulator fragments, where a row lives in
//   4 lanes, so its max and sum take 2 shuffles. P is rounded to bf16 in
//   registers and is the A operand of P.V as it stands: it never goes
//   through shared memory. The head dim is zero-padded up to a multiple of
//   the mma depth, 16.
// - FmaRows (fp32): TF32 keeps about three decimal digits and would miss the
//   2e-5 the fp32 tests hold, so fp32 stays on the CUDA cores. Lane j scores
//   key j against the warp's rows (float4 reads, with rows padded so that 8
//   lanes reading 16 bytes each hit 8 different bank groups), a warp max and
//   a warp sum give a row's tile max and sum, and lane owns head dims lane,
//   lane + 32, ... for P.V, the probability of key j broadcast by a shuffle.
//
// Staging, both routines: K/V tiles are copied into shared memory with
// cp.async into two stages. The copy of tile i + 1 is issued before the
// wait for tile i, so two tiles are in flight while a block waits, and tile
// i + 1 lands while tile i is computed. (Three and four stages measured no
// faster on the H100.) A copy is 16 bytes where the key
// row's byte width and the pointers allow it, else 8 or 4; a bf16 row of odd
// width is copied one element at a time by plain loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace attn {

using namespace sm90;  // conversions, cp.async, ldmatrix, mma.sync

constexpr int kMaxHeadDim = 256;
constexpr unsigned kFull = 0xffffffffu;
// same constant as the JAX package: a fully masked row stays finite
constexpr float kNegInf = -0.7f * 3.4028234663852886e38f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// staging
// ---------------------------------------------------------------------------

// Copy `rows` rows of `hd` elements into shared memory, row j to
// dst + j * ld. row_ptr(j) gives row j's source, or nullptr for a row to
// zero-fill; `any` is some valid global address. `vec` is the copy width in
// bytes: 16, 8 or 4 go through cp.async, anything less one element at a
// time by plain loads. Only the hd columns are written.
template <typename T, typename RowPtr>
__device__ __forceinline__ void load_rows(T* dst, int ld, int rows, int hd,
                                          int vec, const T* any,
                                          RowPtr row_ptr) {
  if (vec >= 4) {
    const int per_row = hd * (int)sizeof(T) / vec;
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
      const int j = i / per_row, c = i - j * per_row;
      const T* src = row_ptr(j);
      char* d = reinterpret_cast<char*>(dst + (size_t)j * ld) + c * vec;
      const char* s = reinterpret_cast<const char*>(src ? src : any) +
                      (src ? c * vec : 0);
      if (vec == 16) {
        cp_async<16>(d, s, src != nullptr);
      } else if (vec == 8) {
        cp_async<8>(d, s, src != nullptr);
      } else {
        cp_async<4>(d, s, src != nullptr);
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * hd; i += blockDim.x) {
      const int j = i / hd, c = i - j * hd;
      const T* src = row_ptr(j);
      dst[(size_t)j * ld + c] = src ? src[c] : zero_of<T>();
    }
  }
}

// Copy rows [0, n) of a tile of keys into shared memory, row j from
// src + j * stride to dst + j * ld; rows at or past n_valid are zero-filled.
// Each thread walks (row, chunk) pairs without dividing: the K/V tile is
// copied once per tile, so its address arithmetic sits in the main loop.
template <int V, typename T>
__device__ __forceinline__ void copy_tile_v(T* dst, int ld, const T* src,
                                            size_t stride, int n, int n_valid,
                                            int hd) {
  const int per_row = hd * (int)sizeof(T) / V;
  int j = threadIdx.x / per_row, c = threadIdx.x - j * per_row;
  const int dj = blockDim.x / per_row, dc = blockDim.x - dj * per_row;
  while (j < n) {
    const bool valid = j < n_valid;
    cp_async<V>(reinterpret_cast<char*>(dst + (size_t)j * ld) + c * V,
                reinterpret_cast<const char*>(valid ? src + j * stride : src) +
                    c * V,
                valid);
    j += dj;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++j;
    }
  }
}

// The narrow copies (rows whose byte width is not a multiple of 16), out of
// line so that the main loop's code stays small.
template <typename T>
__device__ __noinline__ void copy_tile_narrow(T* dst, int ld, const T* src,
                                              size_t stride, int n,
                                              int n_valid, int hd, int vec) {
  if (vec == 8) {
    copy_tile_v<8>(dst, ld, src, stride, n, n_valid, hd);
  } else if (vec == 4) {
    copy_tile_v<4>(dst, ld, src, stride, n, n_valid, hd);
  } else {
    load_rows(dst, ld, n, hd, vec, src, [&](int j) -> const T* {
      return j < n_valid ? src + j * stride : nullptr;
    });
  }
}

template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, int ld, const T* src,
                                          size_t stride, int n, int n_valid,
                                          int hd, int vec) {
  if (vec == 16) {
    copy_tile_v<16>(dst, ld, src, stride, n, n_valid, hd);
  } else {
    copy_tile_narrow(dst, ld, src, stride, n, n_valid, hd, vec);
  }
}

// Zero columns [c0, c1) of `rows` rows (the head-dim padding).
template <typename T>
__device__ __forceinline__ void zero_cols(T* dst, int ld, int rows, int c0,
                                          int c1) {
  const int w = c1 - c0;
  if (w <= 0) return;
  for (int i = threadIdx.x; i < rows * w; i += blockDim.x) {
    const int j = i / w;
    dst[(size_t)j * ld + c0 + i - j * w] = zero_of<T>();
  }
}

// The widest copy (16, 8 or 4 bytes) that divides a row of hd elements and
// keeps every pointer aligned; esize if none does (bf16 rows of odd width).
inline int copy_width(int hd, int esize, const void* const* ptrs, int n) {
  for (int v = 16; v >= 4; v >>= 1) {
    bool ok = (hd * esize) % v == 0;
    for (int i = 0; i < n; ++i) ok = ok && (uintptr_t)ptrs[i] % v == 0;
    if (ok) return v;
  }
  return esize;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

// 2^x in one instruction (denormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keys per staged tile of the bf16 routine: 64, or 32 where the head dim is
// above 128 (its 128 output accumulators a thread leave no room for 64).
template <int KD>
struct TcTile {
  static constexpr int BN = KD <= 8 ? 64 : 32;
  static constexpr int LD = KD * 16 + 8;  // row stride of sQ/sK/sV, elements
  static constexpr int STAGES = 2;        // K/V tiles in shared memory
};

// A lane's row r of a warp's 16 * MT rows, r = 0 .. 2 MT - 1: row
// 16 * (r / 2) + g + 8 * (r % 2), g = lane / 4.
__device__ __forceinline__ int frag_row(int r) {
  return 16 * (r >> 1) + ((threadIdx.x & 31) >> 2) + 8 * (r & 1);
}

// A operands (Q) of a warp's 16 * MT rows held in registers for the whole
// kernel, loaded from global memory once: no shared memory, no barrier. A
// row pointer is null for a row past the end (zeros); columns at or past hd
// are zeros (the head-dim padding). `pairs`: rows are 4-byte aligned and hd
// is even, so a lane loads two columns at once.
template <int KD, int MT>
struct QRegs {
  uint32_t f[MT][KD][4];

  __device__ __forceinline__ void load(const bf16* const (&rows)[2 * MT],
                                       int hd, bool pairs) {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kc = 0; kc < KD; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bf16* row = rows[2 * mt + (e & 1)];
          const int col = kc * 16 + 2 * t + 8 * (e >> 1);
          uint32_t v = 0;
          if (row && col < hd) {
            if (pairs) {
              v = *reinterpret_cast<const uint32_t*>(row + col);
            } else {
              const bf16 hi = col + 1 < hd ? row[col + 1] : zero_of<bf16>();
              v = pack_bf16(__bfloat162float(row[col]), __bfloat162float(hi));
            }
          }
          f[mt][kc][e] = v;
        }
  }

  __device__ __forceinline__ void operator()(int mt, int kc,
                                             uint32_t (&a)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[e] = f[mt][kc][e];
  }
};

// A operands (Q) read from the warp's rows staged in shared memory.
template <int KD>
struct QSmem {
  const bf16* sQ;  // the warp's first row, row stride TcTile<KD>::LD

  __device__ __forceinline__ void operator()(int mt, int kc,
                                             uint32_t (&a)[4]) const {
    const int lane = threadIdx.x & 31;
    const int row = 16 * mt + (lane & 7) + ((lane >> 3) & 1) * 8;
    ldsm_x4(a, sQ + row * TcTile<KD>::LD + kc * 16 + (lane >> 4) * 8);
  }
};

// The online-softmax state of one warp's 16 * MT query rows, in mma
// fragments: lane (g = lane / 4, t = lane % 4) holds rows frag_row(r),
// r < 2 MT, and output columns 8 * j + 2t, 8 * j + 2t + 1 of every 8-wide
// tile j. With MT = 2 the two 16-row tiles share every K and V fragment
// that ldmatrix brings, and their products are independent chains. The row
// max m is kept in raw score units (softcapped scores in log2 units); l is
// this lane's share of the row sum until finish() adds the 4 lanes' shares.
//
// Row strides of sQ/sK/sV are KD * 16 + 8 elements: a row is 16 bytes past
// a multiple of 32, so the 8 rows of an ldmatrix hit 8 different 16-byte
// bank groups.
template <int KD, int MT = 1>
struct TcWarp {
  static constexpr int BN = TcTile<KD>::BN;
  static constexpr int LD = TcTile<KD>::LD;
  static constexpr int NT = BN / 8;  // 8-key tiles of the score tile
  static constexpr int DT = KD * 2;  // 8-wide tiles of the output
  static constexpr int R = 2 * MT;   // rows a lane holds
  float o[MT][DT][4];
  float m[R], l[R];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < DT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
    }
  }

  // Fold one staged tile of BN keys into the warp's rows, with a logit
  // softcap when CAP. qa(mt, kc, a) gives the A operand of row tile mt,
  // depth step kc (QRegs or QSmem);
  // sK, sV: the tile's keys. ok(r, c) says whether the lane's row
  // frag_row(r) may attend the tile's key c; full == true: every pair may,
  // and ok is not asked.
  template <bool CAP, typename QA, typename Ok>
  __device__ __forceinline__ void update(const QA& qa, const bf16* sK,
                                         const bf16* sV, float scale,
                                         float softcap, bool full, Ok ok) {
    const int lane = threadIdx.x & 31, t = lane & 3;
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;

    // S = Q K^T: B from key rows (non-transposed), shared by the row tiles
    const int b_row = (lane & 7) + (lane >> 4) * 8;
    const int b_col = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kc = 0; kc < KD; ++kc) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) qa(mt, kc, a[mt]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, sK + (np * 16 + b_row) * LD + kc * 16 + b_col);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(s[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }

    // softcap (CAP, a template argument so that a kernel without one
    // carries no tanh code) and mask (a uniform branch around all of the
    // lane's scores). Without a softcap the scores stay raw and the scale
    // goes into the exponent (scale > 0 keeps their order).
    float scale2 = scale * kLog2e;
    if constexpr (CAP) {
      const float inner = scale / softcap, outer = softcap * kLog2e;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[mt][j][e] = outer * tanhf(s[mt][j][e] * inner);
      scale2 = 1.f;
    }
    if (!full) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!ok(2 * mt + (e >> 1), j * 8 + 2 * t + (e & 1)))
              s[mt][j][e] = kNegInf;
    }
    // the tile's row max (4 lanes hold a row), then p = 2^((s - m) * scale2)
    // in one FFMA and one ex2 a score. A masked score is kNegInf, whose p is
    // 0 against any finite m; while a row has seen no key (m = kNegInf) its
    // offset is taken as 0, so its masked scores give 0 too.
    float mx[R], alpha[R], off[R];
#pragma unroll
    for (int r = 0; r < R; ++r) mx[r] = kNegInf;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 2 * mt + (e >> 1);
          mx[r] = fmaxf(mx[r], s[mt][j][e]);
        }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = ex2((m[r] - m_new) * scale2);
      m[r] = m_new;
      off[r] = m_new == kNegInf ? 0.f : m_new * scale2;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 2 * mt + (e >> 1);
          const float p = ex2(fmaf(s[mt][j][e], scale2, -off[r]));
          s[mt][j][e] = p;
          l[r] += p;
        }
      }
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        o[mt][j][0] *= alpha[2 * mt];
        o[mt][j][1] *= alpha[2 * mt];
        o[mt][j][2] *= alpha[2 * mt + 1];
        o[mt][j][3] *= alpha[2 * mt + 1];
      }
    }

    // O += P V: the score fragments of two 8-key tiles are the A operand of
    // one 16-key step; V comes transposed by ldmatrix
    const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int v_col = (lane >> 4) * 8;
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * kc][0], s[mt][2 * kc][1]);
        a[mt][1] = pack_bf16(s[mt][2 * kc][2], s[mt][2 * kc][3]);
        a[mt][2] = pack_bf16(s[mt][2 * kc + 1][0], s[mt][2 * kc + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * kc + 1][2], s[mt][2 * kc + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(b, sV + (kc * 16 + v_row) * LD + dp * 16 + v_col);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][2 * dp], a[mt], b[0], b[1]);
          mma_bf16(o[mt][2 * dp + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }

  // Add the 4 lanes' shares of each row sum.
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      l[r] += __shfl_xor_sync(kFull, l[r], 1);
      l[r] += __shfl_xor_sync(kFull, l[r], 2);
    }
  }

  // Write the lane's values of row frag_row(r): put(r, col, value) for
  // every column below hd, value = acc / l (l == 0 -> 1, as the TPU kernel
  // guards it) when `normalize`, else the raw acc.
  template <typename Put>
  __device__ __forceinline__ void store(int hd, bool normalize,
                                        Put put) const {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float inv = normalize ? 1.f / (l[r] == 0.f ? 1.f : l[r]) : 1.f;
      const int mt = r >> 1, i = r & 1;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const int col = j * 8 + 2 * t;
        if (col < hd) put(r, col, o[mt][j][2 * i] * inv);
        if (col + 1 < hd) put(r, col + 1, o[mt][j][2 * i + 1] * inv);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;  // warps of an fp32 block
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kTile = 32;  // keys per staged fp32 tile

// Row stride (floats) of the fp32 tiles: hd rounded up to 4, plus 4 where
// that makes the stride an odd number of 16-byte groups, so that the 8
// lanes of a float4 read phase hit 8 different bank groups.
__host__ __device__ inline int fma_ld(int hd) {
  const int g = (hd + 3) / 4;
  return 4 * (g | 1);
}

// The online-softmax state of a warp's ROWS query rows (rows warp + kWarps
// * i of the block's tile). ROWS is the most a warp holds; decode with
// G <= kWarps asks for one, so no instruction is spent on an empty row.
template <int HPL, int ROWS = kRowsPerWarp>
struct FmaRows {
  float m[ROWS];
  float l[ROWS];
  float acc[ROWS][HPL];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int h = 0; h < HPL; ++h) acc[i][h] = 0.f;
    }
  }

  // Fold one staged tile of kTile keys into the warp's rows. ld: the row
  // stride of sQ, sK and sV (fma_ld(hd)); columns hd..ld of sQ and sK are
  // zero. mask(r, lane) says whether row r may attend the tile's key
  // `lane`. A row whose every key in the tile is masked is left untouched.
  template <typename Mask>
  __device__ __forceinline__ void update(const float* sQ, const float* sK,
                                         const float* sV, int ld, int hd,
                                         int n_rows, float scale,
                                         float softcap, Mask mask) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float s[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(sK + lane * ld);
    const int n4 = (hd + 3) / 4;
#pragma unroll 2
    for (int d4 = 0; d4 < n4; ++d4) {
      const float4 kd = krow[d4];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float4 qd = reinterpret_cast<const float4*>(
            sQ + (warp + kWarps * i) * ld)[d4];
        s[i] = fmaf(qd.x, kd.x, s[i]);
        s[i] = fmaf(qd.y, kd.y, s[i]);
        s[i] = fmaf(qd.z, kd.z, s[i]);
        s[i] = fmaf(qd.w, kd.w, s[i]);
      }
    }
    float p[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      p[i] = 0.f;
      const int r = warp + kWarps * i;
      if (r >= n_rows) continue;  // uniform across the warp
      const bool ok = mask(r, lane);
      float sc = s[i] * scale;
      if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
      sc = ok ? sc : kNegInf;
      const float mt = warp_max(sc);
      if (mt == kNegInf) continue;  // row wholly masked in this tile
      const float m_new = fmaxf(m[i], mt);
      p[i] = ok ? expf(sc - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + warp_sum(p[i]);
#pragma unroll
      for (int h = 0; h < HPL; ++h) acc[i][h] *= alpha;
      m[i] = m_new;
    }
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float vv[HPL];
#pragma unroll
      for (int h = 0; h < HPL; ++h) {
        const int d = lane + 32 * h;
        vv[h] = d < hd ? sV[j * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float pj = __shfl_sync(kFull, p[i], j);
#pragma unroll
        for (int h = 0; h < HPL; ++h) acc[i][h] = fmaf(pj, vv[h], acc[i][h]);
      }
    }
  }

  // Write row i: put(col, value) for the lane's columns below hd, value =
  // acc / l (l == 0 -> 1) when `normalize`, else the raw acc.
  template <typename Put>
  __device__ __forceinline__ void store(int i, int hd, bool normalize,
                                        Put put) const {
    const int lane = threadIdx.x & 31;
    const float inv = normalize ? 1.f / (l[i] == 0.f ? 1.f : l[i]) : 1.f;
#pragma unroll
    for (int h = 0; h < HPL; ++h) {
      const int d = lane + 32 * h;
      if (d < hd) put(d, acc[i][h] * inv);
    }
  }
};

}  // namespace attn

// Instantiate `LAUNCH(HPL)` for the head-dim-per-lane count of `hd` (the
// fp32 routine).
#define ATTN_DISPATCH_HPL(hd, LAUNCH)            \
  switch ((hd + 31) / 32) {                      \
    case 1: LAUNCH(1); break;                    \
    case 2: LAUNCH(2); break;                    \
    case 3: LAUNCH(3); break;                    \
    case 4: LAUNCH(4); break;                    \
    case 5: LAUNCH(5); break;                    \
    case 6: LAUNCH(6); break;                    \
    case 7: LAUNCH(7); break;                    \
    case 8: LAUNCH(8); break;                    \
    default: return (int)cudaErrorInvalidValue; \
  }

// Instantiate `LAUNCH(KD)` for a padded head dim of KD * 16 >= hd (the bf16
// routine): 16 to 96 in steps of 16, then 128, 192 and 256.
#define ATTN_DISPATCH_KD(hd, LAUNCH)             \
  switch ((hd + 15) / 16) {                      \
    case 1: LAUNCH(1); break;                    \
    case 2: LAUNCH(2); break;                    \
    case 3: LAUNCH(3); break;                    \
    case 4: LAUNCH(4); break;                    \
    case 5: LAUNCH(5); break;                    \
    case 6: LAUNCH(6); break;                    \
    case 7:                                      \
    case 8: LAUNCH(8); break;                    \
    case 9:                                      \
    case 10:                                     \
    case 11:                                     \
    case 12: LAUNCH(12); break;                  \
    case 13:                                     \
    case 14:                                     \
    case 15:                                     \
    case 16: LAUNCH(16); break;                  \
    default: return (int)cudaErrorInvalidValue; \
  }
