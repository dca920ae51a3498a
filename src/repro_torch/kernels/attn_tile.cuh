// Shared pieces of the two attention kernels (flash_attention.cu,
// flash_decode.cu): one warp owns up to kRowsPerWarp query rows, a block of
// kWarps warps shares one tile of kTile keys staged in shared memory, and
// each row keeps its online-softmax state (m, l, acc) in fp32 registers.
//
// Work split inside a warp, per tile of 32 keys:
//   scores  lane j scores key j against every row of the warp (a loop over
//           the head dim; K is staged with a row stride of HD+1 floats so the
//           32 lanes hit 32 different banks);
//   softmax a warp max and a warp sum over the 32 lanes give the tile's row
//           max and row sum;
//   P.V     lane owns head dims lane, lane+32, ... (HPL of them, HPL =
//           ceil(HD/32)), so no lane holds a whole 128-wide accumulator; the
//           probability of key j is broadcast by a shuffle.
// Arithmetic is fp32 FMA on the CUDA cores.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kMaxRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kTile = 32;                        // keys per staged tile
constexpr int kMaxHeadDim = 256;
constexpr unsigned kFull = 0xffffffffu;
// same constant as the JAX package: a fully masked row stays finite
constexpr float kNegInf = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

// Dynamic shared memory of one block: sQ (kMaxRows x HD), sK (kTile x
// (HD+1)), sV (kTile x HD), all fp32.
inline size_t smem_bytes(int hd) {
  return sizeof(float) * ((size_t)kMaxRows * hd + (size_t)kTile * (hd + 1) +
                          (size_t)kTile * hd);
}

// Each thread issues this many loads before it stores any of them. The loads
// of a batch are independent, so their device-memory latencies overlap
// instead of adding up: staging a 32 x 64 tile takes two round trips, not 16.
constexpr int kLoadBatch = 8;

// Stage n fp32 values into shared memory: dst[idx] = load(idx), idx < n.
template <typename Load>
__device__ __forceinline__ void stage(float* dst, int n, Load load) {
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kLoadBatch) {
    float r[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int idx = i0 + u * kThreads;
      r[u] = idx < n ? load(idx) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int idx = i0 + u * kThreads;
      if (idx < n) dst[idx] = r[u];
    }
  }
}

// Stage keys [k0, k0 + kTile) of one kv head. Key j of the head starts at
// base + j * key_stride; keys at or past n_keys are zero-filled. Threads walk
// the tile in row-major order, so neighbouring threads load neighbouring
// elements of a key row.
template <typename T>
__device__ __forceinline__ void stage_kv(const T* __restrict__ k,
                                         const T* __restrict__ v, size_t base,
                                         size_t key_stride, int k0, int n_keys,
                                         int hd, float* sK, float* sV) {
  const int n = kTile * hd;
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kLoadBatch) {
    float kr[kLoadBatch], vr[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int idx = i0 + u * kThreads;
      const int j = idx / hd, d = idx - j * hd;
      kr[u] = 0.f;
      vr[u] = 0.f;
      if (idx < n && k0 + j < n_keys) {
        const size_t off = base + (size_t)(k0 + j) * key_stride + d;
        kr[u] = to_f(k[off]);
        vr[u] = to_f(v[off]);
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int idx = i0 + u * kThreads;
      const int j = idx / hd, d = idx - j * hd;
      if (idx < n) {
        sK[j * (hd + 1) + d] = kr[u];
        sV[j * hd + d] = vr[u];
      }
    }
  }
}

// The online-softmax state of a warp's ROWS query rows (rows warp + kWarps *
// i). ROWS defaults to the most a warp can hold; a caller with fewer rows
// (decode with G <= kWarps) asks for fewer, so no instruction is spent on an
// empty row.
template <int HPL, int ROWS = kRowsPerWarp>
struct RowState {
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

  // Fold one staged tile into the warp's rows (rows warp + kWarps * i).
  // mask(r, lane) says whether row r may attend the tile's key `lane`. A row
  // whose every key in the tile is masked is left untouched; the callers
  // guarantee that every row they write has at least one unmasked key.
  template <typename Mask>
  __device__ __forceinline__ void update(const float* sQ, const float* sK,
                                         const float* sV, int hd, int n_rows,
                                         float scale, float softcap,
                                         Mask mask) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float s[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i] = 0.f;
    const float* krow = sK + lane * (hd + 1);
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        s[i] = fmaf(sQ[(warp + kWarps * i) * hd + d], kd, s[i]);
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
        vv[h] = d < hd ? sV[j * hd + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float pj = __shfl_sync(kFull, p[i], j);
#pragma unroll
        for (int h = 0; h < HPL; ++h) acc[i][h] = fmaf(pj, vv[h], acc[i][h]);
      }
    }
  }

  // Write row i as acc / l (l == 0 -> 1, as the TPU kernel guards it).
  template <typename T>
  __device__ __forceinline__ void store(int i, T* out_row, int hd) const {
    const int lane = threadIdx.x & 31;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int h = 0; h < HPL; ++h) {
      const int d = lane + 32 * h;
      if (d < hd) store_f(out_row + d, acc[i][h] / denom);
    }
  }
};

// Opt a kernel in to more than 48 KB of dynamic shared memory when it needs
// it. Returns the CUDA error code.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace attn

// Instantiate `LAUNCH(T, HPL)` for the head-dim-per-lane count of `hd`.
#define ATTN_DISPATCH_HPL(hd, T, LAUNCH)         \
  switch ((hd + 31) / 32) {                      \
    case 1: LAUNCH(T, 1); break;                 \
    case 2: LAUNCH(T, 2); break;                 \
    case 3: LAUNCH(T, 3); break;                 \
    case 4: LAUNCH(T, 4); break;                 \
    case 5: LAUNCH(T, 5); break;                 \
    case 6: LAUNCH(T, 6); break;                 \
    case 7: LAUNCH(T, 7); break;                 \
    case 8: LAUNCH(T, 8); break;                 \
    default: return (int)cudaErrorInvalidValue; \
  }
