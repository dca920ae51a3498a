// Causal (optionally sliding-window, optionally softcapped) GQA attention
// over a whole sequence, for sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention_gqa`
// (src/repro/kernels/flash_attention/kernel.py), which the JAX model reaches
// from attention.attn_prefill. It computes the same function as that
// package's oracle `attention_ref`: softmax(q k^T * Hd^-0.5 [softcapped],
// masked causally and by the window) v, with an fp32 online softmax.
//
// What bounds it on this card: at the serving shapes (S <= 96, Hd = 64) the
// work is tiny (a few MFLOP per layer) and the kernel is bound by launch and
// latency, not by the 3.35 TB/s of HBM or by arithmetic. At long S the
// score and P.V products dominate; this first version does them as fp32 FMA
// on the CUDA cores (67 TFLOP/s peak), not on the tensor cores.
//
// What the design does about it:
// - one block per (batch, kv head, tile of query positions): the tile's rows
//   are the G query heads of that kv head times BQ positions (G * BQ <= 32),
//   so each K/V tile is read from memory once for all G heads (GQA is never
//   expanded);
// - K/V tiles of 32 keys are staged through shared memory with coalesced
//   loads and shared by the block's 4 warps;
// - the kv loop runs only over [window start, last query position], so tiles
//   that are wholly masked for the whole block are never read, and a row
//   skips a tile that is wholly masked for that row;
// - the mask uses the true sequence length; nothing is padded to the TPU's
//   128 lanes, and the head dim is split across a warp's lanes (see
//   attn_tile.cuh) so accumulators stay in registers for Hd up to 256.
// Nothing is carried from one block to the next; the TPU kernel's
// sequential kv grid axis becomes the loop inside the block.
#include "../attn_tile.cuh"

namespace {

using namespace attn;

template <typename T, int HPL>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int S,
                           int H, int KH, int hd, int G, int BQ, int causal,
                           int window, float softcap, float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kMaxRows * hd;
  float* sV = sK + kTile * (hd + 1);

  const int b = blockIdx.y / KH, kh = blockIdx.y % KH;
  const int q0 = blockIdx.x * BQ;
  const int n_rows = G * BQ;  // row r: position q0 + r / G, head kh*G + r%G

  stage(sQ, kMaxRows * hd, [&](int idx) {
    const int r = idx / hd, d = idx - r * hd;
    const int t = q0 + r / G;
    return r < n_rows && t < S
               ? to_f(q[(((size_t)b * S + t) * H + kh * G + r % G) * hd + d])
               : 0.f;
  });

  const int q_last = min(q0 + BQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, q0 - window + 1) / kTile * kTile;

  RowState<HPL> st;
  st.init();
  const size_t base = (size_t)b * S * KH * hd + (size_t)kh * hd;
  for (int k0 = kv_begin; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // sQ staged / previous tile consumed
    stage_kv(k, v, base, (size_t)KH * hd, k0, S, hd, sK, sV);
    __syncthreads();
    auto mask = [&](int r, int lane) {
      const int t = q0 + r / G, key = k0 + lane;
      bool ok = key < S && t < S;
      if (causal) ok = ok && key <= t;
      if (window > 0) ok = ok && t - key < window;
      return ok;
    };
    st.update(sQ, sK, sV, hd, n_rows, scale, softcap, mask);
  }

  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    const int t = q0 + r / G;
    if (r < n_rows && t < S)
      st.store(i, o + (((size_t)b * S + t) * H + kh * G + r % G) * hd, hd);
  }
}

template <typename T, int HPL>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KH, int hd, int causal, int window, float softcap,
           float scale, cudaStream_t stream) {
  const int G = H / KH;
  const int BQ = kMaxRows / G;
  const size_t smem = smem_bytes(hd);
  auto kernel = flash_attention_kernel<T, HPL>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, B * KH);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, KH, hd, G, BQ,
      causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (B, S, H, hd); k, v: (B, S, KH, hd); all contiguous. dtype: 0 = fp32,
// 1 = bf16. Launches on `stream` and returns the CUDA error code (0 = ok).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int KH, int hd, int causal,
                                      int window, float softcap, float scale,
                                      int dtype, void* stream) {
  if (KH <= 0 || H % KH != 0 || H / KH > kMaxRows || hd <= 0 ||
      hd > kMaxHeadDim || S <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(TT, HPL)                                                     \
  return launch<TT, HPL>(q, k, v, o, B, S, H, KH, hd, causal, window,     \
                         softcap, scale, s)
  if (dtype == 0) {
    ATTN_DISPATCH_HPL(hd, float, LAUNCH);
  } else if (dtype == 1) {
    ATTN_DISPATCH_HPL(hd, __nv_bfloat16, LAUNCH);
  }
#undef LAUNCH
  return (int)cudaErrorInvalidValue;
}
