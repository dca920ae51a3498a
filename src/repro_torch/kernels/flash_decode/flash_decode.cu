// One query position per sequence against a KV cache (GQA), for sm_90a.
//
// Replaces the Pallas TPU kernel `flash_decode_gqa`
// (src/repro/kernels/flash_decode/kernel.py), which the JAX model reaches
// from attention.attn_decode on every decode tick. Same function as that
// package's oracle `decode_ref`: for each (batch, kv head) the G query rows
// attend cache positions [0, valid_len) with an fp32 online softmax and an
// optional logit softcap; `valid_len` is one int32 shared by the batch.
//
// What bounds it on this card: it does ~4 FLOP per cache byte, far below
// the ~20 FLOP/byte at which fp32 FMA (67 TFLOP/s) would overtake HBM
// (3.35 TB/s), so its floor is the bytes of K and V below valid_len over
// the memory rate. At the serving shape (B=4, K=8, S=112, Hd=64, bf16) that
// is under 0.5 MB per call: launch latency dominates.
//
// What the design does about it:
// - one block per (batch, kv head) holds the G query rows of that kv head,
//   so the cache is read once and never expanded to H heads;
// - the cache is walked in tiles of 32 positions staged through shared
//   memory with coalesced loads; (m, l, acc) per row live in registers;
// - a warp holds only the rows there are: with G <= 4 (llama3.2-1b: G = 4)
//   each of the 4 warps owns one row, so no instruction goes to an empty
//   row (the prefill kernel's warps hold 8);
// - valid_len is read by the kernel from a device pointer (as the TPU kernel
//   reads its (1,) array), so a decode step never syncs the host, and tiles
//   at or past valid_len are never read.
// Known limit: at the serving shape this is 32 blocks on 132 SMs. Splitting
// the cache across blocks (a second reduction pass) is later work.
#include "../attn_tile.cuh"

namespace {

using namespace attn;

template <typename T, int HPL, int ROWS>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ valid_len, T* __restrict__ o,
                        int S, int KH, int hd, int G, float softcap,
                        float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kMaxRows * hd;
  float* sV = sK + kTile * (hd + 1);

  const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
  const size_t q_base = ((size_t)b * KH + kh) * G * hd;  // (B, K, G, hd)
  stage(sQ, kWarps * ROWS * hd, [&](int idx) {
    return idx < G * hd ? to_f(q[q_base + idx]) : 0.f;
  });

  const int n_valid = min(max(valid_len[0], 0), S);
  RowState<HPL, ROWS> st;
  st.init();
  const size_t base = (size_t)b * S * KH * hd + (size_t)kh * hd;
  for (int k0 = 0; k0 < n_valid; k0 += kTile) {
    __syncthreads();
    stage_kv(k, v, base, (size_t)KH * hd, k0, n_valid, hd, sK, sV);
    __syncthreads();
    auto mask = [&](int, int lane) { return k0 + lane < n_valid; };
    st.update(sQ, sK, sV, hd, G, scale, softcap, mask);
  }

  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = warp + kWarps * i;
    if (r < G) st.store(i, o + q_base + (size_t)r * hd, hd);
  }
}

template <typename T, int HPL, int ROWS>
int launch(const void* q, const void* k, const void* v, const int* valid_len,
           void* o, int B, int S, int KH, int hd, int G, float softcap,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  auto kernel = flash_decode_kernel<T, HPL, ROWS>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * KH, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, valid_len, (T*)o, S, KH, hd, G,
      softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (B, KH, G, hd); k, v: (B, S, KH, hd); valid_len: one int32 on the
// device; all contiguous. dtype: 0 = fp32, 1 = bf16. Launches on `stream`
// and returns the CUDA error code (0 = ok).
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* valid_len,
                                   void* o, int B, int S, int KH, int hd,
                                   int G, float softcap, float scale,
                                   int dtype, void* stream) {
  if (KH <= 0 || G <= 0 || G > kMaxRows || hd <= 0 || hd > kMaxHeadDim ||
      S <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* vl = (const int*)valid_len;
  // one row per warp when the group fits (llama: G = 4 over 4 warps)
#define LAUNCH(TT, HPL)                                                   \
  return G <= kWarps                                                      \
             ? launch<TT, HPL, 1>(q, k, v, vl, o, B, S, KH, hd, G, softcap, \
                                  scale, s)                               \
             : launch<TT, HPL, kRowsPerWarp>(q, k, v, vl, o, B, S, KH, hd,  \
                                             G, softcap, scale, s)
  if (dtype == 0) {
    ATTN_DISPATCH_HPL(hd, float, LAUNCH);
  } else if (dtype == 1) {
    ATTN_DISPATCH_HPL(hd, __nv_bfloat16, LAUNCH);
  }
#undef LAUNCH
  return (int)cudaErrorInvalidValue;
}
