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
// work is a few MFLOP per layer, and the kernel is bound by launch latency
// and by the chain of dependent loads and arithmetic in one block, not by
// the 3.35 TB/s of HBM. At long S the Q.K^T and P.V products dominate: the
// bound is the tensor cores' operations (989 TFLOP/s in bf16); in practice
// the re-reading of K/V tiles from L2 (each block reads every key up to its
// last position) and the latency of each warp's mma -> softmax -> mma chain.
//
// What the design does about it (attn_tile.cuh):
// - the query rows of one (batch, kv head) are flattened as (position,
//   group head), and a block takes a fixed number of consecutive rows
//   whatever G is, so any group size runs and each K/V tile is read once
//   for all G heads (GQA is never expanded). A block's key range is
//   [window start of its first position, its last position]; a warp skips
//   a tile that is wholly masked for its rows, and the blocks with the most
//   keys start first.
// - bf16: the tensor cores (mma.sync m16n8k16, fp32 sums), the online
//   softmax on the accumulator fragments, P kept in registers as the A
//   operand of P.V. A warp owns 16 rows with its Q in registers, or 32 rows
//   (two tiles sharing every K/V fragment) with Q in shared memory. A block
//   is 16, 32 or 64 rows (1, 2 or 4 warps), or 128 (4 warps of 32): the
//   launcher takes 128 where that still fills a wave of 132 SMs (long
//   prompts: half the K/V re-reads of 64), else the largest that gives half
//   a wave (short prompts spread over more SMs). The softcap is a template
//   argument, so the common kernel carries no tanh code: the code of the
//   main loop stays small.
// - fp32: the CUDA cores (FMA), 4 warps of 8 rows a block. TF32 would keep
//   about three decimal digits and miss the 2e-5 that the fp32 tests and the
//   model's fp32 checks hold; only bf16 inputs use the tensor cores.
// - K/V tiles (64 keys in bf16 up to Hd 128, 32 above and in fp32) are
//   copied by cp.async, 16 bytes a copy where the row allows, into two
//   stages; tile i + 1 is in flight while tile i is computed.
// Nothing is carried from one block to the next; the TPU kernel's
// sequential kv grid axis becomes the loop inside the block.
#include "../attn_tile.cuh"

namespace {

using namespace attn;

struct Problem {
  const void* q;  // (B, S, H, hd)
  const void* k;  // (B, S, KH, hd)
  const void* v;
  void* o;        // (B, S, H, hd)
  int S, H, KH, hd, G, causal, window, vec;
  float softcap, scale;
};

// The rows and keys of one block: rows [r0, r1) of its (batch, kv head),
// keys [kv_begin, kv_end).
struct Span {
  int b, kh, r0, r1, kv_begin, kv_end;

  __device__ __forceinline__ Span(const Problem& p, int rows_per_block) {
    b = blockIdx.y / p.KH;
    kh = blockIdx.y % p.KH;
    // the last rows, which have the most keys under a causal mask, first
    r0 = (gridDim.x - 1 - blockIdx.x) * rows_per_block;
    r1 = min(r0 + rows_per_block, p.S * p.G);
    const int t_first = r0 / p.G, t_last = (r1 - 1) / p.G;
    kv_begin = p.window > 0 ? max(0, t_first - p.window + 1) : 0;
    kv_end = p.causal ? t_last + 1 : p.S;
  }

  // element offset of flattened row r
  __device__ __forceinline__ size_t row_off(const Problem& p, int r) const {
    return (((size_t)b * p.S + r / p.G) * p.H + kh * p.G + r % p.G) *
           (size_t)p.hd;
  }

  // element offset of key `key`
  __device__ __forceinline__ size_t key_off(const Problem& p, int key) const {
    return (((size_t)b * p.S + key) * p.KH + kh) * (size_t)p.hd;
  }

  // may position t attend key?
  __device__ __forceinline__ bool ok(const Problem& p, int t, int key) const {
    bool yes = key < p.S;
    if (p.causal) yes = yes && key <= t;
    if (p.window > 0) yes = yes && t - key < p.window;
    return yes;
  }
};

// Stage keys [k0, k0 + n) of the block's kv head; keys at or past kv_end
// are zero-filled.
template <typename T>
__device__ __forceinline__ void stage_kv(const Problem& p, const Span& sp,
                                         int k0, int n, T* sK, T* sV,
                                         int ld) {
  const size_t off = sp.key_off(p, k0), stride = (size_t)p.KH * p.hd;
  const int n_valid = sp.kv_end - k0;
  copy_tile(sK, ld, (const T*)p.k + off, stride, n, n_valid, p.hd, p.vec);
  copy_tile(sV, ld, (const T*)p.v + off, stride, n, n_valid, p.hd, p.vec);
}

// bf16 on the tensor cores: blockDim.x / 32 warps of 16 * MT rows. QREG:
// each warp holds its Q rows in registers (MT = 1 up to Hd 128); otherwise
// Q is staged in shared memory. CAP: a logit softcap.
template <int KD, int MT, bool QREG, bool CAP>
__global__ void __launch_bounds__(128)
    flash_attention_tc(const Problem p) {
  constexpr int BN = TcTile<KD>::BN, LD = TcTile<KD>::LD, HDP = KD * 16;
  constexpr int NS = TcTile<KD>::STAGES;
  constexpr int WR = 16 * MT;  // rows a warp owns
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = WR * (blockDim.x >> 5);
  bf16* sQ = reinterpret_cast<bf16*>(smem);   // [rows][LD] unless QREG
  bf16* sK = sQ + (QREG ? 0 : rows * LD);     // [NS][BN][LD]
  bf16* sV = sK + NS * BN * LD;               // [NS][BN][LD]
  const bf16* q = (const bf16*)p.q;
  const Span sp(p, rows);
  const int n_tiles = (sp.kv_end - sp.kv_begin + BN - 1) / BN;

  zero_cols(sK, LD, NS * BN, p.hd, HDP);
  zero_cols(sV, LD, NS * BN, p.hd, HDP);
  if (!QREG) {
    zero_cols(sQ, LD, rows, p.hd, HDP);
    load_rows(sQ, LD, rows, p.hd, p.vec, q, [&](int j) -> const bf16* {
      return sp.r0 + j < sp.r1 ? q + sp.row_off(p, sp.r0 + j) : nullptr;
    });
  }
  // tiles 0 .. NS - 2 in flight before the loop, one commit group each
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n_tiles)
      stage_kv(p, sp, sp.kv_begin + i * BN, BN, sK + i * BN * LD,
               sV + i * BN * LD, LD);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5;
  const int wr0 = sp.r0 + WR * warp;  // the warp's first row
  const bool idle = wr0 >= sp.r1;
  const int wt0 = wr0 / p.G, wt1 = (min(wr0 + WR, sp.r1) - 1) / p.G;
  // the lane's rows: their positions and their offsets in q (and in o)
  int t_row[2 * MT];
  const bf16* q_row[2 * MT];
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) {
    const int row = wr0 + frag_row(r);
    t_row[r] = row / p.G;
    q_row[r] = row < sp.r1 ? q + sp.row_off(p, row) : nullptr;
  }
  QRegs<KD, MT> qr;  // unused (and compiled away) unless QREG
  if constexpr (QREG) qr.load(q_row, p.hd, p.vec >= 4);
  const QSmem<KD> qs{sQ + WR * warp * LD};

  TcWarp<KD, MT> w;
  w.init();
  for (int it = 0; it < n_tiles; ++it) {
    __syncthreads();  // every warp is done with tile it - 1's stage
    const int nxt = it + NS - 1;  // goes where tile it - 1 was
    if (nxt < n_tiles)
      stage_kv(p, sp, sp.kv_begin + nxt * BN, BN, sK + nxt % NS * BN * LD,
               sV + nxt % NS * BN * LD, LD);
    cp_async_commit();
    cp_async_wait<NS - 1>();  // tile `it` landed; later ones may be in flight
    __syncthreads();
    const int k0 = sp.kv_begin + it * BN, cur = it % NS;
    if (idle || (p.causal && k0 > wt1) ||
        (p.window > 0 && k0 + BN - 1 <= wt0 - p.window))
      continue;  // the tile is wholly masked for the warp's rows
    const bool full = k0 + BN <= p.S && (!p.causal || k0 + BN - 1 <= wt0) &&
                      (p.window <= 0 || k0 > wt1 - p.window);
    const bf16 *tK = sK + cur * BN * LD, *tV = sV + cur * BN * LD;
    auto ok = [&](int r, int c) { return sp.ok(p, t_row[r], k0 + c); };
    if constexpr (QREG) {
      w.template update<CAP>(qr, tK, tV, p.scale, p.softcap, full, ok);
    } else {
      w.template update<CAP>(qs, tK, tV, p.scale, p.softcap, full, ok);
    }
  }
  w.finish();

  w.store(p.hd, true, [&](int r, int col, float x) {
    if (q_row[r]) store_f((bf16*)p.o + (q_row[r] - q) + col, x);
  });
}

// fp32 on the CUDA cores: 4 warps of 8 rows.
template <int HPL>
__global__ void __launch_bounds__(kThreads)
    flash_attention_fma(const Problem p) {
  constexpr int rows = kWarps * kRowsPerWarp;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = fma_ld(p.hd), hd4 = (p.hd + 3) / 4 * 4;
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + rows * ld;       // [2][kTile][ld]
  float* sV = sK + 2 * kTile * ld;  // [2][kTile][ld]
  const float* q = (const float*)p.q;
  const Span sp(p, rows);

  zero_cols(sQ, ld, rows, p.hd, hd4);
  zero_cols(sK, ld, 2 * kTile, p.hd, hd4);
  load_rows(sQ, ld, rows, p.hd, p.vec, q, [&](int j) -> const float* {
    return sp.r0 + j < sp.r1 ? q + sp.row_off(p, sp.r0 + j) : nullptr;
  });
  stage_kv(p, sp, sp.kv_begin, kTile, sK, sV, ld);
  cp_async_commit();

  FmaRows<HPL> st;
  st.init();
  const int n_rows = sp.r1 - sp.r0;
  const int n_tiles = (sp.kv_end - sp.kv_begin + kTile - 1) / kTile;
  for (int it = 0; it < n_tiles; ++it) {
    __syncthreads();
    if (it + 1 < n_tiles) {
      const int nxt = (it + 1) & 1;
      stage_kv(p, sp, sp.kv_begin + (it + 1) * kTile, kTile,
               sK + nxt * kTile * ld, sV + nxt * kTile * ld, ld);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = sp.kv_begin + it * kTile, cur = it & 1;
    st.update(sQ, sK + cur * kTile * ld, sV + cur * kTile * ld, ld, p.hd,
              n_rows, p.scale, p.softcap, [&](int r, int lane) {
                return sp.ok(p, (sp.r0 + r) / p.G, k0 + lane);
              });
  }

  float* o = (float*)p.o;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (r < n_rows) {
      float* out = o + sp.row_off(p, sp.r0 + r);
      st.store(i, p.hd, true, [&](int d, float x) { out[d] = x; });
    }
  }
}

inline int cdiv(long a, long b) { return (int)((a + b - 1) / b); }

template <int KD, int MT, bool QREG, bool CAP>
int launch_tc_tile(const Problem& p, int B, int warps, cudaStream_t stream) {
  constexpr int BN = TcTile<KD>::BN, LD = TcTile<KD>::LD;
  constexpr int NS = TcTile<KD>::STAGES;
  const int rows = 16 * MT * warps;
  const size_t smem =
      sizeof(bf16) * (size_t)((QREG ? 0 : rows) + 2 * NS * BN) * LD;
  auto kernel = flash_attention_tc<KD, MT, QREG, CAP>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(cdiv((long)p.S * p.G, rows), B * p.KH);
  kernel<<<grid, 32 * warps, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Query rows per block: 128 (4 warps of 32 rows, Hd <= 128) where that
// still gives a wave of 132 blocks, else the largest of 64, 32 (2 or 4
// warps of 16 rows) that gives half a wave, else 16 (one warp).
template <int KD>
int launch_tc(const Problem& p, int B, cudaStream_t stream) {
  const long n_rows = (long)p.S * p.G;
  int rows = 16;
  if (KD <= 8 && (long)cdiv(n_rows, 128) * B * p.KH >= 132) {
    rows = 128;
  } else {
    for (int r = 64; r > 16; r >>= 1)
      if ((long)cdiv(n_rows, r) * B * p.KH >= 66) {
        rows = r;
        break;
      }
  }
  constexpr bool kQreg = KD <= 8;
  const bool cap = p.softcap > 0.f;
  if constexpr (KD <= 8) {
    if (rows == 128)
      return cap ? launch_tc_tile<KD, 2, false, true>(p, B, 4, stream)
                 : launch_tc_tile<KD, 2, false, false>(p, B, 4, stream);
  }
  return cap ? launch_tc_tile<KD, 1, kQreg, true>(p, B, rows / 16, stream)
             : launch_tc_tile<KD, 1, kQreg, false>(p, B, rows / 16, stream);
}

template <int HPL>
int launch_fma(const Problem& p, int B, cudaStream_t stream) {
  constexpr int rows = kWarps * kRowsPerWarp;
  const size_t smem =
      sizeof(float) * (size_t)(rows + 4 * kTile) * fma_ld(p.hd);
  auto kernel = flash_attention_fma<HPL>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(cdiv((long)p.S * p.G, rows), B * p.KH);
  kernel<<<grid, kThreads, smem, stream>>>(p);
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
  if (KH <= 0 || H % KH != 0 || hd <= 0 || hd > kMaxHeadDim || S <= 0 ||
      B <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const void* ptrs[3] = {q, k, v};
  Problem p{q, k, v, o, S, H, KH, hd, H / KH, causal, window, 0, softcap,
            scale};
  if (dtype == 0) {
    p.vec = copy_width(hd, sizeof(float), ptrs, 3);
#define LAUNCH(HPL) return launch_fma<HPL>(p, B, s)
    ATTN_DISPATCH_HPL(hd, LAUNCH);
#undef LAUNCH
  } else if (dtype == 1) {
    p.vec = copy_width(hd, sizeof(bf16), ptrs, 3);
#define LAUNCH(KD) return launch_tc<KD>(p, B, s)
    ATTN_DISPATCH_KD(hd, LAUNCH);
#undef LAUNCH
  }
  return (int)cudaErrorInvalidValue;
}
