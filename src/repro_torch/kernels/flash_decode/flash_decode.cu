// One query position per sequence against a KV cache (GQA), for sm_90a.
//
// Replaces the Pallas TPU kernel `flash_decode_gqa`
// (src/repro/kernels/flash_decode/kernel.py), which the JAX model reaches
// from attention.attn_decode on every decode tick. Same function as that
// package's oracle `decode_ref`: for each (batch, kv head) the G query rows
// attend cache positions [0, valid_len) with an fp32 online softmax and an
// optional logit softcap; `valid_len` is one int32 shared by the batch.
//
// What bounds it on this card: bytes. It does about 4 FLOP per cache byte
// (G = 4), far below the ~20 FLOP/byte at which even fp32 FMA would
// overtake HBM, so its floor is the bytes of K and V below valid_len over
// 3.35 TB/s. The design point is enough loads in flight across the card.
//
// What the design does about it:
// - split-KV: the grid is (batch x kv head x row tile, split). The wrapper
//   picks the number of splits from the cache capacity S alone (about four
//   one-warp blocks to each of the 132 SMs, at least 128 keys a split;
//   never from valid_len, so the grid never depends on the data and a
//   decode step never syncs the host). Each split reads valid_len on the
//   card; a split that starts at or past it writes an empty partial
//   (m = -inf constant, l = 0) and stops.
// - each split writes its rows' partial (m, l, acc) to fp32 scratch that the
//   wrapper allocates; a second kernel, one block per row, adds the splits
//   in their fixed order, so a run repeats itself bit for bit. With one
//   split (a cache under 256 positions, as at the serving shapes, where the
//   second launch would cost more than the split saves) the first kernel
//   writes the output itself.
// - a block holds the rows of one (batch, kv head) (a tile of them where G
//   is large), so the cache is read once for all G heads, never expanded to
//   H; K/V tiles are copied by cp.async, 16 bytes a copy where the row
//   allows, into two stages, so the next tile's copy overlaps this tile's
//   arithmetic.
// - bf16: the rows go on the tensor cores in 16-row warp tiles with Q in
//   registers (G = 4 pads to 16: the kernel is bound by bytes, so the padded
//   rows cost no time that matters); fp32: CUDA-core FMA, one row per warp
//   when G <= 4 (8 otherwise), since TF32 would miss the fp32 checks' 2e-5.
#include "../attn_tile.cuh"

namespace {

using namespace attn;

struct Problem {
  const void* q;  // (B, KH, G, hd): the (B, 1, H, hd) query
  const void* k;  // (B, S, KH, hd)
  const void* v;
  const int* valid_len;
  void* o;        // like q
  float* part;    // n_split > 1: m [n_split][N], l [n_split][N],
                  // acc [n_split][N][hd], N = B * KH * G rows
  int N, S, KH, hd, G, rows, n_split, chunk, vec;
  float softcap, scale;
};

// The block's rows (rows [row0, row0 + n_rows) of its (batch, kv head)'s G,
// global row grow0 for row0) and its keys [k_lo, k_hi).
struct Tile {
  int bkh, n_rows, k_lo, k_hi;
  size_t grow0;

  __device__ __forceinline__ explicit Tile(const Problem& p) {
    const int row_tiles = (p.G + p.rows - 1) / p.rows;
    bkh = blockIdx.x / row_tiles;
    const int row0 = (blockIdx.x % row_tiles) * p.rows;
    n_rows = min(p.rows, p.G - row0);
    grow0 = (size_t)bkh * p.G + row0;
    const int n_valid = min(max(p.valid_len[0], 0), p.S);
    k_lo = blockIdx.y * p.chunk;
    k_hi = min(k_lo + p.chunk, n_valid);
  }

  __device__ __forceinline__ size_t key_off(const Problem& p, int key) const {
    return (((size_t)(bkh / p.KH) * p.S + key) * p.KH + bkh % p.KH) *
           (size_t)p.hd;
  }
};

// Stage keys [k0, k0 + n) of the block's kv head; keys at or past k_hi are
// zero-filled.
template <typename T>
__device__ __forceinline__ void stage_kv(const Problem& p, const Tile& tl,
                                         int k0, int n, T* sK, T* sV,
                                         int ld) {
  const size_t off = tl.key_off(p, k0), stride = (size_t)p.KH * p.hd;
  const int n_valid = tl.k_hi - k0;
  copy_tile(sK, ld, (const T*)p.k + off, stride, n, n_valid, p.hd, p.vec);
  copy_tile(sV, ld, (const T*)p.v + off, stride, n, n_valid, p.hd, p.vec);
}

template <typename T>
__device__ __forceinline__ void load_q(const Problem& p, const Tile& tl,
                                       T* sQ, int ld, int rows) {
  const T* q = (const T*)p.q;
  load_rows(sQ, ld, rows, p.hd, p.vec, q, [&](int j) -> const T* {
    return j < tl.n_rows ? q + (tl.grow0 + j) * p.hd : nullptr;
  });
}

// Where a split's partial of row r (a row of the block's tile) goes.
struct Partial {
  float *m, *l, *acc;
  __device__ __forceinline__ Partial(const Problem& p, const Tile& tl) {
    const size_t s = blockIdx.y, n = p.N;
    m = p.part + s * n + tl.grow0;
    l = p.part + (p.n_split + s) * n + tl.grow0;
    acc = p.part + 2 * p.n_split * n + (s * n + tl.grow0) * p.hd;
  }
};

// bf16 on the tensor cores: blockDim.x / 32 warps of 16 rows, each warp's
// Q rows in registers up to Hd 128 (QREG), else staged in shared memory.
// CAP: a logit softcap.
template <int KD, bool QREG, bool CAP>
__global__ void __launch_bounds__(128) flash_decode_tc(const Problem p) {
  constexpr int BN = TcTile<KD>::BN, LD = TcTile<KD>::LD, HDP = KD * 16;
  constexpr int NS = TcTile<KD>::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = p.rows;
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [rows][LD] unless QREG
  bf16* sK = sQ + (QREG ? 0 : rows * LD);    // [NS][BN][LD]
  bf16* sV = sK + NS * BN * LD;              // [NS][BN][LD]
  const Tile tl(p);
  const int warp = threadIdx.x >> 5;
  const bool empty = tl.k_lo >= tl.k_hi;  // uniform across the block

  TcWarp<KD> w;
  w.init();
  if (!empty) {
    const int n_tiles = (tl.k_hi - tl.k_lo + BN - 1) / BN;
    zero_cols(sK, LD, NS * BN, p.hd, HDP);
    zero_cols(sV, LD, NS * BN, p.hd, HDP);
    if (!QREG) {
      zero_cols(sQ, LD, rows, p.hd, HDP);
      load_q(p, tl, sQ, LD, rows);
    }
    // tiles 0 .. NS - 2 in flight before the loop, one commit group each
    for (int i = 0; i < NS - 1; ++i) {
      if (i < n_tiles)
        stage_kv(p, tl, tl.k_lo + i * BN, BN, sK + i * BN * LD,
                 sV + i * BN * LD, LD);
      cp_async_commit();
    }
    QRegs<KD, 1> qr;  // unused (and compiled away) unless QREG
    if constexpr (QREG) {
      const bf16* q_row[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + frag_row(r);
        q_row[r] = row < tl.n_rows
                       ? (const bf16*)p.q + (tl.grow0 + row) * p.hd
                       : nullptr;
      }
      qr.load(q_row, p.hd, p.vec >= 4);
    }
    const QSmem<KD> qs{sQ + 16 * warp * LD};
    for (int it = 0; it < n_tiles; ++it) {
      __syncthreads();  // every warp is done with tile it - 1's stage
      const int nxt = it + NS - 1;  // goes where tile it - 1 was
      if (nxt < n_tiles)
        stage_kv(p, tl, tl.k_lo + nxt * BN, BN, sK + nxt % NS * BN * LD,
                 sV + nxt % NS * BN * LD, LD);
      cp_async_commit();
      cp_async_wait<NS - 1>();  // tile `it` landed
      __syncthreads();
      if (16 * warp >= tl.n_rows) continue;  // a warp with no rows
      const int k0 = tl.k_lo + it * BN, cur = it % NS;
      const bool full = k0 + BN <= tl.k_hi;
      const bf16 *tK = sK + cur * BN * LD, *tV = sV + cur * BN * LD;
      auto ok = [&](int, int c) { return k0 + c < tl.k_hi; };
      if constexpr (QREG) {
        w.template update<CAP>(qr, tK, tV, p.scale, p.softcap, full, ok);
      } else {
        w.template update<CAP>(qs, tK, tV, p.scale, p.softcap, full, ok);
      }
    }
  }
  w.finish();

  if (p.n_split == 1) {
    bf16* o = (bf16*)p.o + tl.grow0 * p.hd;
    w.store(p.hd, true, [&](int r, int col, float x) {
      const int row = 16 * warp + frag_row(r);
      if (row < tl.n_rows) store_f(o + (size_t)row * p.hd + col, x);
    });
    return;
  }
  const Partial part(p, tl);
  // the row max in log2 units (TcWarp keeps raw scores without a softcap)
  const float s2 = p.softcap > 0.f ? 1.f : p.scale * kLog2e;
  if ((threadIdx.x & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + frag_row(r);
      if (row < tl.n_rows) {
        part.m[row] = w.m[r] * s2;
        part.l[row] = w.l[r];
      }
    }
  }
  if (!empty)
    w.store(p.hd, false, [&](int r, int col, float x) {
      const int row = 16 * warp + frag_row(r);
      if (row < tl.n_rows) part.acc[(size_t)row * p.hd + col] = x;
    });
}

// fp32 on the CUDA cores: 4 warps of ROWS rows.
template <int HPL, int ROWS>
__global__ void __launch_bounds__(kThreads) flash_decode_fma(const Problem p) {
  constexpr int rows = kWarps * ROWS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = fma_ld(p.hd), hd4 = (p.hd + 3) / 4 * 4;
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + rows * ld;       // [2][kTile][ld]
  float* sV = sK + 2 * kTile * ld;  // [2][kTile][ld]
  const Tile tl(p);
  const bool empty = tl.k_lo >= tl.k_hi;

  FmaRows<HPL, ROWS> st;
  st.init();
  if (!empty) {
    zero_cols(sQ, ld, rows, p.hd, hd4);
    zero_cols(sK, ld, 2 * kTile, p.hd, hd4);
    load_q(p, tl, sQ, ld, rows);
    stage_kv(p, tl, tl.k_lo, kTile, sK, sV, ld);
    cp_async_commit();
    const int n_tiles = (tl.k_hi - tl.k_lo + kTile - 1) / kTile;
    for (int it = 0; it < n_tiles; ++it) {
      __syncthreads();
      if (it + 1 < n_tiles) {
        const int nxt = (it + 1) & 1;
        stage_kv(p, tl, tl.k_lo + (it + 1) * kTile, kTile,
                 sK + nxt * kTile * ld, sV + nxt * kTile * ld, ld);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const int k0 = tl.k_lo + it * kTile, cur = it & 1;
      st.update(sQ, sK + cur * kTile * ld, sV + cur * kTile * ld, ld, p.hd,
                tl.n_rows, p.scale, p.softcap,
                [&](int, int lane) { return k0 + lane < tl.k_hi; });
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (p.n_split == 1) {
    float* o = (float*)p.o + tl.grow0 * p.hd;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = warp + kWarps * i;
      if (r < tl.n_rows)
        st.store(i, p.hd, true,
                 [&](int d, float x) { o[(size_t)r * p.hd + d] = x; });
    }
    return;
  }
  const Partial part(p, tl);
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = warp + kWarps * i;
    if (r >= tl.n_rows) continue;
    if (lane == 0) {
      part.m[r] = st.m[i];  // natural units
      part.l[r] = st.l[i];
    }
    if (!empty)
      st.store(i, p.hd, false, [&](int d, float x) {
        part.acc[(size_t)r * p.hd + d] = x;
      });
  }
}

// Add the n_split partials of one row per block. Warp 0 takes the row's
// max m over the splits (M), each split's weight w_s = exp2((m_s - M) *
// unit) (unit 1 for m in log2 units, log2 e for natural units; 0 where
// l_s = 0: a split that saw no key wrote no acc) and L = sum w_s l_s; then
// thread d adds w_s acc_s[d] over the splits in their order and writes
// acc / L (L == 0 -> 1). Every sum runs in a fixed order, so a run repeats
// itself bit for bit.
template <typename T>
__global__ void __launch_bounds__(256)
    combine_splits(const float* __restrict__ part, T* __restrict__ o, int N,
                   int hd, int n_split, float unit) {
  extern __shared__ float w[];  // n_split weights
  __shared__ float inv_l;
  const size_t r = blockIdx.x;
  const float* pm = part + r;  // split s at s * N
  const float* pl = part + (size_t)n_split * N + r;
  const float* pa = part + 2 * (size_t)n_split * N + r * hd;
  if (threadIdx.x < 32) {
    float M = kNegInf;
    for (int s = threadIdx.x; s < n_split; s += 32)
      M = fmaxf(M, pm[(size_t)s * N]);
    M = warp_max(M);
    float L = 0.f;
    for (int s = threadIdx.x; s < n_split; s += 32) {
      const float ls = pl[(size_t)s * N];
      const float ws = ls == 0.f ? 0.f : exp2f((pm[(size_t)s * N] - M) * unit);
      w[s] = ws;
      L = fmaf(ws, ls, L);
    }
    L = warp_sum(L);
    if (threadIdx.x == 0) inv_l = 1.f / (L == 0.f ? 1.f : L);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float acc = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) {
      const float a = pa[(size_t)s * N * hd + d];
      acc = w[s] != 0.f ? fmaf(w[s], a, acc) : acc;
    }
    store_f(o + r * hd + d, acc * inv_l);
  }
}

template <typename T>
int launch_combine(const Problem& p, float unit, cudaStream_t stream) {
  if (p.n_split == 1) return (int)cudaSuccess;
  const int threads = min(256, (p.hd + 31) / 32 * 32);
  combine_splits<T><<<p.N, threads, sizeof(float) * p.n_split, stream>>>(
      p.part, (T*)p.o, p.N, p.hd, p.n_split, unit);
  return (int)cudaGetLastError();
}

template <int KD>
int launch_tc(Problem p, int B, cudaStream_t stream) {
  constexpr int BN = TcTile<KD>::BN, LD = TcTile<KD>::LD;
  constexpr int NS = TcTile<KD>::STAGES;
  constexpr bool kQreg = KD <= 8;
  p.rows = min(16 * ((p.G + 15) / 16), 64);
  const size_t smem =
      sizeof(bf16) * (size_t)((kQreg ? 0 : p.rows) + 2 * NS * BN) * LD;
  auto kernel = p.softcap > 0.f ? flash_decode_tc<KD, kQreg, true>
                                 : flash_decode_tc<KD, kQreg, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * p.KH * ((p.G + p.rows - 1) / p.rows), p.n_split);
  kernel<<<grid, 32 * (p.rows / 16), smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_combine<bf16>(p, 1.f, stream);
}

template <int HPL, int ROWS>
int launch_fma(Problem p, int B, cudaStream_t stream) {
  p.rows = kWarps * ROWS;
  const size_t smem =
      sizeof(float) * (size_t)(p.rows + 4 * kTile) * fma_ld(p.hd);
  auto kernel = flash_decode_fma<HPL, ROWS>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * p.KH * ((p.G + p.rows - 1) / p.rows), p.n_split);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_combine<float>(p, kLog2e, stream);
}

}  // namespace

// q, o: (B, KH, G, hd); k, v: (B, S, KH, hd); valid_len: one int32 on the
// device; all contiguous. part: fp32 scratch of n_split * B * KH * G *
// (hd + 2) values when n_split > 1 (unused otherwise). dtype: 0 = fp32,
// 1 = bf16. Launches on `stream` and returns the CUDA error code (0 = ok).
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* valid_len,
                                   void* o, void* part, int B, int S, int KH,
                                   int hd, int G, int n_split, float softcap,
                                   float scale, int dtype, void* stream) {
  if (KH <= 0 || G <= 0 || hd <= 0 || hd > kMaxHeadDim || S <= 0 || B <= 0 ||
      n_split < 1 || n_split > S || n_split > 4096 ||
      (n_split > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const void* ptrs[3] = {q, k, v};
  Problem p{q, k, v, (const int*)valid_len, o, (float*)part, B * KH * G, S,
            KH, hd, G, 0, n_split, (S + n_split - 1) / n_split, 0, softcap,
            scale};
  if (dtype == 0) {
    p.vec = copy_width(hd, sizeof(float), ptrs, 3);
    // one row per warp when the group fits (llama: G = 4 over 4 warps)
#define LAUNCH(HPL)                                             \
  return G <= kWarps ? launch_fma<HPL, 1>(p, B, s)              \
                     : launch_fma<HPL, kRowsPerWarp>(p, B, s)
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
