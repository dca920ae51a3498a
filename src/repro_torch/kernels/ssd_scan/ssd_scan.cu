// Mamba2 SSD chunked scan (state-space duality), fp32, for sm_90a.
//
// Replaces the Pallas TPU kernel `ssd_scan` (src/repro/kernels/ssd_scan/
// kernel.py, body `_ssd_kernel`), which the JAX model reaches from
// ssm.mamba_prefill on every mamba layer of a prefill. Same function as the
// JAX package's `ssd_chunked`: per (batch, head), over chunks of Q steps,
//   a_cum[i] = sum_{t<=i} dt[t] * A                       (inclusive)
//   y[i]     = sum_{j<=i} (C_i . B_j) exp(a_cum[i] - a_cum[j]) dt[j] x[j]
//            + exp(a_cum[i]) C_i . state^T + D x[i]
//   state   <- state exp(a_cum[Q-1])
//            + sum_j x[j] dt[j] exp(a_cum[Q-1] - a_cum[j]) B_j^T
// with the (P, N) state entering from `h0` (or zeros) and leaving as `hf`.
// B and C are shared by the H/G heads of a group.
//
// What bounds it on this card: at the serving shape (B=1, S=96 = one chunk,
// H=32, P=64, G=1, N=128) it moves about 2.7 MB (x and y 0.8 MB each, the
// final state 1 MB, B and C 0.1 MB) -> 0.82 us at 3.35 TB/s, and does about
// 35 M fp32 FMA = 0.07 GFLOP -> 1.05 us at 67 TFLOP/s: C.B^T over the causal
// (i >= j) pairs once per group, its product with x per head, the state
// update per head; C.state^T is not counted for the first chunk, whose
// entering state is zero, though this kernel computes it (chip_smoke.py's
// time_ssd counts the same). So it is
// compute-bound on the CUDA cores, as the JAX kernel works in fp32 and the
// model casts every input to fp32 before the call.
//
// What the design does about it:
// - one block per (batch, head); the TPU grid's sequential chunk axis is a
//   loop inside the block, so the state never leaves the SM between chunks
//   (blocks run in no order on the card, nothing carries between them);
// - the (P, N) state lives in shared memory with a row stride of N+1 floats
//   (32 KB at the serving shape), so 32 lanes reading 32 rows hit 32 banks;
// - the chunk is never built whole in shared memory (at Q=256, N=128 one B
//   or C chunk is 128 KB and the (Q, Q) decay matrix 256 KB): the intra-chunk
//   term runs over tiles of 32 query rows x 32 key columns, as the attention
//   kernels do; lane j scores key j, and the P.V-like product with x takes
//   each score from its lane by a shuffle;
// - the log-decay a_cum is a warp scan over the chunk in segments of 32, and
//   every decay is exp of a *difference* a_cum[i] - a_cum[j] <= 0: A reaches
//   -16 and dt is a softplus, so a_cum reaches the hundreds within a chunk
//   and exp(a_cum[i]) * exp(-a_cum[j]) would be inf * 0 = NaN;
// - every row reads the state from before its chunk; the state update comes
//   after a barrier, once all tiles of the chunk have read it.
// Known limit: at the serving shape this is 32 blocks on 132 SMs, and every
// product is fp32 FMA fed from shared memory. Splitting heads or chunks
// across blocks (a second pass for the carried state) and tensor cores are
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;                      // query rows / key columns
constexpr int kRowsPerWarp = kTile / kWarps;   // query rows a warp owns
constexpr int kMaxLanesP = 4;                  // head dims a lane owns: P<=128
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLoadBatch = 8;                  // loads in flight per thread
constexpr size_t kMaxSmem = 232448;            // per block, sm_90

// A model-layout input: element (b, s, k, d) at ptr[b*sb + s*ss + k*sk + d].
struct Strided {
  const float* ptr;
  long long sb, ss, sk;
  __device__ __forceinline__ const float* row(int b, int s, int k) const {
    return ptr + b * sb + s * ss + k * sk;
  }
};

struct Args {
  Strided x, dt, B, C;  // dt has no d axis: one value per (b, s, h)
  const float* A;
  const float* D;
  const float* h0;  // (B, H, P, N) contiguous, or null for zeros
  float* y;         // (B, S, H, P) contiguous
  float* hf;        // (B, H, P, N) contiguous
  int nb, S, H, P, G, N, Q;
};

// dst[r * dst_stride + d] = load(r, d) for r < rows, d < width. Each thread
// issues kLoadBatch independent loads before it stores any of them.
template <typename Load>
__device__ __forceinline__ void stage(float* dst, int dst_stride, int rows,
                                      int width, Load load) {
  const int n = rows * width;
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kLoadBatch) {
    float v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int idx = i0 + u * kThreads;
      const int r = idx / width;
      v[u] = idx < n ? load(r, idx - r * width) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int idx = i0 + u * kThreads;
      const int r = idx / width;
      if (idx < n) dst[r * dst_stride + idx - r * width] = v[u];
    }
  }
}

inline size_t smem_floats(int P, int N, int Q) {
  return (size_t)P * (N + 1)       // state
         + (size_t)kTile * N       // C rows of the query tile
         + (size_t)kTile * (N + 1) // B rows of the key tile
         + (size_t)kTile * P       // x rows of the key tile
         + 3 * (size_t)Q;          // dt, a_cum, state-update weights
}

template <int PL>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(Args a) {
  extern __shared__ float smem[];
  const int P = a.P, N = a.N, Q = a.Q;
  float* sState = smem;
  float* sC = sState + P * (N + 1);
  float* sB = sC + kTile * N;
  float* sX = sB + kTile * (N + 1);
  float* sDt = sX + kTile * P;
  float* sAcum = sDt + Q;
  float* sW = sAcum + Q;

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int g = h / (a.H / a.G);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float A_h = a.A[h], D_h = a.D[h];
  const size_t state_base = ((size_t)b * a.H + h) * P * N;

  for (int e = threadIdx.x; e < P * N; e += kThreads) {
    const int p = e / N, n = e - p * N;
    sState[p * (N + 1) + n] = a.h0 ? a.h0[state_base + e] : 0.f;
  }

  for (int c0 = 0; c0 < a.S; c0 += Q) {
    // --- dt, inclusive cumsum of dt * A, state-update weights
    __syncthreads();
    for (int i = threadIdx.x; i < Q; i += kThreads)
      sDt[i] = *a.dt.row(b, c0 + i, h);
    __syncthreads();
    if (warp == 0) {
      float carry = 0.f;
      for (int i0 = 0; i0 < Q; i0 += 32) {
        const int i = i0 + lane;
        float v = i < Q ? sDt[i] * A_h : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float t = __shfl_up_sync(kFull, v, o);
          if (lane >= o) v += t;
        }
        v += carry;
        if (i < Q) sAcum[i] = v;
        carry = __shfl_sync(kFull, v, 31);
      }
    }
    __syncthreads();
    const float a_last = sAcum[Q - 1];
    for (int j = threadIdx.x; j < Q; j += kThreads)
      sW[j] = sDt[j] * expf(a_last - sAcum[j]);

    // --- y, one tile of kTile query rows at a time
    for (int i0 = 0; i0 < Q; i0 += kTile) {
      __syncthreads();  // the last tile's readers of sC are done
      stage(sC, N, kTile, N, [&](int r, int n) {
        return i0 + r < Q ? a.C.row(b, c0 + i0 + r, g)[n] : 0.f;
      });
      float acc[kRowsPerWarp][PL];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int k = 0; k < PL; ++k) acc[r][k] = 0.f;

      // intra-chunk: key tiles up to and including the diagonal one
      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        __syncthreads();  // the last key tile's readers are done
        stage(sB, N + 1, kTile, N, [&](int r, int n) {
          return j0 + r < Q ? a.B.row(b, c0 + j0 + r, g)[n] : 0.f;
        });
        stage(sX, P, kTile, P, [&](int r, int p) {
          return j0 + r < Q ? a.x.row(b, c0 + j0 + r, h)[p] : 0.f;
        });
        __syncthreads();
        // lane scores key j0 + lane against the warp's rows
        float sc[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) sc[r] = 0.f;
        const float* brow = sB + lane * (N + 1);
        for (int n = 0; n < N; ++n) {
          const float bv = brow[n];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            sc[r] += sC[(warp + kWarps * r) * N + n] * bv;
        }
        const int j = j0 + lane;
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int i = i0 + warp + kWarps * r;
          // causal mask i >= j, diagonal included; decay of a difference
          sc[r] = (i < Q && j <= i)
                      ? sc[r] * expf(sAcum[i] - sAcum[j]) * sDt[j]
                      : 0.f;
        }
        // y[i, p] += sum_j sc[i, j] x[j, p]; lane owns p = lane + 32 k
        for (int jj = 0; jj < kTile; ++jj) {
          float xv[PL];
#pragma unroll
          for (int k = 0; k < PL; ++k) {
            const int p = lane + 32 * k;
            xv[k] = p < P ? sX[jj * P + p] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const float s = __shfl_sync(kFull, sc[r], jj);
#pragma unroll
            for (int k = 0; k < PL; ++k) acc[r][k] += s * xv[k];
          }
        }
      }

      // inter-chunk: exp(a_cum[i]) C_i . state^T, the state from before
      // this chunk
      float t[kRowsPerWarp][PL];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int k = 0; k < PL; ++k) t[r][k] = 0.f;
      for (int n = 0; n < N; ++n) {
        float st[PL];
#pragma unroll
        for (int k = 0; k < PL; ++k)
          st[k] = sState[min(lane + 32 * k, P - 1) * (N + 1) + n];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float cv = sC[(warp + kWarps * r) * N + n];
#pragma unroll
          for (int k = 0; k < PL; ++k) t[r][k] += cv * st[k];
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int i = i0 + warp + kWarps * r;
        if (i >= Q) continue;
        const float e = expf(sAcum[i]);
        const float* xi = a.x.row(b, c0 + i, h);
        float* yi = a.y + (((size_t)b * a.S + c0 + i) * a.H + h) * P;
#pragma unroll
        for (int k = 0; k < PL; ++k) {
          const int p = lane + 32 * k;
          if (p < P) yi[p] = acc[r][k] + e * t[r][k] + D_h * xi[p];
        }
      }
    }

    // --- state update, after every row of the chunk has read the state
    __syncthreads();
    const float decay = expf(a_last);
    for (int e = threadIdx.x; e < P * N; e += kThreads) {
      const int p = e / N, n = e - p * N;
      sState[p * (N + 1) + n] *= decay;
    }
    for (int j0 = 0; j0 < Q; j0 += kTile) {
      __syncthreads();
      stage(sB, N + 1, kTile, N, [&](int r, int n) {
        return j0 + r < Q ? a.B.row(b, c0 + j0 + r, g)[n] : 0.f;
      });
      stage(sX, P, kTile, P, [&](int r, int p) {
        return j0 + r < Q ? a.x.row(b, c0 + j0 + r, h)[p] * sW[j0 + r] : 0.f;
      });
      __syncthreads();
      // a warp owns 4 state rows x 128 columns per pass (lane: n = lane +
      // 32 c), so each staged value feeds 4 FMAs from registers
      for (int p0 = warp * 4; p0 < P; p0 += kWarps * 4) {
        for (int n0 = 0; n0 < N; n0 += 128) {
          float u[4][4];
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) u[rr][cc] = 0.f;
          for (int jj = 0; jj < kTile; ++jj) {
            float xv[4], bv[4];
#pragma unroll
            for (int rr = 0; rr < 4; ++rr)
              xv[rr] = sX[jj * P + min(p0 + rr, P - 1)];
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              bv[cc] = sB[jj * (N + 1) + min(n0 + lane + 32 * cc, N - 1)];
#pragma unroll
            for (int rr = 0; rr < 4; ++rr)
#pragma unroll
              for (int cc = 0; cc < 4; ++cc) u[rr][cc] += xv[rr] * bv[cc];
          }
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              const int p = p0 + rr, n = n0 + lane + 32 * cc;
              if (p < P && n < N) sState[p * (N + 1) + n] += u[rr][cc];
            }
        }
      }
    }
  }

  __syncthreads();
  for (int e = threadIdx.x; e < P * N; e += kThreads) {
    const int p = e / N, n = e - p * N;
    a.hf[state_base + e] = sState[p * (N + 1) + n];
  }
}

template <int PL>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(a.P, a.N, a.Q);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = ssd_scan_kernel<PL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.nb * a.H, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B,S,H,P), dt (B,S,H), Bm/Cm (B,S,G,N): fp32, any strides with a unit
// last one (given in elements: batch, seq, head-or-group). A, D (H,); h0
// (B,H,P,N) or null for zeros; y (B,S,H,P) and hf (B,H,P,N) contiguous
// outputs. S % chunk == 0, H % G == 0, P <= 128. Launches on `stream` and
// returns the CUDA error code (0 = ok).
extern "C" int ssd_scan_launch(
    const void* x, long long xb, long long xs, long long xh, const void* dt,
    long long db, long long ds, long long dh, const void* Bm, long long bb,
    long long bs, long long bg, const void* Cm, long long cb, long long cs,
    long long cg, const void* A, const void* D, const void* h0, void* y,
    void* hf, int nb, int S, int H, int P, int G, int N, int chunk,
    void* stream) {
  if (nb <= 0 || S <= 0 || H <= 0 || P <= 0 || P > 32 * kMaxLanesP ||
      G <= 0 || H % G != 0 || N <= 0 || chunk <= 0 || S % chunk != 0)
    return (int)cudaErrorInvalidValue;
  Args a{{(const float*)x, xb, xs, xh},
         {(const float*)dt, db, ds, dh},
         {(const float*)Bm, bb, bs, bg},
         {(const float*)Cm, cb, cs, cg},
         (const float*)A,
         (const float*)D,
         (const float*)h0,
         (float*)y,
         (float*)hf,
         nb, S, H, P, G, N, chunk};
  cudaStream_t s = (cudaStream_t)stream;
  switch ((P + 31) / 32) {
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 3: return launch<3>(a, s);
    default: return launch<4>(a, s);
  }
}
