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
// update per head (chip_smoke.py's time_ssd counts the same). So it is
// compute-bound on the CUDA cores. It stays fp32 there: the JAX kernel works
// in fp32, and TF32 on the tensor cores keeps about three decimal digits,
// which cannot meet the 2e-5 x max|ref| the fp32 checks hold it to.
//
// What the design does about it:
// - the grid is (batch * head, P-splits): row p of the (P, N) state and
//   column p of y depend only on x[:, p], the shared scores and the decays,
//   so a block owns 16 head dims and the split needs no second pass: 128
//   blocks at mamba2's serving shape, 320 at zamba2's (H=80, P=64). The
//   TPU grid's sequential chunk axis is a loop inside the block, and the
//   block's part of the state lives in registers between chunks;
// - C.B^T is the same for every head of a group, so it is not recomputed
//   by every block: the P-splits of a head form a thread-block cluster,
//   each block computes its share of the chunk's causal 32 x 32 tiles
//   (tile t belongs to rank t % cluster), and the pair loop reads each tile
//   from its owner through distributed shared memory, one tile ahead of
//   its use. The plan (ops.py::plan) takes clusters of 2, which the H100
//   holds all at once at one block an SM, or 4 where only that keeps the
//   chunk in shared memory (zamba2);
// - where the owned tiles cannot stay in shared memory (they grow with the
//   square of the chunk) or the splits are odd, a block computes each
//   tile pair's C.B^T itself just before its use, into one tile
//   (streamed: no cluster); chip_smoke.py times this recompute variant
//   beside the plan;
// - every product is register-tiled, its operands read as float4 from
//   shared memory with row strides of an odd number of 16-byte groups:
//   C.B^T (a thread owns 4 x 4 sums over a quarter of N; the quarters are
//   added in a fixed order), the decay-weighted scores times x (a thread
//   owns one row x 2 head dims), C.state^T (a warp owns an eighth of N,
//   4 x 4 sums a lane), and the state update (a thread owns 2 x 4 state
//   entries in registers);
// - a chunk's C, B and x rows are staged whole with 16-byte cp.async when
//   they fit in shared memory (every serving shape and zamba2's), so a
//   chunk waits for one round trip; otherwise (Q = 256 with N = 128) tile by
//   tile. The plan picks the mode and the shared memory size, which the
//   entry checks against its own count. The C.state^T term is skipped
//   while the state is zero (no initial state, first chunk);
// - the log-decay a_cum is a warp scan over the chunk in segments of 32, and
//   every decay is exp of a *difference* a_cum[i] - a_cum[j] <= 0: A reaches
//   -16 and dt is a softplus, so a_cum reaches the hundreds within a chunk
//   and exp(a_cum[i]) * exp(-a_cum[j]) would be inf * 0 = NaN.
// Every sum runs in a fixed order and nothing is atomic, so a run repeats
// itself bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../sm90.cuh"

namespace {

using namespace sm90;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;    // query rows / keys of a score tile
constexpr int kPS = 16;      // head dims (P) of a block
constexpr int kMaxN = 256;   // state dims a block holds
constexpr int kKN = kMaxN / 128;
constexpr int kPart = 5120;  // floats of the split-sum partials (and the
                             // two score buffers of the pair loop)
constexpr int kLdPartS = 40, kLdPartI = 20;  // their row strides
constexpr int kLdS = kTile + 1;              // row stride of the scores
constexpr int kLdR = kTile + 4;              // row stride of a raw score tile
constexpr int kMaxCluster = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // per block, sm_90

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
  int cl;              // blocks of a cluster, sharing the raw scores
  bool vec_x, vec_bc;  // 16-byte copies of x rows, of B and C rows
};

// Row stride (floats) of the C, B and state rows: N rounded up to 4, plus 4
// where that makes the stride an odd number of 16-byte groups.
__host__ __device__ inline int row_ld(int N) { return 4 * (((N + 3) / 4) | 1); }
__host__ __device__ inline int round_tile(int q) {
  return (q + kTile - 1) / kTile * kTile;
}

// Causal (query tile, key tile) pairs of a chunk, and those a block of a
// cluster of cl owns (pair t belongs to rank t % cl).
__host__ __device__ inline int n_pairs(int Q) {
  const int t = round_tile(Q) / kTile;
  return t * (t + 1) / 2;
}
__host__ __device__ inline int owned_pairs(int Q, int cl) {
  return (n_pairs(Q) + cl - 1) / cl;
}

// Floats of shared memory: C, B and x rows (a whole chunk when resident,
// else one tile of each), the state, the partials (which also hold the
// scores of the pair loop), the raw score tiles the block owns when
// shared (else the one of the current pair), and dt, a_cum and the
// state-update weights of a chunk. ops.py::plan mirrors it.
inline size_t smem_floats(int N, int Q, int cl, bool resident, bool shared) {
  const size_t rows = resident ? round_tile(Q) : kTile;
  const size_t raw = shared ? owned_pairs(Q, cl) : 1;
  return rows * (2 * (size_t)row_ld(N) + kPS) + (size_t)kPS * row_ld(N) +
         kPart + raw * kTile * kLdR + 3 * (size_t)round_tile(Q);
}

// dst[r * ld + c] = src(r)[c] for r < valid_rows, c < width, zeros up to
// `cols` columns and `rows` rows. vec: 16-byte cp.async (width and cols
// multiples of 4, rows 16-byte aligned), committed but not waited for;
// else plain loads, 8 in flight a thread.
template <typename Src>
__device__ __forceinline__ void stage(float* dst, int ld, int rows,
                                      int valid_rows, int cols, int width,
                                      bool vec, const float* any, Src src) {
  if (vec) {
    const int per = cols / 4;
    for (int i = threadIdx.x; i < rows * per; i += kThreads) {
      const int r = i / per, c = 4 * (i - r * per);
      const bool ok = r < valid_rows && c < width;
      cp_async<16>(dst + r * ld + c, ok ? src(r) + c : any, ok);
    }
    return;
  }
  constexpr int kBatch = 8;
  const int n = rows * cols;
  for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads, r = i / cols, c = i - r * cols;
      v[u] = (i < n && r < valid_rows && c < width) ? src(r)[c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads, r = i / cols;
      if (i < n) dst[r * ld + i - r * cols] = v[u];
    }
  }
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// out[r][c] += sum over n4 in [k0, k1) of A row (ri + 8r) . Bt row (ci +
// 8c), 4 floats at a time: the split sums of C.B^T and C.state^T.
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* A,
                                         const float* Bt, int ld, int ri,
                                         int ci, int rstride_b, int k0,
                                         int k1) {
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    float4 av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = ld4(A + (ri + 8 * r) * ld + 4 * k);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bv[c] = ld4(Bt + (ci + rstride_b * c) * ld + 4 * k);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = dot4(av[r], bv[c], acc[r][c]);
  }
}

// The split sums of C.B^T of one tile pair: C rows tC, B rows tB (row
// stride ld, N4 groups of 4), four groups of 64 threads, each a quarter of
// N, added in that order into dst (kTile x kLdR).
__device__ __forceinline__ void raw_scores(float* dst, const float* tC,
                                           const float* tB, int ld, int N4,
                                           float* sPart) {
  const int tid = threadIdx.x, grp = tid >> 6, lt = tid & 63;
  const int ti = lt >> 3, tj = lt & 7, nq = (N4 + 3) / 4;
  float acc[4][4] = {};
  dot_tile(acc, tC, tB, ld, ti, tj, 8, grp * nq, min(N4, (grp + 1) * nq));
  float* part = sPart + grp * kTile * kLdPartS;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      part[(ti + 8 * r) * kLdPartS + tj + 8 * c] = acc[r][c];
  __syncthreads();
  const int si = tid >> 3, sj = 4 * (tid & 7);
  float4 s = ld4(sPart + si * kLdPartS + sj);
#pragma unroll
  for (int q = 1; q < 4; ++q) {
    const float4 v = ld4(sPart + q * kTile * kLdPartS + si * kLdPartS + sj);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  *reinterpret_cast<float4*>(dst + si * kLdR + sj) = s;
  __syncthreads();  // the partials are read before the next use
}

// One block: (batch * head blockIdx.x, head dims [16 y, 16 y + 16)), rank
// blockIdx.y % cl of a cluster of cl P-splits of the same head. SHARED:
// the cluster shares the raw C.B^T tiles; else (cl = 1) the block computes
// each pair's tile as it goes.
template <bool RESIDENT, bool SHARED>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.N, Q = a.Q, ld = row_ld(N), Qt = round_tile(Q);
  const int N4 = (N + 3) / 4, cl = a.cl, np = n_pairs(Q);
  const int rows = RESIDENT ? Qt : kTile;
  float* sC = smem;
  float* sB = sC + rows * ld;
  float* sX = sB + rows * ld;
  float* sState = sX + rows * kPS;
  float* sPart = sState + kPS * ld;
  float* sS = sPart;  // two score buffers, by pair parity
  float* sRaw = sPart + kPart;
  float* sDt = sRaw + (SHARED ? owned_pairs(Q, cl) : 1) * kTile * kLdR;
  float* sAcum = sDt + Qt;
  float* sW = sAcum + Qt;

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int g = h / (a.H / a.G);
  const int rank = blockIdx.y % cl;
  const int p0 = blockIdx.y * kPS, pn = min(kPS, a.P - p0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float A_h = a.A[h], D_h = a.D[h];
  const size_t state_base = ((size_t)b * a.H + h) * a.P * N;

  // the block's state entries: p = sp, sp + 1; n = sn + 128 k + 0..3
  const int sp = 2 * (tid & 7), sn = 4 * (tid >> 3);
  float st[kKN][2][4];
#pragma unroll
  for (int k = 0; k < kKN; ++k)
#pragma unroll
    for (int pp = 0; pp < 2; ++pp)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = sp + pp, n = sn + 128 * k + j;
        st[k][pp][j] = (a.h0 && p < pn && n < N)
                           ? a.h0[state_base + (size_t)(p0 + p) * N + n]
                           : 0.f;
      }
  bool has_state = a.h0 != nullptr;

  // the thread's outputs: y row yi of a query tile, head dims yp, yp + 1
  const int yi = tid >> 3, yp = 2 * (tid & 7);

  auto rows_c = [&](int s0) {
    return [=](int r) { return a.C.row(b, s0 + r, g); };
  };
  auto rows_b = [&](int s0) {
    return [=](int r) { return a.B.row(b, s0 + r, g); };
  };
  auto rows_x = [&](int s0) {
    return [=](int r) { return a.x.row(b, s0 + r, h) + p0; };
  };
  // tiled mode: stage tiles now (barriers on both sides)
  auto stage_now = [&](float* dst, int ld_, int cols, int width, bool vec,
                       const float* any, auto src, int valid) {
    __syncthreads();
    stage(dst, ld_, kTile, valid, cols, width, vec, any, src);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  };

  for (int c0 = 0; c0 < a.S; c0 += Q) {
    // the peers have read this block's raw scores of the last chunk
    if (c0 > 0) cluster_wait();
    __syncthreads();  // the last chunk's readers are done
    if (RESIDENT) {
      stage(sC, ld, Qt, Q, 4 * N4, N, a.vec_bc, a.C.ptr, rows_c(c0));
      stage(sB, ld, Qt, Q, 4 * N4, N, a.vec_bc, a.B.ptr, rows_b(c0));
      stage(sX, kPS, Qt, Q, kPS, pn, a.vec_x, a.x.ptr, rows_x(c0));
      cp_async_commit();
    }
    for (int i = tid; i < Qt; i += kThreads)
      sDt[i] = i < Q ? *a.dt.row(b, c0 + i, h) : 0.f;
    if (has_state) {
#pragma unroll
      for (int k = 0; k < kKN; ++k)
        if (sn + 128 * k < 4 * N4)
#pragma unroll
          for (int pp = 0; pp < 2; ++pp)
            *reinterpret_cast<float4*>(sState + (sp + pp) * ld + sn + 128 * k) =
                make_float4(st[k][pp][0], st[k][pp][1], st[k][pp][2],
                            st[k][pp][3]);
    }
    __syncthreads();
    if (warp == 0) {  // inclusive cumsum of dt * A
      float carry = 0.f;
      for (int i0 = 0; i0 < Qt; i0 += 32) {
        float v = sDt[i0 + lane] * A_h;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float t = __shfl_up_sync(kFull, v, o);
          if (lane >= o) v += t;
        }
        v += carry;
        sAcum[i0 + lane] = v;
        carry = __shfl_sync(kFull, v, 31);
      }
    }
    __syncthreads();
    const float a_last = sAcum[Q - 1];
    for (int j = tid; j < Qt; j += kThreads)
      sW[j] = j < Q ? sDt[j] * expf(a_last - sAcum[j]) : 0.f;
    if (RESIDENT) cp_async_wait<0>();
    __syncthreads();

    // C.B^T of the tile pairs this block owns (pair t: query tile it, key
    // tile jt <= it, t = it (it + 1) / 2 + jt; owner t % cl)
    for (int t = rank, it = 0; SHARED && t < np; t += cl) {
      while ((it + 1) * (it + 2) / 2 <= t) ++it;
      const int jt = t - it * (it + 1) / 2;
      const float* tC = sC + (RESIDENT ? it * kTile * ld : 0);
      const float* tB = sB + (RESIDENT ? jt * kTile * ld : 0);
      if (!RESIDENT) {
        __syncthreads();
        stage(sC, ld, kTile, Q - it * kTile, 4 * N4, N, a.vec_bc, a.C.ptr,
              rows_c(c0 + it * kTile));
        stage(sB, ld, kTile, Q - jt * kTile, 4 * N4, N, a.vec_bc, a.B.ptr,
              rows_b(c0 + jt * kTile));
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      raw_scores(sRaw + (t / cl) * kTile * kLdR, tC, tB, ld, N4, sPart);
    }
    cluster_arrive();  // every block's raw scores are written ...
    cluster_wait();    // ... before any block reads them

    // the thread's 4 raw scores of pair t (query row si, keys sj..sj+3),
    // read from the owner one pair ahead of their use
    const int si = tid >> 3, sj = 4 * (tid & 7);
    auto raw = [&](int t) {
      return SHARED && t < np
                 ? ld_peer16(peer_addr(
                       sRaw + (t / cl) * kTile * kLdR + si * kLdR + sj,
                       t % cl))
                 : make_uint4(0, 0, 0, 0);
    };
    uint4 next = raw(0);

    for (int i0 = 0, t0 = 0; i0 < Qt; i0 += kTile) {
      const bool last = i0 + kTile >= Qt;
      float y0 = 0.f, y1 = 0.f;

      // inter-chunk: exp(a_cum[i]) C_i . state^T, the state from before
      // this chunk; warp w sums n4 in [w*nq, (w+1)*nq)
      if (has_state) {
        const float* tC = sC + (RESIDENT ? i0 * ld : 0);
        if (RESIDENT) {
          __syncthreads();  // the last pair's readers of the scores are done
        } else {
          stage_now(sC, ld, 4 * N4, N, a.vec_bc, a.C.ptr, rows_c(c0 + i0),
                    Q - i0);
        }
        const int ti = lane >> 2, tp = lane & 3;
        const int nq = (N4 + kWarps - 1) / kWarps;
        float acc[4][4] = {};
        dot_tile(acc, tC, sState, ld, ti, tp, 4, warp * nq,
                 min(N4, (warp + 1) * nq));
        float* part = sPart + warp * kTile * kLdPartI;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            part[(ti + 8 * r) * kLdPartI + tp + 4 * c] = acc[r][c];
        __syncthreads();
        float t0s = 0.f, t1s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float2 v = *reinterpret_cast<const float2*>(
              sPart + w * kTile * kLdPartI + yi * kLdPartI + yp);
          t0s += v.x;
          t1s += v.y;
        }
        const float e = i0 + yi < Q ? expf(sAcum[i0 + yi]) : 0.f;
        y0 = e * t0s;
        y1 = e * t1s;
        __syncthreads();  // the partials are read before they change
      }

      // intra-chunk: key tiles up to and including the diagonal one
      const float* tX = sX;
      for (int j0 = 0; j0 <= i0; j0 += kTile, ++t0) {
        const float* tB = sB + (RESIDENT ? j0 * ld : 0);
        tX = sX + (RESIDENT ? j0 * kPS : 0);
        if (!RESIDENT) {
          __syncthreads();
          if (!SHARED && j0 == 0)
            stage(sC, ld, kTile, Q - i0, 4 * N4, N, a.vec_bc, a.C.ptr,
                  rows_c(c0 + i0));
          if (last || !SHARED)
            stage(sB, ld, kTile, Q - j0, 4 * N4, N, a.vec_bc, a.B.ptr,
                  rows_b(c0 + j0));
          stage(sX, kPS, kTile, Q - j0, kPS, pn, a.vec_x, a.x.ptr,
                rows_x(c0 + j0));
          cp_async_commit();
          cp_async_wait<0>();
          __syncthreads();
        }
        float* tS = sS + (t0 & 1) * kTile * kLdS;
        if (!SHARED) {  // this pair's raw scores, into the one raw tile
          if (RESIDENT) __syncthreads();  // the last pair's scores are read
          raw_scores(sRaw, sC + (RESIDENT ? i0 * ld : 0), tB, ld, N4, sPart);
          next = *reinterpret_cast<const uint4*>(sRaw + si * kLdR + sj);
        }
        {  // the owner's raw scores, times decay and dt, causal mask
          const uint4 u = next;
          next = raw(t0 + 1);
          const float v[4] = {__uint_as_float(u.x), __uint_as_float(u.y),
                              __uint_as_float(u.z), __uint_as_float(u.w)};
          const int i = i0 + si;
          const float ai = i < Q ? sAcum[i] : 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = j0 + sj + q;
            tS[si * kLdS + sj + q] =
                (i < Q && j <= i) ? v[q] * expf(ai - sAcum[j]) * sDt[j] : 0.f;
          }
        }
        __syncthreads();
        // y[i, p] += sum_j score[i, j] x[j, p]
#pragma unroll 8
        for (int jj = 0; jj < kTile; ++jj) {
          const float s = tS[yi * kLdS + jj];
          const float2 xv = *reinterpret_cast<const float2*>(tX + jj * kPS + yp);
          y0 = fmaf(s, xv.x, y0);
          y1 = fmaf(s, xv.y, y1);
        }
        if (last) {  // the state update, over every key tile of the chunk
          if (j0 == 0) {
            const float decay = expf(a_last);
#pragma unroll
            for (int k = 0; k < kKN; ++k)
#pragma unroll
              for (int pp = 0; pp < 2; ++pp)
#pragma unroll
                for (int j = 0; j < 4; ++j) st[k][pp][j] *= decay;
          }
#pragma unroll
          for (int k = 0; k < kKN; ++k) {
            if (sn + 128 * k >= 4 * N4) continue;
#pragma unroll 4
            for (int jj = 0; jj < kTile; ++jj) {
              const float w = sW[j0 + jj];
              const float2 xv =
                  *reinterpret_cast<const float2*>(tX + jj * kPS + sp);
              const float4 bv = ld4(tB + jj * ld + sn + 128 * k);
              const float x0 = xv.x * w, x1 = xv.y * w;
              st[k][0][0] = fmaf(x0, bv.x, st[k][0][0]);
              st[k][0][1] = fmaf(x0, bv.y, st[k][0][1]);
              st[k][0][2] = fmaf(x0, bv.z, st[k][0][2]);
              st[k][0][3] = fmaf(x0, bv.w, st[k][0][3]);
              st[k][1][0] = fmaf(x1, bv.x, st[k][1][0]);
              st[k][1][1] = fmaf(x1, bv.y, st[k][1][1]);
              st[k][1][2] = fmaf(x1, bv.z, st[k][1][2]);
              st[k][1][3] = fmaf(x1, bv.w, st[k][1][3]);
            }
          }
        }
        // resident: the next pair writes the other score buffer, so one
        // barrier a pair; tiled: the next staging begins with one
      }

      // tX is the diagonal tile: x of the query rows
      const int i = i0 + yi;
      if (i < Q) {
        float* yr = a.y + (((size_t)b * a.S + c0 + i) * a.H + h) * a.P + p0;
        const float2 xv = *reinterpret_cast<const float2*>(tX + yi * kPS + yp);
        if (yp < pn) yr[yp] = y0 + D_h * xv.x;
        if (yp + 1 < pn) yr[yp + 1] = y1 + D_h * xv.y;
      }
    }
    cluster_arrive();  // this block is done reading its peers' raw scores
    has_state = true;
  }
  cluster_wait();

#pragma unroll
  for (int k = 0; k < kKN; ++k)
#pragma unroll
    for (int pp = 0; pp < 2; ++pp)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = sp + pp, n = sn + 128 * k + j;
        if (p < pn && n < N)
          a.hf[state_base + (size_t)(p0 + p) * N + n] = st[k][pp][j];
      }
}

template <bool RESIDENT, bool SHARED>
int launch(const Args& a, int splits, size_t smem, cudaStream_t stream) {
  if (smem != sizeof(float) * smem_floats(a.N, a.Q, a.cl, RESIDENT, SHARED) ||
      smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  auto kernel = ssd_scan_kernel<RESIDENT, SHARED>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.nb * a.H, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.cl;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool aligned(const void* p, long long s0, long long s1, long long s2) {
  return (uintptr_t)p % 16 == 0 && s0 % 4 == 0 && s1 % 4 == 0 && s2 % 4 == 0;
}

}  // namespace

// x (B,S,H,P), dt (B,S,H), Bm/Cm (B,S,G,N): fp32, any strides with a unit
// last one (given in elements: batch, seq, head-or-group). A, D (H,); h0
// (B,H,P,N) or null for zeros; y (B,S,H,P) and hf (B,H,P,N) contiguous
// outputs. S % chunk == 0, H % G == 0, N <= 256. The plan (ops.py::plan):
// `splits` blocks per (batch, head), each 16 head dims, in clusters of
// `cluster` that share the scores (`shared`; else cluster 1, each block
// computing its own), the chunk's rows staged whole (`resident`) or tile
// by tile, and `smem` bytes of shared memory a block, checked against the
// kernel's own count. Launches on `stream` and returns the CUDA error code
// (0 = ok).
extern "C" int ssd_scan_launch(
    const void* x, long long xb, long long xs, long long xh, const void* dt,
    long long db, long long ds, long long dh, const void* Bm, long long bb,
    long long bs, long long bg, const void* Cm, long long cb, long long cs,
    long long cg, const void* A, const void* D, const void* h0, void* y,
    void* hf, int nb, int S, int H, int P, int G, int N, int chunk,
    int splits, int cluster, int resident, int shared, long long smem,
    void* stream) {
  if (nb <= 0 || S <= 0 || H <= 0 || P <= 0 || G <= 0 || H % G != 0 ||
      N <= 0 || N > kMaxN || chunk <= 0 || S % chunk != 0 ||
      splits * kPS < P || (splits - 1) * kPS >= P || splits > 65535 ||
      cluster < 1 || cluster > kMaxCluster || splits % cluster != 0 ||
      (!shared && cluster != 1) || smem <= 0)
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
         nb, S, H, P, G, N, chunk, cluster,
         aligned(x, xb, xs, xh) && P % 4 == 0,
         aligned(Bm, bb, bs, bg) && aligned(Cm, cb, cs, cg) && N % 4 == 0};
  cudaStream_t s = (cudaStream_t)stream;
  const size_t bytes = (size_t)smem;
  if (resident)
    return shared ? launch<true, true>(a, splits, bytes, s)
                  : launch<true, false>(a, splits, bytes, s);
  return shared ? launch<false, true>(a, splits, bytes, s)
                : launch<false, false>(a, splits, bytes, s);
}
