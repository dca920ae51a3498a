// Fused per-expert SwiGLU over capacity-dispatched tokens, for sm_90a.
//
// Replaces the Pallas TPU kernel `moe_expert_ffn` (src/repro/kernels/
// moe_ffn/kernel.py, body `_moe_ffn_kernel`), which the JAX model reaches
// from moe._expert_ffn on every MoE layer of a prefill and of a decode step.
// Same function as the JAX package's `expert_ffn_ref`: for each group g,
// expert e and capacity row c,
//   out[g,e,c,:] = (silu(x[g,e,c,:] Wg_e) * (x[g,e,c,:] Wu_e)) Wd_e
// with x (G,E,C,D), Wg/Wu (E,D,F), Wd (E,F,D) of one dtype (fp32 or
// bf16), every product and sum in fp32, the result in that dtype. A row of zeros (an empty or dropped
// capacity slot) gives a row of zeros.
//
// What bounds it on this card: the expert weights. At granite-moe-1b's
// serving shapes (G=1, E=32, D=1024, F=512, bf16) one launch reads
// 3*E*D*F*2 B = 100.7 MB of weights -> 30.0 us at 3.35 TB/s, whatever C is;
// x and the output add 2*E*C*D*2 B (0.3 MB at C=4, 3.9 MB at C=30). The
// operations, 6*G*E*C*D*F = 0.40 GFLOP at C=4 and 3.02 GFLOP at C=30, take
// 0.4-3.1 us at the bf16 tensor-core peak, so by that rate the bound is
// bytes at every serving shape. This first version does them as fp32 FMA
// on the CUDA cores (67 TFLOP/s): 6.0 us at C=4 but 45 us at C=30, so a
// prefill launch is held by arithmetic before it reaches the bytes bound.
//
// What the design does about it:
// - the TPU grid walks F sequentially into one VMEM accumulator; on the card
//   blocks run in no order, so the grid is (G*E, C-tiles, F-ranges): at
//   decode G*E = 32 and one block per (g, e) would leave 100 of 132 SMs
//   idle while the weights stream, so F is cut into ranges until about two
//   blocks per SM are in flight (8 ranges of 64 at every serving shape);
// - a block computes h = silu(x Wg) * (x Wu) for its C-tile and F-range into
//   shared memory (h never reaches device memory), then its partial
//   down-projection over all of D;
// - with more than one F-range the partials go to an fp32 scratch buffer
//   that the wrapper allocates, and a second kernel sums them in the fixed
//   order of the ranges: no atomics, so a run repeats itself bit for bit (a
//   one-ulp change in a layer can flip a later layer's top-k choice);
// - Wg/Wu are read along F (32 lanes on 32 neighbouring columns) and Wd
//   along D (a thread owns two neighbouring columns), each element once per
//   C-tile; at the serving shapes C fits one tile (C <= 32), so once per
//   launch. The capacity rows of a tile live in each thread's registers
//   (phase A: BC gate and BC up sums for one F column; phase B: BC x 2
//   output sums), so one weight load feeds BC FMAs;
// - the x tile is staged in shared memory as fp32, 512 columns of D at a
//   time, and read as float4 broadcasts; the four warps that share an F
//   column split D and their sums are added in a fixed order.
// Known limits: fp32 FMA on the CUDA cores, not wgmma; no TMA or cp.async
// pipeline; the scratch round trip (8 ranges x E*C*D fp32) at prefill.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSlice = 64;                 // F columns of one phase-A pass
constexpr int kKSplit = kWarps / 2;        // warps that split D per column
constexpr int kChunkD = 512;               // x columns staged at a time
constexpr int kKPerWarp = kChunkD / kKSplit;
constexpr int kDownCols = 2 * kThreads;    // output columns per phase-B pass
constexpr int kMaxHFloats = 16384;         // h tile: 64 KB of shared memory
constexpr long long kTargetBlocks = 2 * 132;
constexpr size_t kMaxSmem = 232448;        // per block, sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Two neighbouring elements; `vec` when the pair is aligned (D even).
__device__ __forceinline__ float2 load2(const float* p, bool ok0, bool ok1,
                                       bool vec) {
  if (vec) return ok0 ? *reinterpret_cast<const float2*>(p)
                      : make_float2(0.f, 0.f);
  return make_float2(ok0 ? p[0] : 0.f, ok1 ? p[1] : 0.f);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p, bool ok0,
                                       bool ok1, bool vec) {
  if (vec) return ok0 ? __bfloat1622float2(
                            *reinterpret_cast<const __nv_bfloat162*>(p))
                      : make_float2(0.f, 0.f);
  return make_float2(ok0 ? to_f(p[0]) : 0.f, ok1 ? to_f(p[1]) : 0.f);
}

// How a launch is cut: BC capacity rows per tile (nc tiles), fw F columns
// per block (nf ranges). Host code; the wrapper sizes its scratch from it.
struct Plan {
  int bc, nc, fw, nf;
};

Plan make_plan(int G, int E, int C, int F) {
  Plan p;
  p.bc = C <= 4 ? 4 : C <= 8 ? 8 : C <= 16 ? 16 : 32;
  p.nc = (C + p.bc - 1) / p.bc;
  const long long tiles = (long long)G * E * p.nc;
  const int slices = (F + kSlice - 1) / kSlice;
  const int max_per = std::max(1, kMaxHFloats / p.bc / kSlice);
  long long nf = (kTargetBlocks + tiles - 1) / tiles;
  nf = std::max<long long>(nf, (slices + max_per - 1) / max_per);
  nf = std::min<long long>(std::max<long long>(nf, 1), slices);
  const int per = (slices + (int)nf - 1) / (int)nf;  // slices per block
  p.fw = per * kSlice;
  p.nf = (F + p.fw - 1) / p.fw;
  return p;
}

size_t smem_bytes(const Plan& p) {
  return sizeof(float) * ((size_t)p.bc * kChunkD + 2 * (size_t)p.bc * kSlice +
                          (size_t)p.fw * p.bc);
}

template <typename T>
struct Args {
  const T* x;
  const T* wg;
  const T* wu;
  const T* wd;
  T* out;          // (G, E, C, D)
  float* scratch;  // (nf, G, E, C, D) when nf > 1
  int G, E, C, D, F, fw, nf;
  bool wd_pairs;   // Wd read two elements at a time (D even, aligned)
};

template <typename T, int BC>
__global__ void __launch_bounds__(kThreads) moe_ffn_kernel(const Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  float* sX = smem;                  // [BC][kChunkD]   x tile, fp32
  float* sG = sX + BC * kChunkD;     // [BC][kSlice]    gate sums
  float* sU = sG + BC * kSlice;      // [BC][kSlice]    up sums
  float* sH = sU + BC * kSlice;      // [fw][BC]        h = silu(g) * u

  const int D = a.D, F = a.F;
  const int ge = blockIdx.x, e = ge % a.E;
  const int c0 = blockIdx.y * BC;
  const int rows = min(BC, a.C - c0);
  const int f0 = blockIdx.z * a.fw;
  const int fn = min(a.fw, F - f0);
  const T* x = a.x + ((size_t)ge * a.C + c0) * D;
  const T* wg = a.wg + (size_t)e * D * F;
  const T* wu = a.wu + (size_t)e * D * F;
  const T* wd = a.wd + (size_t)e * F * D + (size_t)f0 * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int colw = (warp & 1) * 32 + lane;  // column within the slice
  const int kq = warp >> 1;                 // which part of D

  // ---- phase A: h for the block's F columns, 64 at a time, into sH
  for (int s0 = 0; s0 < fn; s0 += kSlice) {
    const bool col_ok = s0 + colw < fn;
    const int col = f0 + s0 + colw;
    float ag[BC], au[BC];
#pragma unroll
    for (int r = 0; r < BC; ++r) ag[r] = au[r] = 0.f;
    for (int kc = 0; kc < D; kc += kChunkD) {
      const int kw = min(kChunkD, D - kc);
      __syncthreads();  // the last readers of sX are done
      for (int i = threadIdx.x; i < BC * kChunkD; i += kThreads) {
        const int r = i / kChunkD, k = i - r * kChunkD;
        sX[i] = (r < rows && k < kw) ? to_f(x[(size_t)r * D + kc + k]) : 0.f;
      }
      __syncthreads();
      const int kb = kq * kKPerWarp;
      const int kend = min(kKPerWarp, kw - kb);
      const T* pg = wg + (size_t)(kc + kb) * F + col;
      const T* pu = wu + (size_t)(kc + kb) * F + col;
#pragma unroll 2
      for (int kk = 0; kk < kend; kk += 4) {
        float g4[4], u4[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = col_ok && kk + j < kend;
          g4[j] = ok ? to_f(pg[(size_t)(kk + j) * F]) : 0.f;
          u4[j] = ok ? to_f(pu[(size_t)(kk + j) * F]) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < BC; ++r) {
          const float4 xv =
              *reinterpret_cast<const float4*>(sX + r * kChunkD + kb + kk);
          ag[r] = fmaf(xv.x, g4[0], ag[r]);
          ag[r] = fmaf(xv.y, g4[1], ag[r]);
          ag[r] = fmaf(xv.z, g4[2], ag[r]);
          ag[r] = fmaf(xv.w, g4[3], ag[r]);
          au[r] = fmaf(xv.x, u4[0], au[r]);
          au[r] = fmaf(xv.y, u4[1], au[r]);
          au[r] = fmaf(xv.z, u4[2], au[r]);
          au[r] = fmaf(xv.w, u4[3], au[r]);
        }
      }
    }
    // the kKSplit parts of D, added in the fixed order kq = 0, 1, ...
    for (int q = 0; q < kKSplit; ++q) {
      __syncthreads();  // q = 0: the last slice's readers of sG/sU are done
      if (kq == q) {
#pragma unroll
        for (int r = 0; r < BC; ++r) {
          const int i = r * kSlice + colw;
          sG[i] = q == 0 ? ag[r] : sG[i] + ag[r];
          sU[i] = q == 0 ? au[r] : sU[i] + au[r];
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BC * kSlice; i += kThreads) {
      const int r = i / kSlice, j = i - r * kSlice;
      if (s0 + j < fn) {
        const float g = sG[i];
        sH[(s0 + j) * BC + r] = g / (1.f + expf(-g)) * sU[i];
      }
    }
  }
  __syncthreads();

  // ---- phase B: the partial down-projection of the block's F columns
  const bool vec = a.wd_pairs;
  const size_t plane = (size_t)a.G * a.E * a.C * D;
  for (int d0 = 0; d0 < D; d0 += kDownCols) {
    const int d = d0 + 2 * threadIdx.x;
    const bool ok0 = d < D, ok1 = d + 1 < D;
    float acc[BC][2];
#pragma unroll
    for (int r = 0; r < BC; ++r) acc[r][0] = acc[r][1] = 0.f;
#pragma unroll 4
    for (int f = 0; f < fn; ++f) {
      const float2 w = load2(wd + (size_t)f * D + d, ok0, ok1, vec);
      const float* hf = sH + f * BC;
#pragma unroll
      for (int r = 0; r < BC; r += 4) {
        const float4 h4 = *reinterpret_cast<const float4*>(hf + r);
        acc[r][0] = fmaf(h4.x, w.x, acc[r][0]);
        acc[r][1] = fmaf(h4.x, w.y, acc[r][1]);
        acc[r + 1][0] = fmaf(h4.y, w.x, acc[r + 1][0]);
        acc[r + 1][1] = fmaf(h4.y, w.y, acc[r + 1][1]);
        acc[r + 2][0] = fmaf(h4.z, w.x, acc[r + 2][0]);
        acc[r + 2][1] = fmaf(h4.z, w.y, acc[r + 2][1]);
        acc[r + 3][0] = fmaf(h4.w, w.x, acc[r + 3][0]);
        acc[r + 3][1] = fmaf(h4.w, w.y, acc[r + 3][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < BC; ++r) {
      if (r >= rows) break;
      const size_t o = ((size_t)ge * a.C + c0 + r) * D + d;
      if (a.nf == 1) {
        if (ok0) store_f(a.out + o, acc[r][0]);
        if (ok1) store_f(a.out + o + 1, acc[r][1]);
      } else {
        float* s = a.scratch + blockIdx.z * plane + o;
        if (ok0) s[0] = acc[r][0];
        if (ok1) s[1] = acc[r][1];
      }
    }
  }
}

// out[i] = sum of the nf partials of element i, in the order of the ranges.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    moe_ffn_sum(const float* __restrict__ scratch, T* __restrict__ out,
                long long n, int nf) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    float s = 0.f;
    for (int j = 0; j < nf; ++j) s += scratch[(size_t)j * n + i];
    store_f(out + i, s);
  }
}

template <typename T, int BC>
int launch(const Args<T>& a, const Plan& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = moe_ffn_kernel<T, BC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.G * a.E, p.nc, p.nf), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.nf == 1) return (int)err;
  const long long n = (long long)a.G * a.E * a.C * a.D;
  const long long blocks =
      std::min<long long>((n + kThreads - 1) / kThreads, 8 * 132);
  moe_ffn_sum<T><<<(int)blocks, kThreads, 0, stream>>>(a.scratch, a.out, n,
                                                       p.nf);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* wg, const void* wu, const void* wd,
             void* out, void* scratch, int G, int E, int C, int D, int F,
             cudaStream_t stream) {
  const Plan p = make_plan(G, E, C, F);
  if (p.nf > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const bool wd_pairs = D % 2 == 0 && (uintptr_t)wd % (2 * sizeof(T)) == 0;
  const Args<T> a{(const T*)x, (const T*)wg,  (const T*)wu,
                  (const T*)wd, (T*)out,      (float*)scratch,
                  G, E, C, D, F, p.fw, p.nf, wd_pairs};
  switch (p.bc) {
    case 4: return launch<T, 4>(a, p, stream);
    case 8: return launch<T, 8>(a, p, stream);
    case 16: return launch<T, 16>(a, p, stream);
    default: return launch<T, 32>(a, p, stream);
  }
}

}  // namespace

// fp32 elements of scratch a launch of these sizes needs (0: none).
extern "C" long long moe_ffn_workspace(int G, int E, int C, int D, int F) {
  if (G <= 0 || E <= 0 || C <= 0 || D <= 0 || F <= 0) return 0;
  const Plan p = make_plan(G, E, C, F);
  return p.nf > 1 ? (long long)p.nf * G * E * C * D : 0;
}

// x (G,E,C,D), wg/wu (E,D,F), wd (E,F,D), out (G,E,C,D), all contiguous
// and of one dtype (0 = float32, 1 = bfloat16); scratch holds
// moe_ffn_workspace(...) floats. Launches on `stream` and returns the CUDA
// error code (0 = ok).
extern "C" int moe_ffn_launch(const void* x, const void* wg, const void* wu,
                              const void* wd, void* out, void* scratch, int G,
                              int E, int C, int D, int F, int dtype,
                              void* stream) {
  if (G <= 0 || E <= 0 || C <= 0 || D <= 0 || F <= 0 || C > 65535 * 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(x, wg, wu, wd, out, scratch, G, E, C, D, F, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, wg, wu, wd, out, scratch, G, E, C, D,
                                   F, s);
  return (int)cudaErrorInvalidValue;
}
