// Building blocks shared by the port's CUDA kernels for sm_90a: element
// conversions, cp.async staging, bf16 tensor-core fragments (ldmatrix and
// mma.sync m16n8k16 with fp32 sums) and thread-block-cluster primitives
// (distributed shared memory and the cluster barrier), all as inline PTX.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(bf16* p, float x) {
  *p = __float2bfloat16(x);
}
template <typename T>
__device__ __forceinline__ T zero_of() {
  return T(0);
}
template <>
__device__ __forceinline__ bf16 zero_of<bf16>() {
  return __float2bfloat16(0.f);
}

// ---------------------------------------------------------------------------
// cp.async staging
// ---------------------------------------------------------------------------

// One asynchronous copy of BYTES into shared memory; valid == false
// zero-fills the destination and reads nothing.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(BYTES), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a (16 x 16, row-major) * b (16 x 8, column-major), fp32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Lane offsets of the ldmatrix addresses. A operand (16 x 16, row-major,
// ldsm_x4): row a_row(), column a_col() of the tile. B operand from a
// k-major tile (rows = depth, columns = n, ldsm_x4_t): row v_row(), column
// v_col(); the four registers are b0, b1 of n-tile 0 and b0, b1 of n-tile 1
// of a 16-wide column pair.
__device__ __forceinline__ int a_row() {
  const int lane = threadIdx.x & 31;
  return (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int a_col() { return ((threadIdx.x & 31) >> 4) * 8; }
__device__ __forceinline__ int v_row() { return a_row(); }
__device__ __forceinline__ int v_col() { return a_col(); }

// ---------------------------------------------------------------------------
// thread-block clusters
// ---------------------------------------------------------------------------

// The shared::cluster address of `p` (a shared-memory pointer of this
// block) in the block of rank `rank` of the cluster.
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ uint4 ld_peer16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Every thread of every block of the cluster arrives (release: its earlier
// shared-memory writes become visible to the cluster) ...
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
// ... and waits for all the others (acquire).
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Opt a kernel in to more than 48 KB of dynamic shared memory when it needs
// it. Returns the CUDA error code.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace sm90
