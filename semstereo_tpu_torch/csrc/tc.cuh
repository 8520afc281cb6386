// Shared helpers of the bf16 tensor-core kernels (sm_90a): cp.async copies,
// ldmatrix loads, mma.sync m16n8k16 and the XOR swizzle of the shared-memory
// tiles.  Included by conv3d.cu and conv3d_wgrad.cu.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace tc {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills the 16 bytes when !valid.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Four 8x8 b16 matrices; lanes 8j..8j+7 give the row addresses of matrix j.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += a * b: A 16x16 row-major, B 16x8 column-major, fp32 accumulators.
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A tile of rows of `chunks` 16-byte chunks (a power of two) stores chunk k
// of row r at chunk k ^ sw(r).  ldmatrix reads 8 rows at a time; with
// sw(r) = (r >> shift) & (min(chunks, 8) - 1) and shift = log2(8 / min(chunks,
// 8)) + log2(step), 8 rows `step` apart (1 or 2) land on distinct bank groups
// (for rows of 64 bytes at step 2: two per group).
struct Swizzle {
  int shift, mask;
  __host__ __device__ Swizzle(int chunks, int step) {
    const int c = chunks < 8 ? chunks : 8;
    int s = 0;
    while ((c << s) < 8) ++s;
    shift = s + (step == 2 ? 1 : 0);
    mask = c - 1;
  }
  __device__ __forceinline__ int operator()(int r) const { return (r >> shift) & mask; }
};

}  // namespace tc
