// Cosine group-wise correlation cost volume (forward), for sm_90a.
//
// Replaces the TPU kernel semstereo_tpu/ops/pallas/cost_volume_kernel.py
// (_forward / _fwd_kernel, gwc_volume_norm_pallas).  Contract, with
// l^ = l / (|l|_g + 1e-5) per channel group of cpg = C/G channels:
//   out[b,d,h,x,g] = mean_{c in g} l^[b,h,x,c] * r^[b,h,x-s_d,c]
// and 0 where x - s_d lies outside [0, W); s_d = shift_lo + d.
//
// What bounds it on the card: memory.  At the main-path shape (C=256, G=32,
// D=16 on 128x128) it reads 2 x 8.4 MB of bf16 features and writes 8.4 MB
// of volume for about 0.13 GFLOP.  The design reads each feature map once
// for all D planes: one block per (b, h, 32-column tile) stages the left
// tile and the right tile with its D-1 column halo in shared memory, in the
// input dtype, by 16-byte cp.async (all of a block's loads in flight at
// once; columns outside the image arrive as zeros), computes the per-group
// inverse norms once, and then emits every plane from shared memory with
// fp32 arithmetic.  Consecutive threads own consecutive groups of one
// voxel: their 16-byte shared-memory reads are conflict-free and the volume
// store is coalesced.  Takes C a multiple of 16 bytes'
// worth of elements (8 bf16, 4 fp32).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int TW = 32;        // output columns per block
constexpr int THREADS = 256;
constexpr float EPS = 1e-5f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

// Dot product of two 16-byte chunks, in fp32.
__device__ __forceinline__ float dot16(const float* a, const float* b) {
  const float4 u = *reinterpret_cast<const float4*>(a), v = *reinterpret_cast<const float4*>(b);
  return u.x * v.x + u.y * v.y + u.z * v.z + u.w * v.w;
}
__device__ __forceinline__ float dot16(const __nv_bfloat16* a, const __nv_bfloat16* b) {
  const uint4 u = *reinterpret_cast<const uint4*>(a), v = *reinterpret_cast<const uint4*>(b);
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(&v);
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 x = __bfloat1622float2(p[k]), y = __bfloat1622float2(q[k]);
    acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
  }
  return acc;
}

// Group dot product over cpg channels: 16-byte shared-memory reads when the
// group is whole chunks (a warp then reads consecutive chunks, no bank
// conflicts), else one element at a time.
template <typename T>
__device__ __forceinline__ float group_dot(const T* a, const T* b, int cpg, bool chunked) {
  constexpr int EPC = 16 / sizeof(T);
  float acc = 0.f;
  if (chunked) {
    for (int c = 0; c < cpg; c += EPC) acc += dot16(a + c, b + c);
  } else {
    for (int c = 0; c < cpg; ++c) acc = fmaf(to_f(a[c]), to_f(b[c]), acc);
  }
  return acc;
}

// grid (ceil(W/TW), H, B).  Shared memory: ls [TW][C+EPC] and rs [span][C+EPC]
// in T (one 16-byte pad per column), then il [TW][G] and ir [span][G] fp32,
// with span = TW + D - 1 right columns starting at x0 - (shift_lo + D - 1).
template <typename T>
__global__ void __launch_bounds__(THREADS)
gwc_volume_kernel(const T* __restrict__ left, const T* __restrict__ right,
                  T* __restrict__ out, int H, int W, int C, int G, int shift_lo, int D) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int cpg = C / G;
  const int ld = C + EPC;
  const int span = TW + D - 1;
  T* ls = reinterpret_cast<T*>(smem);
  T* rs = ls + TW * ld;
  float* il = reinterpret_cast<float*>(rs + span * ld);
  float* ir = il + TW * G;

  const int x0 = blockIdx.x * TW;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t row = ((int64_t)b * H + h) * W;  // voxel index of (b, h, 0)
  const int rbase = x0 - (shift_lo + D - 1);
  const int cpr = C / EPC;  // chunks per column

  for (int q = threadIdx.x; q < (TW + span) * cpr; q += THREADS) {
    const int col = q / cpr, c = (q - col * cpr) * EPC;
    const bool is_l = col < TW;
    const int x = is_l ? x0 + col : rbase + col - TW;
    const bool ok = x >= 0 && x < W;
    const T* src = (is_l ? left : right) + (ok ? (row + x) * C + c : 0);
    cp_async16((is_l ? ls + col * ld : rs + (col - TW) * ld) + c, src, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const bool chunked = cpg % EPC == 0;
  for (int i = threadIdx.x; i < (TW + span) * G; i += THREADS) {
    const int col = i / G, g = i - col * G;
    const T* p = (col < TW ? ls + col * ld : rs + (col - TW) * ld) + g * cpg;
    const float inv = 1.f / (sqrtf(group_dot(p, p, cpg, chunked)) + EPS);
    if (col < TW) il[i] = inv; else ir[i - TW * G] = inv;
  }
  __syncthreads();

  const float inv_cpg = 1.f / (float)cpg;
  for (int d = 0; d < D; ++d) {
    const int s = shift_lo + d;
    T* dst = out + (((int64_t)b * D + d) * H + h) * W * G;
    for (int i = threadIdx.x; i < TW * G; i += THREADS) {
      const int xl = i / G, g = i - xl * G;
      const int x = x0 + xl;
      if (x >= W) continue;
      const int xr = x - s;
      float v = 0.f;
      if (xr >= 0 && xr < W) {
        const int rl = xl + (D - 1) - d;  // local right column of x - s
        const float dot = group_dot(ls + xl * ld + g * cpg, rs + rl * ld + g * cpg, cpg, chunked);
        v = dot * il[xl * G + g] * ir[rl * G + g] * inv_cpg;
      }
      dst[(int64_t)x * G + g] = from_f<T>(v);
    }
  }
}

template <typename T>
int launch(const void* l, const void* r, void* o, int B, int H, int W, int C, int G,
           int shift_lo, int D, cudaStream_t stream) {
  constexpr int EPC = 16 / sizeof(T);
  if (C % EPC != 0) return (int)cudaErrorInvalidValue;
  const int span = TW + D - 1;
  const size_t smem = sizeof(T) * (size_t)(TW + span) * (C + EPC) + sizeof(float) * (size_t)(TW + span) * G;
  cudaError_t e = cudaFuncSetAttribute(gwc_volume_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + TW - 1) / TW, H, B);
  gwc_volume_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(l), static_cast<const T*>(r), static_cast<T*>(o), H, W, C, G, shift_lo, D);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int gwc_volume(const void* left, const void* right, void* out, int B, int H, int W,
                          int C, int G, int shift_lo, int D, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || G <= 0 || C % G != 0 || D <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(left, right, out, B, H, W, C, G, shift_lo, D, st);
  if (dtype == 1) return launch<__nv_bfloat16>(left, right, out, B, H, W, C, G, shift_lo, D, st);
  return (int)cudaErrorInvalidValue;
}
