// Cosine group-wise correlation cost volume (backward), for sm_90a.
//
// Replaces the TPU kernel semstereo_tpu/ops/pallas/cost_volume_kernel.py
// (_bwd / _bwd_kernel, the VJP of gwc_volume_norm_pallas).  With
// u = l / (|l|_g + 1e-5) and v = r / (|r|_g + 1e-5) per channel group of
// cpg = C/G channels, the forward is out[d,x,g] = mean_{c in g} u[x,c] v[x-s_d,c]
// (0 where x - s_d leaves [0, W)).  Given its cotangent gb [B,D,H,W,G]:
//   yl[x,c]  = sum_d gb[d,x,g]/cpg * v[x-s_d,c]
//   yr[x',c] = sum_d gb[d,x'+s_d,g]/cpg * u[x'+s_d,c]
// over the valid (d, x) only, and then the VJP of x -> x/(|x|_g + eps):
//   gl = yl/(n+eps) - l (l.yl)_g / (max(n, 1e-30) (n+eps)^2)   (gr likewise).
//
// What bounds it on the card: memory.  At the main-path shape (B=2, C=256,
// G=32, D=16 on 128x128) it reads l, r (2 x 16.8 MB bf16) and gb (33.6 MB)
// and writes gl, gr (2 x 16.8 MB) for about 1 GFLOP.  The design reads each
// input once per block and never writes an intermediate: one block per
// (b, h, TW-column tile) stages, in the input dtype, l and gb over the
// columns the tile's yr reads (x0 + s_lo .. x0 + TW - 1 + s_hi) and r over
// those its yl reads (x0 - s_hi .. x0 + TW - 1 - s_lo), both windows holding
// the tile itself.  gb is masked to 0 as it is staged, so the sums need no
// tests; yr is written in gather form (one thread per output element sums
// over d), so no atomics are needed.  The group norms are computed once per
// staged column; yl and yr are kept in fp32 in shared memory for the
// per-group dot product of the norm VJP, which then runs per (x, g) and
// stores per (x, c), consecutive threads on consecutive channels.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int TW = 16;  // output columns per block
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

// Shared memory, with S = TW + D - 1 staged columns:
//   ls [S][C], rs [S][C], gs [D][S][G] in T;
//   nl, nr [S][G] (group norms), il, ir [S][G] (1 / (norm + eps)),
//   yl, yr [TW][C], kl, kr [TW][G] in fp32.
template <typename T>
size_t smem_bytes(int C, int G, int D) {
  const size_t S = TW + D - 1;
  return sizeof(T) * (2 * S * C + (size_t)D * S * G) +
         sizeof(float) * (4 * S * G + 2 * (size_t)TW * C + 2 * (size_t)TW * G);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gwc_volume_bwd_kernel(const T* __restrict__ left, const T* __restrict__ right,
                      const T* __restrict__ gbar, T* __restrict__ gleft, T* __restrict__ gright,
                      int H, int W, int C, int G, int shift_lo, int D) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = TW + D - 1;
  const int cpg = C / G;
  T* ls = reinterpret_cast<T*>(smem);
  T* rs = ls + S * C;
  T* gs = rs + S * C;
  float* nl = reinterpret_cast<float*>(gs + D * S * G);
  float* nr = nl + S * G;
  float* il = nr + S * G;
  float* ir = il + S * G;
  float* yl = ir + S * G;
  float* yr = yl + TW * C;
  float* kl = yr + TW * C;
  float* kr = kl + TW * G;

  const int x0 = blockIdx.x * TW, h = blockIdx.y, b = blockIdx.z;
  const int64_t row = ((int64_t)b * H + h) * W;  // voxel index of (b, h, 0)
  const int xu0 = x0 + shift_lo;                // first column of ls and gs
  const int xv0 = x0 - (shift_lo + D - 1);      // first column of rs

  const int cpr = C / EPC;  // chunks per column
  for (int q = threadIdx.x; q < 2 * S * cpr; q += THREADS) {
    const int col = q / cpr, c = (q - col * cpr) * EPC;
    const bool is_l = col < S;
    const int j = is_l ? col : col - S;
    const int x = (is_l ? xu0 : xv0) + j;
    const bool ok = x >= 0 && x < W;
    const T* src = (is_l ? left : right) + (ok ? (row + x) * C + c : 0);
    cp_async16((is_l ? ls : rs) + j * C + c, src, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  // gb, masked: plane d at column x is used only where x and x - s_d are in
  // the image.
  for (int q = threadIdx.x; q < D * S * G; q += THREADS) {
    const int g = q % G, j = (q / G) % S, d = q / (G * S);
    const int x = xu0 + j, xr = x - (shift_lo + d);
    const bool ok = x >= 0 && x < W && xr >= 0 && xr < W;
    gs[q] = ok ? gbar[((((int64_t)b * D + d) * H + h) * W + x) * G + g] : from_f<T>(0.f);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  for (int q = threadIdx.x; q < 2 * S * G; q += THREADS) {
    const int col = q / G, g = q - col * G;
    const T* p = (col < S ? ls + col * C : rs + (col - S) * C) + g * cpg;
    float ss = 0.f;
    for (int c = 0; c < cpg; ++c) {
      const float v = to_f(p[c]);
      ss = fmaf(v, v, ss);
    }
    const int k = col < S ? q : q - S * G;
    (col < S ? nl : nr)[k] = sqrtf(ss);
    (col < S ? il : ir)[k] = 1.f / (sqrtf(ss) + EPS);
  }
  __syncthreads();

  // yl and yr of the tile.  Tile column i is ls/gs column i - shift_lo and
  // rs column i + shift_lo + D - 1; plane d pairs it with rs column
  // i + D - 1 - d (for yl) and ls/gs column i + d (for yr).
  const float inv_cpg = 1.f / (float)cpg;
  for (int q = threadIdx.x; q < TW * C; q += THREADS) {
    const int i = q / C, c = q - i * C, g = c / cpg;
    const int jt = i - shift_lo;
    float al = 0.f, ar = 0.f;
    for (int d = 0; d < D; ++d) {
      const int jv = i + D - 1 - d, ju = i + d;
      al = fmaf(to_f(gs[(d * S + jt) * G + g]) * to_f(rs[jv * C + c]), ir[jv * G + g], al);
      ar = fmaf(to_f(gs[(d * S + ju) * G + g]) * to_f(ls[ju * C + c]), il[ju * G + g], ar);
    }
    yl[q] = al * inv_cpg;
    yr[q] = ar * inv_cpg;
  }
  __syncthreads();

  // Norm VJP coefficient per (tile column, group): (x.y) / (max(n,1e-30) (n+eps)^2).
  for (int q = threadIdx.x; q < 2 * TW * G; q += THREADS) {
    const bool is_l = q < TW * G;
    const int k = is_l ? q : q - TW * G;
    const int i = k / G, g = k - i * G;
    const int j = is_l ? i - shift_lo : i + shift_lo + D - 1;
    const T* xs = (is_l ? ls : rs) + j * C + g * cpg;
    const float* ys = (is_l ? yl : yr) + i * C + g * cpg;
    float dot = 0.f;
    for (int c = 0; c < cpg; ++c) dot = fmaf(to_f(xs[c]), ys[c], dot);
    const float n = (is_l ? nl : nr)[j * G + g], inv = (is_l ? il : ir)[j * G + g];
    (is_l ? kl : kr)[k] = dot * inv * inv / fmaxf(n, 1e-30f);
  }
  __syncthreads();

  for (int q = threadIdx.x; q < 2 * TW * C; q += THREADS) {
    const bool is_l = q < TW * C;
    const int k = is_l ? q : q - TW * C;
    const int i = k / C, c = k - i * C, g = c / cpg;
    const int x = x0 + i;
    if (x >= W) continue;
    const int j = is_l ? i - shift_lo : i + shift_lo + D - 1;
    const float inv = (is_l ? il : ir)[j * G + g];
    const float xv = to_f((is_l ? ls : rs)[j * C + c]);
    const float v = (is_l ? yl : yr)[k] * inv - xv * (is_l ? kl : kr)[i * G + g];
    (is_l ? gleft : gright)[(row + x) * C + c] = from_f<T>(v);
  }
}

template <typename T>
int launch(const void* l, const void* r, const void* gb, void* gl, void* gr, int B, int H, int W,
           int C, int G, int shift_lo, int D, cudaStream_t stream) {
  constexpr int EPC = 16 / sizeof(T);
  if (C % EPC != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(C, G, D);
  cudaError_t e = cudaFuncSetAttribute(gwc_volume_bwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + TW - 1) / TW, H, B);
  gwc_volume_bwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(l), static_cast<const T*>(r), static_cast<const T*>(gb),
      static_cast<T*>(gl), static_cast<T*>(gr), H, W, C, G, shift_lo, D);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of shared memory a launch needs (the wrapper checks it against the
// card's limit); dtype as below.
extern "C" long long gwc_volume_bwd_smem(int C, int G, int D, int dtype) {
  return dtype == 0 ? (long long)smem_bytes<float>(C, G, D)
                    : (long long)smem_bytes<__nv_bfloat16>(C, G, D);
}

// dtype: 0 = float32, 1 = bfloat16 (left, right, gbar, gleft, gright alike).
// Returns a cudaError_t (0 = launched).
extern "C" int gwc_volume_bwd(const void* left, const void* right, const void* gbar, void* gleft,
                              void* gright, int B, int H, int W, int C, int G, int shift_lo, int D,
                              int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || G <= 0 || C % G != 0 || D <= 0 || H > 65535 || B > 65535 ||
      shift_lo > 0 || shift_lo + D - 1 < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(left, right, gbar, gleft, gright, B, H, W, C, G, shift_lo, D, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(left, right, gbar, gleft, gright, B, H, W, C, G, shift_lo, D, st);
  return (int)cudaErrorInvalidValue;
}
