// 3x3x3 convolution, pad 1, stride 1 or 2, with a per-channel affine and an
// optional ReLU in the epilogue (eval BatchNorm folded), for sm_90a.
//
// Replaces the TPU kernels of semstereo_tpu/ops/pallas/conv3d_wl.py:
// _fwd_s1/_kernel_s1 and _fwd_s2/_kernel_s2 (conv3d_wl, conv3d_wl_affine).
// Contract:  y[b,o,f] = [relu](sum_{tap,c} x[b, o*s - 1 + tap, c] w[tap, c, f]
//                              * scale[f] + bias[f])
// x [B,D,H,W,C] and y [B,OD,OH,OW,F] channels-last, w [3,3,3,C,F]; zero
// padding; fp32 accumulation; y in x's dtype.
//
// What bounds it on the card: operations.  The main path's 13 launches do
// about 390 GFLOP for a few hundred MB of traffic, far above the H100's
// ~295 FLOP/byte ridge, so the products must run on the tensor cores.  Both
// variants are implicit GEMMs with M = output voxels, N = F, K = 27 C; the
// halo and ragged edges read as zero and the BN affine and ReLU run in the
// epilogue.
//  * bf16 (C % 8 == 0, as at every main-path shape): WMMA m16n16k16 on the
//    tensor cores with fp32 accumulation.  Each block stages its output
//    tile's input halo once per 32 channels and reuses it for all 27 taps,
//    so an input element crosses from L2 into shared memory about 4 times
//    instead of 27 (conv3d_halo_kernel).
//  * fp32: the same GEMM on the CUDA cores with
//    fp32 FMA, one tap and 32 channels per step, and a TM x TN register tile
//    per thread.  fp32 has no tensor-core path: TF32 would lose the 1e-4
//    agreement with the plain version.
// Next: double-buffer the halo and weights, then wgmma with TMA-fed tiles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <cstdint>

namespace {

constexpr int BK = 32;  // input channels per step of the CUDA-core kernel

template <int BM, int BN, int TM, int TN, int S>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
conv3d_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ scale, const float* __restrict__ bias, float* __restrict__ y, int D, int H, int W, int C,
              int F, int OD, int OH, int OW, int64_t M, int relu) {
  constexpr int NT = (BM / TM) * (BN / TN);
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  __shared__ int64_t rowb[BM];  // voxel index of (b, 0, 0, 0)
  __shared__ int rowd[BM], rowh[BM], roww[BM];

  const int tid = threadIdx.x;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  for (int i = tid; i < BM; i += NT) {
    const int64_t m = m0 + i;
    if (m < M) {
      const int ow = (int)(m % OW);
      int64_t t = m / OW;
      const int oh = (int)(t % OH);
      t /= OH;
      const int od = (int)(t % OD);
      rowb[i] = (t / OD) * D * H * W;
      rowd[i] = od * S - 1;
      rowh[i] = oh * S - 1;
      roww[i] = ow * S - 1;
    } else {  // rows past M read zeros and are not stored
      rowb[i] = 0;
      rowd[i] = rowh[i] = roww[i] = -4;
    }
  }
  __syncthreads();

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int tn = tid % (BN / TN);
  const int tm = tid / (BN / TN);

  for (int tap = 0; tap < 27; ++tap) {
    const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
    for (int c0 = 0; c0 < C; c0 += BK) {
      for (int e = tid; e < BM * BK; e += NT) {
        const int kk = e % BK, i = e / BK;
        const int c = c0 + kk;
        const int id = rowd[i] + kd, ih = rowh[i] + kh, iw = roww[i] + kw;
        float v = 0.f;
        if (c < C && id >= 0 && id < D && ih >= 0 && ih < H && iw >= 0 && iw < W)
          v = x[(rowb[i] + ((int64_t)id * H + ih) * W + iw) * C + c];
        As[kk][i] = v;
      }
      for (int e = tid; e < BK * BN; e += NT) {
        const int n = e % BN, kk = e / BN;
        const int c = c0 + kk, f = n0 + n;
        Bs[kk][n] = (c < C && f < F) ? w[((int64_t)tap * C + c) * F + f] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[kk][tm + i * (BM / TM)];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tn + j * (BN / TN)];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t m = m0 + tm + i * (BM / TM);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int f = n0 + tn + j * (BN / TN);
      if (f >= F) continue;
      float v = fmaf(acc[i][j], scale[f], bias[f]);
      if (relu) v = fmaxf(v, 0.f);
      y[m * F + f] = v;
    }
  }
}


// ---------------------------------------------------------------------------
// bf16 tensor-core variant (C % 8 == 0).  A block owns an output tile of one
// plane, HTH rows x HTW columns (128 voxels), x BN (16, 32 or 64) channels;
// each of its 8 warps one row and 16 columns.  Per chunk of 32 input
// channels the block stages the tile's input halo (3 planes, with the
// stride-S footprint of the tile plus the 3x3 border) once in shared memory
// by cp.async, zero-filled outside the volume, and reuses it for all 27
// taps: the A fragment of tap (kd, kh, kw) is a strided view of the halo
// (row stride S voxels).  The weights of one kd plane (9 taps x 32 x BN)
// follow, by cp.async where F % 8 == 0 and plain loads otherwise.  WMMA
// m16n16k16 bf16 products accumulate in fp32; the epilogue goes through
// shared memory so that the stores are coalesced.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// output rows and columns of a tile, input channels per chunk, and the
// halo's voxel stride in elements (32 channels + 16 of padding: 96 bytes, so
// every fragment start is 32-byte aligned and rows spread over the banks)
constexpr int HTH = 4, HTW = 32, HKC = 32, HVS = 48;

template <int BN, bool VEC_W, int S>
__global__ void __launch_bounds__(256)
conv3d_halo_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ y, int D, int H, int W, int C, int F, int OD,
                   int OH, int OW, int relu, int tiles_w) {
  using namespace nvcuda;
  constexpr int HHH = (HTH - 1) * S + 3, HHW = (HTW - 1) * S + 3;
  constexpr int HALO_ELEMS = 3 * HHH * HHW * HVS;
  constexpr int LDB = BN + 8;
  constexpr int FN = BN / 16;
  constexpr int LDC = BN + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wts = halo + HALO_ELEMS;  // [9][HKC][LDB]

  const int tid = threadIdx.x, warp = tid / 32;
  const int wr = warp / 2, wh = warp % 2;  // output row and 16-column half of this warp
  const int h0 = (blockIdx.x / tiles_w) * HTH, w0 = (blockIdx.x % tiles_w) * HTW;
  const int od = blockIdx.y % OD, b = blockIdx.y / OD;
  const int n0 = blockIdx.z * BN;
  const int64_t vbase = (int64_t)b * D * H * W;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FN];
#pragma unroll
  for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int c0 = 0; c0 < C; c0 += HKC) {
    __syncthreads();  // the previous chunk's products are done with halo/wts
    for (int q = tid; q < 3 * HHH * HHW * (HKC / 8); q += 256) {
      const int ch = q % (HKC / 8);
      const int v = q / (HKC / 8);
      const int iw = v % HHW, ih = (v / HHW) % HHH, id = v / (HHW * HHH);
      const int gd = od * S + id - 1, gh = h0 * S + ih - 1, gw = w0 * S + iw - 1;
      const int c = c0 + ch * 8;
      const bool ok = c < C && gd >= 0 && gd < D && gh >= 0 && gh < H && gw >= 0 && gw < W;
      const __nv_bfloat16* src = ok ? x + (vbase + ((int64_t)gd * H + gh) * W + gw) * C + c : x;
      cp_async16(halo + v * HVS + ch * 8, src, ok);
    }
    cp_async_commit();
    for (int kd = 0; kd < 3; ++kd) {
      if (kd > 0) __syncthreads();  // products of the previous kd plane are done with wts
      if (VEC_W) {
        for (int q = tid; q < 9 * HKC * (BN / 8); q += 256) {
          const int n8 = q % (BN / 8), kk = (q / (BN / 8)) % HKC, t = q / (HKC * (BN / 8));
          const int c = c0 + kk, f = n0 + n8 * 8;
          const bool ok = c < C && f < F;
          const __nv_bfloat16* src = ok ? w + ((int64_t)(kd * 9 + t) * C + c) * F + f : w;
          cp_async16(wts + (t * HKC + kk) * LDB + n8 * 8, src, ok);
        }
        cp_async_commit();
      } else {
        for (int q = tid; q < 9 * HKC * BN; q += 256) {
          const int n = q % BN, kk = (q / BN) % HKC, t = q / (HKC * BN);
          const int c = c0 + kk, f = n0 + n;
          wts[(t * HKC + kk) * LDB + n] =
              (c < C && f < F) ? w[((int64_t)(kd * 9 + t) * C + c) * F + f] : __float2bfloat16(0.f);
        }
      }
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll 1
      for (int t = 0; t < 9; ++t) {
        const int kh = t / 3, kw = t % 3;
        const __nv_bfloat16* arow =
            halo + ((kd * HHH + wr * S + kh) * HHW + wh * 16 * S + kw) * HVS;
#pragma unroll
        for (int kk = 0; kk < HKC; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, arow + kk, S * HVS);
#pragma unroll
          for (int j = 0; j < FN; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, wts + (t * HKC + kk) * LDB + j * 16, LDB);
            wmma::mma_sync(acc[j], fa, fb, acc[j]);
          }
        }
      }
    }
  }
  __syncthreads();
  float* cs = reinterpret_cast<float*>(smem);  // [HTH * HTW][LDC]
#pragma unroll
  for (int j = 0; j < FN; ++j)
    wmma::store_matrix_sync(cs + (wr * HTW + wh * 16) * LDC + j * 16, acc[j], LDC,
                            wmma::mem_row_major);
  __syncthreads();
  for (int q = tid; q < HTH * HTW * BN; q += 256) {
    const int n = q % BN, r = q / BN;
    const int oh = h0 + r / HTW, ow = w0 + r % HTW, f = n0 + n;
    if (oh >= OH || ow >= OW || f >= F) continue;
    float v = fmaf(cs[r * LDC + n], scale[f], bias[f]);
    if (relu) v = fmaxf(v, 0.f);
    y[(((int64_t)b * OD + od) * OH + oh) * OW * F + (int64_t)ow * F + f] = __float2bfloat16(v);
  }
}

template <int BN, bool VEC_W, int S>
int launch_halo_cfg(const void* x, const void* w, const float* sc, const float* bi, void* y,
                    int B, int D, int H, int W, int C, int F, int relu, cudaStream_t st) {
  constexpr int HALO_ELEMS = 3 * ((HTH - 1) * S + 3) * ((HTW - 1) * S + 3) * HVS;
  constexpr int pipe = (HALO_ELEMS + 9 * HKC * (BN + 8)) * 2;
  constexpr int cbytes = HTH * HTW * (BN + 4) * 4;
  constexpr int smem = pipe > cbytes ? pipe : cbytes;
  auto kern = conv3d_halo_kernel<BN, VEC_W, S>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int OD = (D - 1) / S + 1, OH = (H - 1) / S + 1, OW = (W - 1) / S + 1;
  const int tiles_w = (OW + HTW - 1) / HTW, tiles_h = (OH + HTH - 1) / HTH;
  if ((int64_t)B * OD > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(tiles_w * tiles_h, B * OD, (F + BN - 1) / BN);
  kern<<<grid, 256, smem, st>>>(static_cast<const __nv_bfloat16*>(x),
                                static_cast<const __nv_bfloat16*>(w), sc, bi,
                                static_cast<__nv_bfloat16*>(y), D, H, W, C, F, OD, OH, OW, relu,
                                tiles_w);
  return (int)cudaGetLastError();
}

// Tile width follows F, so that the Cout=1 classifier conv wastes 15 of 16
// columns rather than 63 of 64.
template <int S>
int launch_halo(const void* x, const void* w, const float* sc, const float* bi, void* y, int B,
                int D, int H, int W, int C, int F, int relu, cudaStream_t st) {
  const bool vec = F % 8 == 0;
  if (F <= 16)
    return vec ? launch_halo_cfg<16, true, S>(x, w, sc, bi, y, B, D, H, W, C, F, relu, st)
               : launch_halo_cfg<16, false, S>(x, w, sc, bi, y, B, D, H, W, C, F, relu, st);
  if (F <= 32)
    return vec ? launch_halo_cfg<32, true, S>(x, w, sc, bi, y, B, D, H, W, C, F, relu, st)
               : launch_halo_cfg<32, false, S>(x, w, sc, bi, y, B, D, H, W, C, F, relu, st);
  return vec ? launch_halo_cfg<64, true, S>(x, w, sc, bi, y, B, D, H, W, C, F, relu, st)
             : launch_halo_cfg<64, false, S>(x, w, sc, bi, y, B, D, H, W, C, F, relu, st);
}

template <int BM, int BN, int TM, int TN>
int launch_tile(const void* x, const void* w, const float* sc, const float* bi, void* y,
                int B, int D, int H, int W, int C, int F, int S, int relu, cudaStream_t st) {
  const int OD = (D - 1) / S + 1, OH = (H - 1) / S + 1, OW = (W - 1) / S + 1;
  const int64_t M = (int64_t)B * OD * OH * OW;
  const int64_t gx = (M + BM - 1) / BM;
  if (gx > 2147483647LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)gx, (F + BN - 1) / BN);
  constexpr int NT = (BM / TM) * (BN / TN);
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  float* yp = static_cast<float*>(y);
  if (S == 1)
    conv3d_kernel<BM, BN, TM, TN, 1><<<grid, NT, 0, st>>>(xp, wp, sc, bi, yp, D, H, W, C, F, OD,
                                                           OH, OW, M, relu);
  else
    conv3d_kernel<BM, BN, TM, TN, 2><<<grid, NT, 0, st>>>(xp, wp, sc, bi, yp, D, H, W, C, F, OD,
                                                           OH, OW, M, relu);
  return (int)cudaGetLastError();
}

// fp32: the register tile follows F (BN = 64, 32 or 1).
int launch_fp32(const void* x, const void* w, const float* sc, const float* bi, void* y, int B,
                int D, int H, int W, int C, int F, int S, int relu, cudaStream_t st) {
  if (F == 1) return launch_tile<256, 1, 1, 1>(x, w, sc, bi, y, B, D, H, W, C, F, S, relu, st);
  if (F <= 32) return launch_tile<128, 32, 4, 4>(x, w, sc, bi, y, B, D, H, W, C, F, S, relu, st);
  return launch_tile<64, 64, 4, 4>(x, w, sc, bi, y, B, D, H, W, C, F, S, relu, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and y; bf16 needs C % 8 == 0);
// scale/bias are float32 [F].  Returns a cudaError_t (0 = launched).
extern "C" int conv3d_bn_act(const void* x, const void* w, const void* scale, const void* bias,
                             void* y, int B, int D, int H, int W, int C, int F, int stride,
                             int relu, int dtype, void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0 || (stride != 1 && stride != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == 0) return launch_fp32(x, w, sc, bi, y, B, D, H, W, C, F, stride, relu, st);
  if (dtype == 1 && C % 8 == 0) {
    if (stride == 1) return launch_halo<1>(x, w, sc, bi, y, B, D, H, W, C, F, relu, st);
    return launch_halo<2>(x, w, sc, bi, y, B, D, H, W, C, F, relu, st);
  }
  return (int)cudaErrorInvalidValue;
}
