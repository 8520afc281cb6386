// Cosine group-wise correlation cost volume (forward), for sm_90a.
//
// Replaces the TPU kernel semstereo_tpu/ops/pallas/cost_volume_kernel.py
// (_forward / _fwd_kernel, gwc_volume_norm_pallas).  Contract, with
// l^ = l / (|l|_g + 1e-5) per channel group of cpg = C/G channels:
//   out[b,d,h,x,g] = mean_{c in g} l^[b,h,x,c] * r^[b,h,x-s_d,c]
// and 0 where x - s_d lies outside [0, W); s_d = shift_lo + d.
//
// What bounds it on the card: memory.  At the main-path shape (C = 256,
// G = 32, D = 16 on 128x128, bf16) it reads 2 x 8.4 MB of features and
// writes 16.8 MB of volume, 10.0 us at 3.35 TB/s, for about 0.13 GFLOP.
// Each output is one 8-channel dot product with no reuse a matrix product
// could take, so it runs on CUDA cores in fp32 and is a bytes-and-latency
// kernel.
//
// The design streams.  A block takes a segment of SEG = 64 columns of one
// image row (b, h) and walks it in tiles of TW = 16 columns; segments, not
// whole rows, so that B = 1 gives two blocks per SM (256 at the eval
// shape).  The tile at x0 reads r over x0 - s_hi .. x0 + TW - 1 - s_lo, so
// neighbouring tiles share D - 1 columns: r enters a ring in shared memory
// in chunks of TW columns, each chunk once, by 16-byte cp.async, and only a
// segment's first tile restages the D - 1 halo (r is read 1.23 times at
// D = 16).  The next tile's chunk and l are issued right after the barrier
// that starts a tile, so they fly while it computes and the first tile
// waits only for its own window.  The inverse group norms of a chunk are
// computed once, as it lands, by the threads that copied it.
//
// One thread owns KC = 2 adjacent columns of one group, cpg = 8 channels
// fixed at compile time with G (C = 8 G, as the model's groups = C / 8), so
// the thread map has no runtime division.  It keeps l^ / cpg of its columns
// in fp32 registers (loaded straight from device memory, since no other
// thread reads them).  Plane d pairs its column x with r's x - s_d, so from
// one plane to the next the r columns it needs slide by one: it keeps them
// in registers and reads one new 16-byte group from the ring per plane for
// KC outputs (8 FMAs and one scale each).  For a fixed plane a tile's TW x G
// outputs are one contiguous run of [B,D,H,W,G]: they are rounded once to
// the input dtype into a staging buffer in shared memory and leave as
// 16-byte stores.
//
// Columns outside the image arrive as zeros (the copy zero-fills), so their
// dot products, and the planes' out-of-range outputs, are exactly 0.
//
// On the H100 (80GB HBM3, 700 W) at the eval shape this takes 0.0238 ms,
// 42 % of the 0.0100 ms bound, with two 256-thread blocks per SM; the
// kernel it replaced, which staged every operand of a 32-column tile at
// once and stored 2-byte scalars, took 0.0602 in the same A/B (PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "tc.cuh"

namespace {

constexpr int TW = 16;        // output columns per tile; columns per ring chunk
constexpr int KC = 2;         // adjacent columns per thread
constexpr int SEG = 4 * TW;   // columns per block
constexpr int CPG = 8;        // channels per group
constexpr int PMAX = 16;      // planes the output staging buffer holds
constexpr float EPS = 1e-5f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float& o) { o = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16& o) { o = __float2bfloat16(v); }

// One group's CPG values as floats, from 16-byte words.
template <typename T>
__device__ __forceinline__ void unpack(const uint4* raw, float (&f)[CPG]) {
  const T* e = reinterpret_cast<const T*>(raw);
  for (int c = 0; c < CPG; ++c) f[c] = to_f(e[c]);
}
template <typename T>
__device__ __forceinline__ void load_group(const T* p, float (&f)[CPG]) {
  constexpr int N = CPG * sizeof(T) / 16;
  uint4 raw[N];
  for (int m = 0; m < N; ++m) raw[m] = reinterpret_cast<const uint4*>(p)[m];
  unpack<T>(raw, f);
}

__device__ __forceinline__ float inv_norm(const float (&x)[CPG]) {
  float ss = 0.f;
  for (int c = 0; c < CPG; ++c) ss = fmaf(x[c], x[c], ss);
  return 1.f / (sqrtf(ss) + EPS);
}

// The ring: the chunks one tile's window spans, plus the next tile's chunk
// loading, TW columns each.  Shared memory: rs [cols][C] in T, ir [cols][G]
// = 1 / (group norm + eps) in fp32, os [planes][TW G] in T.
__host__ __device__ __forceinline__ int window_chunks(int D) { return 1 + (D + TW - 2) / TW; }
__host__ __device__ __forceinline__ int ring_chunks(int D) { return window_chunks(D) + 1; }
__host__ __device__ __forceinline__ int batch_planes(int D) { return D < PMAX ? D : PMAX; }

template <typename T>
size_t smem_bytes(int G, int D) {
  const size_t cols = (size_t)ring_chunks(D) * TW;
  return cols * (sizeof(T) * CPG * G + sizeof(float) * G) +
         sizeof(T) * (size_t)batch_planes(D) * TW * G;
}

// grid (ceil(W / SEG), H, B), TW / KC * G threads.
template <typename T, int G>
__global__ void __launch_bounds__(TW / KC * G, 2)
gwc_volume_kernel(const T* __restrict__ left, const T* __restrict__ right, T* __restrict__ out,
                  int H, int W, int lo, int D) {
  constexpr int C = CPG * G, NT = TW / KC * G, OT = TW * G;  // threads; outputs per plane
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int GRP = CPG / EPC;       // copies per group
  constexpr int RUN = OT / EPC;        // copies per plane of a tile's output
  extern __shared__ __align__(16) unsigned char smem[];
  const int hi = lo + D - 1;
  const int nwin = window_chunks(D), nring = ring_chunks(D), cols = nring * TW;
  const int np = batch_planes(D);
  T* rs = reinterpret_cast<T*>(smem);
  float* ir = reinterpret_cast<float*>(rs + cols * C);
  T* os = reinterpret_cast<T*>(ir + cols * G);

  // this thread's group, and its run of KC columns from KC m; it copies
  // group g of the chunk columns m + a TW / KC
  const int m = threadIdx.x / G, g = threadIdx.x % G;
  const int h = blockIdx.y, b = blockIdx.z;
  const int xs = blockIdx.x * SEG;
  const int64_t row = ((int64_t)b * H + h) * W;  // voxel index of (b, h, 0)
  const int ntiles = ((W - xs < SEG ? W - xs : SEG) + TW - 1) / TW;
  const int nchunks = ntiles + nwin - 1;  // chunks of r the segment needs

  // Chunk c holds r at columns xs - s_hi + c TW + k (k < TW), in ring slot
  // c mod nring.
  auto load = [&](int c) {
    if (c >= nchunks) return;
    const int k0 = (c % nring) * TW;
    for (int a = 0; a < KC; ++a) {
      const int k = m + a * (TW / KC), x = xs - hi + c * TW + k;
      const bool ok = x >= 0 && x < W;
      for (int q = 0; q < GRP; ++q) {
        const int e = g * CPG + q * EPC;
        tc::cp_async16(tc::smem_addr(rs + (k0 + k) * C + e), right + (ok ? (row + x) * C + e : 0),
                       ok);
      }
    }
    tc::cp_async_commit();
  };
  // 1 / (norm + eps) of the groups of chunk c this thread copied.
  auto norm = [&](int c) {
    for (int a = 0; a < KC; ++a) {
      const int k = (c % nring) * TW + m + a * (TW / KC);
      float v[CPG];
      load_group(rs + k * C + g * CPG, v);
      ir[k * G + g] = inv_norm(v);
    }
  };
  // This thread's l groups in tile t (zeros past the image).
  auto load_l = [&](int t, uint4 (&raw)[KC][GRP]) {
    for (int a = 0; a < KC; ++a) {
      const int x = xs + t * TW + KC * m + a;
      for (int q = 0; q < GRP; ++q)
        raw[a][q] = x < W ? reinterpret_cast<const uint4*>(left + (row + x) * C + g * CPG)[q]
                          : uint4{0, 0, 0, 0};
    }
  };

  uint4 lraw[KC][GRP];
  load_l(0, lraw);
  for (int c = 0; c < nwin; ++c) load(c);
  for (int t = 0; t < ntiles; ++t) {
    tc::cp_async_wait<0>();  // the chunks of tile t's window have landed
    if (t == 0) {
      for (int c = 0; c < nwin; ++c) norm(c);
    } else {
      norm(t + nwin - 1);
    }
    // l^ / cpg of this thread's columns
    float u[KC][CPG];
    for (int a = 0; a < KC; ++a) {
      unpack<T>(lraw[a], u[a]);
      const float s = inv_norm(u[a]) * (1.f / CPG);
      for (int c = 0; c < CPG; ++c) u[a][c] *= s;
    }
    __syncthreads();
    // The next tile's loads fly while this one computes: chunk t + nwin goes
    // where chunk t - 1 was, which no thread reads since the barrier above.
    load(t + nwin);
    if (t + 1 < ntiles) load_l(t + 1, lraw);

    // Window column j (r at x0 - s_hi + j) is ring column base + j, wrapped;
    // plane d pairs column KC m + a with window column KC m + a + D - 1 - d,
    // so from one plane to the next the thread's window slides down by one
    // column: v[a], w[a] hold r's group and its inverse norm there.
    const int x0 = xs + t * TW, base = (t % nring) * TW;
    auto fetch = [&](int j, float (&v)[CPG], float& w) {
      const int k = base + j < cols ? base + j : base + j - cols;
      load_group(rs + k * C + g * CPG, v);
      w = ir[k * G + g];
    };
    for (int d0 = 0; d0 < D; d0 += np) {
      const int n = D - d0 < np ? D - d0 : np;
      float v[KC][CPG], w[KC];
      for (int a = 0; a + 1 < KC; ++a) fetch(KC * m + a + D - d0, v[a], w[a]);
      for (int p = 0; p < n; ++p) {
        for (int a = KC - 1; a > 0; --a) {
          for (int c = 0; c < CPG; ++c) v[a][c] = v[a - 1][c];
          w[a] = w[a - 1];
        }
        fetch(KC * m + D - 1 - d0 - p, v[0], w[0]);
        for (int a = 0; a < KC; ++a) {
          float dot = 0.f;
          for (int c = 0; c < CPG; ++c) dot = fmaf(u[a][c], v[a][c], dot);
          from_f(dot * w[a], os[p * OT + (KC * m + a) * G + g]);
        }
      }
      __syncthreads();
      // planes d0 .. d0 + n - 1 of the tile, the columns inside the image
      for (int q = threadIdx.x; q < n * RUN; q += NT) {
        const int p = q / RUN, e = q % RUN * EPC;  // plane; element of its TW x G run
        if (x0 + e / G < W) {
          T* dst = out + ((((int64_t)b * D + d0 + p) * H + h) * W + x0) * G + e;
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(os + p * OT + e);
        }
      }
      __syncthreads();
    }
  }
}

template <typename T, int G>
int launch(const void* l, const void* r, void* o, int B, int H, int W, int lo, int D,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(G, D);
  cudaError_t e = cudaFuncSetAttribute(gwc_volume_kernel<T, G>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + SEG - 1) / SEG, H, B);
  gwc_volume_kernel<T, G><<<grid, TW / KC * G, smem, stream>>>(
      static_cast<const T*>(l), static_cast<const T*>(r), static_cast<T*>(o), H, W, lo, D);
  return (int)cudaGetLastError();
}

template <typename T, int G>
int blocks_per_sm(int D) {
  const size_t smem = smem_bytes<T>(G, D);
  cudaError_t e = cudaFuncSetAttribute(gwc_volume_kernel<T, G>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gwc_volume_kernel<T, G>, TW / KC * G,
                                                      smem);
  return e == cudaSuccess ? n : -(int)e;
}

// The instantiations: G = 32 (the model's C = 256) and G = 8 (small shapes).
bool supported(int C, int G) { return C == CPG * G && (G == 32 || G == 8); }

}  // namespace

// Bytes of shared memory a launch needs; dtype as below.
extern "C" long long gwc_volume_smem(int C, int G, int D, int dtype) {
  (void)C;
  return dtype == 0 ? (long long)smem_bytes<float>(G, D)
                    : (long long)smem_bytes<__nv_bfloat16>(G, D);
}

// Blocks of a launch that fit on one SM at once (cudaOccupancy...), or
// minus a cudaError_t.
extern "C" int gwc_volume_blocks_per_sm(int C, int G, int D, int dtype) {
  if (!supported(C, G) || D <= 0 || (dtype != 0 && dtype != 1)) return -(int)cudaErrorInvalidValue;
  if (dtype == 0) return G == 32 ? blocks_per_sm<float, 32>(D) : blocks_per_sm<float, 8>(D);
  return G == 32 ? blocks_per_sm<__nv_bfloat16, 32>(D) : blocks_per_sm<__nv_bfloat16, 8>(D);
}

// dtype: 0 = float32, 1 = bfloat16 (left, right, out alike).  Takes C = 8 G
// with G = 32 or 8.  Returns a cudaError_t (0 = launched).
extern "C" int gwc_volume(const void* left, const void* right, void* out, int B, int H, int W,
                          int C, int G, int shift_lo, int D, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || D <= 0 || !supported(C, G) || H > 65535 || B > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return G == 32 ? launch<float, 32>(left, right, out, B, H, W, shift_lo, D, st)
                   : launch<float, 8>(left, right, out, B, H, W, shift_lo, D, st);
  return G == 32 ? launch<__nv_bfloat16, 32>(left, right, out, B, H, W, shift_lo, D, st)
                 : launch<__nv_bfloat16, 8>(left, right, out, B, H, W, shift_lo, D, st);
}
