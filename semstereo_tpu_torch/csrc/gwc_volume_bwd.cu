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
// G=32, D=16 on 128x128, bf16) it reads l, r (2 x 16.8 MB) and gb (33.6 MB)
// and writes gl, gr (2 x 16.8 MB): 100.7 MB, 30 us at 3.35 TB/s, for about
// 1 GFLOP.
//
// The design is a streaming row kernel.  One block takes one image row
// (b, h) and walks it in tiles of TW output columns.  The tile at x0 reads
// l and gb over columns x0 + s_lo .. x0 + TW - 1 + s_hi (yr gathers
// u[x + s_d] and gb[d, x + s_d]; yl takes gb at the tile itself) and r over
// x0 - s_hi .. x0 + TW - 1 - s_lo (yl gathers v[x - s_d]), so the windows of
// neighbouring tiles overlap by D - 1 columns.  Rather than restage that
// overlap per tile (1.9x the bytes for independent 16-column tiles), the
// three streams enter a ring in shared memory in chunks of TW columns, each
// chunk once, by 16-byte cp.async (one plane of gb over a chunk is one
// contiguous run).  The loads of the next STAGES - 1 tiles' chunks are in
// flight while a tile computes.  Whole rows were chosen over column
// segments because they read each byte once and need no halo; they give
// B*H blocks (256 at the main shape), about two per SM, and two blocks' rings
// (48 columns at D = 16, 108 KB in bf16) fit an SM.  On the H100 16-column
// tiles of 512 threads (registers capped at 64 for two blocks per SM) took
// 0.0997 ms at the main shape, 8-column tiles of 256 threads (three blocks
// per SM) 0.1048: the tile loop is bound by instruction throughput and latency,
// not by device memory, which it drives at about a third of its rate.
//
// One thread owns one (tile column, group): cpg = 8 channels, fixed at
// compile time with G (C = 8 G, as the model's groups = C / 8), so the
// thread map has no runtime division.  It sums yl and yr over d in fp32
// registers, takes the norm VJP's per-group dot product in registers and
// writes each side's 8 outputs as 16-byte stores.  The group norms of a
// chunk are computed once, as it lands, by the threads that copied it.
//
// The ring holds gb for every plane of a column, so it grows with D.  The
// backward is linear in gb, so above DS = 17 planes the planes go as slabs
// of at most 17, one launch each, whose fp32 sums add up in a workspace
// (the output itself in fp32) and are rounded once by the last launch:
// every launch keeps the 48-column ring (at most 215,040 bytes in fp32).
// D <= 17 is one launch of the kernel above (0.0989 ms at the main shape,
// two blocks per SM); D = 20 in fp32 takes two launches (0.273 ms), D = 36
// in bf16 three (0.281 ms).
//
// Masking: a column outside [0, W) is zero-filled by its copy, which zeroes
// every yr term it feeds (l and gb alike); yl's term at (d, x) is dropped at
// the point of use where x - s_d leaves [0, W), so a non-finite gb there
// does not reach the result, as in the JAX kernel.  Sums are in fp32; the
// outputs are rounded once to the input dtype.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

#include "tc.cuh"

namespace {

constexpr int TW = 16;     // output columns per tile; columns per ring chunk
constexpr int CPG = 8;     // channels per group
constexpr int STAGES = 2;  // tiles whose chunks the ring holds: the one computing, the rest loading
constexpr float EPS = 1e-5f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float& o) { o = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16& o) { o = __float2bfloat16(v); }

// One group's CPG values at p (16-byte aligned) as floats, and back.
template <typename T>
__device__ __forceinline__ void load_group(const T* p, float (&f)[CPG]) {
  constexpr int N = CPG * sizeof(T) / 16;
  uint4 raw[N];
  for (int m = 0; m < N; ++m) raw[m] = reinterpret_cast<const uint4*>(p)[m];
  const T* e = reinterpret_cast<const T*>(raw);
  for (int c = 0; c < CPG; ++c) f[c] = to_f(e[c]);
}
template <typename T>
__device__ __forceinline__ void store_group(T* p, const float (&f)[CPG]) {
  constexpr int N = CPG * sizeof(T) / 16;
  uint4 raw[N];
  T* e = reinterpret_cast<T*>(raw);
  for (int c = 0; c < CPG; ++c) from_f(f[c], e[c]);
  for (int m = 0; m < N; ++m) reinterpret_cast<uint4*>(p)[m] = raw[m];
}

__device__ __forceinline__ float inv_norm(const float (&x)[CPG]) {
  float ss = 0.f;
  for (int c = 0; c < CPG; ++c) ss = fmaf(x[c], x[c], ss);
  return 1.f / (sqrtf(ss) + EPS);
}

// y <- the VJP of x -> x/(|x| + eps) for one group at cotangent y.
__device__ __forceinline__ void norm_vjp(const float (&x)[CPG], float (&y)[CPG]) {
  float ss = 0.f, dot = 0.f;
  for (int c = 0; c < CPG; ++c) {
    ss = fmaf(x[c], x[c], ss);
    dot = fmaf(x[c], y[c], dot);
  }
  const float n = sqrtf(ss), inv = 1.f / (n + EPS);
  const float coef = dot * inv * inv / fmaxf(n, 1e-30f);
  for (int c = 0; c < CPG; ++c) y[c] = y[c] * inv - x[c] * coef;
}

// The ring: chunks one tile's window spans, plus STAGES - 1 tiles' worth
// loading, TW columns each.  Ring column k holds ls [k][C], rs [k][C],
// gs [k][D][G] in T and il, ir [k][G] = 1 / (group norm + eps) in fp32.
__host__ __device__ __forceinline__ int window_chunks(int D) { return 1 + (D + TW - 2) / TW; }
__host__ __device__ __forceinline__ int ring_chunks(int D) { return window_chunks(D) + STAGES - 1; }

template <typename T>
size_t smem_bytes(int G, int D) {
  const size_t cols = (size_t)ring_chunks(D) * TW;
  return cols * (sizeof(T) * (2 * CPG + (size_t)D) * G + sizeof(float) * 2 * G);
}

// The backward is linear in gb, so the planes split into slabs whose
// launches add their sums.  A slab takes at most DS planes: the most whose
// window is two chunks, so that the ring stays 48 columns (110,592 bytes at
// D = 16 in bf16, two blocks per SM; 215,040 at D = 17 in fp32).
constexpr int DS = TW + 1;
int slabs(int D) { return (D + DS - 1) / DS; }
int slab_planes(int D) { return (D + slabs(D) - 1) / slabs(D); }

// What a launch is: all D planes (WHOLE), or one slab of several, whose
// launches sum in fp32: the first writes its sums, a middle one adds the
// sums so far to its own, the last adds them and writes T.
enum Mode { WHOLE, FIRST, MIDDLE, LAST };

// A launch takes the planes lo .. lo + D - 1 of a volume whose gb has Dg
// planes; gbar points at plane 0 of this slab.  The output columns of a
// tile at x0 are x0 + i for gr (yr) and x0 + off + i for gl (yl), with off
// the point of [lo, hi] nearest 0 (0 when the range holds shift 0), so
// that both windows hold what the tile's norm VJPs read.  A range without
// shift 0 comes as a later slab of many planes, or whole as one process's
// part of a volume split over processes (shifts -8..-1 of 16, say).  O
// is the output type: fp32 for FIRST and MIDDLE (acc_l, acc_r, which may be
// the output itself, hold the sums so far for MIDDLE and LAST), else T.
template <typename T, int G, Mode M,
          typename O = typename std::conditional<M == FIRST || M == MIDDLE, float, T>::type>
__global__ void __launch_bounds__(TW * G, 2)
gwc_volume_bwd_kernel(const T* __restrict__ left, const T* __restrict__ right,
                      const T* __restrict__ gbar, O* gleft, O* gright, const float* acc_l,
                      const float* acc_r, int H, int W, int lo, int D, int Dg) {
  constexpr int C = CPG * G, NT = TW * G;
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int GRP = CPG / EPC;       // copies per group
  constexpr int RUN = NT / EPC;        // copies per plane of gb in one chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int hi = lo + D - 1;
  const int off = lo > 0 ? lo : (hi < 0 ? hi : 0);
  if (M == WHOLE) Dg = D;
  const int nwin = window_chunks(D), nring = ring_chunks(D), cols = nring * TW;
  T* ls = reinterpret_cast<T*>(smem);
  T* rs = ls + cols * C;
  T* gs = rs + cols * C;
  float* il = reinterpret_cast<float*>(gs + cols * D * G);
  float* ir = il + cols * G;

  const int i = threadIdx.x / G, g = threadIdx.x % G;  // this thread's column and group
  const int h = blockIdx.x, b = blockIdx.y;
  const int64_t row = ((int64_t)b * H + h) * W;  // voxel index of (b, h, 0)
  // tiles t0 .. t0 + ntiles - 1 cover [0, W) for both outputs
  const int t0 = off > 0 ? -((off + TW - 1) / TW) : 0;
  const int ntiles = (W - (off < 0 ? off : 0) + TW - 1) / TW - t0;
  const int nchunks = ntiles + nwin - 1;  // chunks of each stream the row needs

  // Chunk c holds l and gb at columns (t0 + c) TW + lo + k and r at
  // (t0 + c) TW + off - hi + k (k < TW), in ring slot c mod nring.  Every
  // chunk commits one group, an empty one past the row's end, so the waits
  // count alike on every tile.
  auto load = [&](int c) {
    if (c < nchunks) {
      const int k0 = (c % nring) * TW, x0 = (t0 + c) * TW;
      const int xl = x0 + lo + i, xr = x0 + off - hi + i;
      const bool okl = xl >= 0 && xl < W, okr = xr >= 0 && xr < W;
      for (int m = 0; m < GRP; ++m) {
        const int e = g * CPG + m * EPC;
        tc::cp_async16(tc::smem_addr(ls + (k0 + i) * C + e), left + (okl ? (row + xl) * C + e : 0),
                       okl);
        tc::cp_async16(tc::smem_addr(rs + (k0 + i) * C + e), right + (okr ? (row + xr) * C + e : 0),
                       okr);
      }
      for (int q = threadIdx.x; q < D * RUN; q += NT) {
        const int d = q / RUN, e = q % RUN * EPC;  // plane; element of its TW x G run
        const int k = e / G, x = x0 + lo + k;
        const bool ok = x >= 0 && x < W;
        const int64_t src = ((((int64_t)b * Dg + d) * H + h) * W + x) * G + e - k * G;
        tc::cp_async16(tc::smem_addr(gs + ((k0 + k) * D + d) * G + e - k * G),
                       gbar + (ok ? src : 0), ok);
      }
    }
    tc::cp_async_commit();
  };
  // 1 / (norm + eps) of this thread's group in chunk c, which it copied.
  auto norms = [&](int c) {
    const int k = (c % nring) * TW + i;
    float v[CPG];
    load_group(ls + k * C + g * CPG, v);
    il[k * G + g] = inv_norm(v);
    load_group(rs + k * C + g * CPG, v);
    ir[k * G + g] = inv_norm(v);
  };
  // The norm VJP of one side at cotangent y, plus the earlier slabs' sums.
  auto finish = [&](const T* src, O* out, const float* acc, int64_t at, float (&y)[CPG]) {
    float a[CPG];
    load_group(src, a);
    norm_vjp(a, y);
    if (M == MIDDLE || M == LAST) {
      load_group(acc + at, a);
      for (int c = 0; c < CPG; ++c) y[c] += a[c];
    }
    store_group(out + at, y);
  };

  for (int c = 0; c < nring - 1; ++c) load(c);
  for (int t = 0; t < ntiles; ++t) {
    // chunk t + nring - 1 goes where chunk t - 1 was, which no thread reads
    // since the barrier that ended tile t - 1
    load(t + nring - 1);
    tc::cp_async_wait<STAGES - 1>();  // chunks up to t + nwin - 1 have landed
    if (t == 0) {
      for (int c = 0; c < nwin; ++c) norms(c);
    } else {
      norms(t + nwin - 1);
    }
    __syncthreads();

    // Window column j (l and gb at x0 + s_lo + j, r at x0 + off - s_hi + j)
    // is ring column base + j, wrapped.  This thread's gl column
    // xl = x0 + off + i is window column off - lo + i of l and gb; its gr
    // column x = x0 + i is i - off + hi of r.  Plane d pairs xl with r's
    // i + D - 1 - d (yl) and x with l's and gb's i + d (yr).
    const int x = (t0 + t) * TW + i, xl = x + off, base = (t % nring) * TW;
    auto ring = [&](int j) { return base + j < cols ? base + j : base + j - cols; };
    const int jx = ring(off - lo + i);
    float yl[CPG] = {}, yr[CPG] = {};
    for (int d = 0; d < D; ++d) {
      const int jv = ring(i + D - 1 - d), ju = ring(i + d);
      const bool valid = (unsigned)(xl - lo - d) < (unsigned)W;  // xl - s_d in the image
      const float wl = valid ? to_f(gs[(jx * D + d) * G + g]) * ir[jv * G + g] : 0.f;
      const float wr = to_f(gs[(ju * D + d) * G + g]) * il[ju * G + g];
      float v[CPG], u[CPG];
      load_group(rs + jv * C + g * CPG, v);
      load_group(ls + ju * C + g * CPG, u);
      for (int c = 0; c < CPG; ++c) {
        yl[c] = fmaf(wl, v[c], yl[c]);
        yr[c] = fmaf(wr, u[c], yr[c]);
      }
    }
    const bool okl = (unsigned)xl < (unsigned)W, okr = (unsigned)x < (unsigned)W;
    if (okl || okr) {
      for (int c = 0; c < CPG; ++c) {
        yl[c] *= 1.f / CPG;
        yr[c] *= 1.f / CPG;
      }
      if (okl) finish(ls + jx * C + g * CPG, gleft, acc_l, (row + xl) * C + g * CPG, yl);
      if (okr)
        finish(rs + ring(i - off + hi) * C + g * CPG, gright, acc_r, (row + x) * C + g * CPG, yr);
    }
    __syncthreads();
  }
  tc::cp_async_wait<0>();
}

// One launch: the planes lo .. lo + D - 1 at gbar, of Dg in all.
template <typename T, int G, Mode M, typename O>
int launch_slab(const T* l, const T* r, const T* gb, O* gl, O* gr, const float* acc_l,
                const float* acc_r, int B, int H, int W, int lo, int D, int Dg,
                cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(G, D);
  cudaError_t e = cudaFuncSetAttribute(gwc_volume_bwd_kernel<T, G, M>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  gwc_volume_bwd_kernel<T, G, M><<<dim3(H, B), TW * G, smem, stream>>>(
      l, r, gb, gl, gr, acc_l, acc_r, H, W, lo, D, Dg);
  return (int)cudaGetLastError();
}

// The planes split into slabs(D) slabs of at most slab_planes(D) each.  The
// first slab writes its fp32 sums to the workspace wl, wr; each later one
// adds the sums so far to its own; the last writes T.  One slab writes T
// directly.  For fp32 the workspace is the output itself.
template <typename T, int G>
int launch(const void* l, const void* r, const void* gb, void* gl, void* gr, float* wl, float* wr,
           int B, int H, int W, int lo, int D, cudaStream_t stream) {
  const T *lt = static_cast<const T*>(l), *rt = static_cast<const T*>(r);
  const T* gbt = static_cast<const T*>(gb);
  T *glt = static_cast<T*>(gl), *grt = static_cast<T*>(gr);
  const int n = slabs(D), per = slab_planes(D);
  if (n == 1)
    return launch_slab<T, G, WHOLE>(lt, rt, gbt, glt, grt, nullptr, nullptr, B, H, W, lo, D, D,
                                    stream);
  for (int k = 0; k < n; ++k) {
    const int d0 = k * per, dk = D - d0 < per ? D - d0 : per;
    const T* gbk = gbt + (size_t)d0 * H * W * G;
    int e;
    if (k == 0)
      e = launch_slab<T, G, FIRST>(lt, rt, gbk, wl, wr, nullptr, nullptr, B, H, W, lo + d0, dk, D,
                                   stream);
    else if (k < n - 1)
      e = launch_slab<T, G, MIDDLE>(lt, rt, gbk, wl, wr, wl, wr, B, H, W, lo + d0, dk, D, stream);
    else
      e = launch_slab<T, G, LAST>(lt, rt, gbk, glt, grt, wl, wr, B, H, W, lo + d0, dk, D, stream);
    if (e != 0) return e;
  }
  return 0;
}

// Blocks per SM of the first launch of D planes.
template <typename T, int G, Mode M>
int blocks_per_sm(int D) {
  const size_t smem = smem_bytes<T>(G, slab_planes(D));
  auto kernel = gwc_volume_bwd_kernel<T, G, M>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, TW * G, smem);
  return e == cudaSuccess ? n : -(int)e;
}
template <typename T, int G>
int blocks_per_sm(int D) {
  return slabs(D) == 1 ? blocks_per_sm<T, G, WHOLE>(D) : blocks_per_sm<T, G, FIRST>(D);
}

// The instantiations: G = 32 (the model's C = 256) and G = 8 (small shapes).
bool supported(int C, int G) { return C == CPG * G && (G == 32 || G == 8); }

}  // namespace

// Bytes of shared memory each launch of D planes needs (the wrapper checks
// it against the card's limit); dtype as below.
extern "C" long long gwc_volume_bwd_smem(int C, int G, int D, int dtype) {
  (void)C;
  const int d = slab_planes(D);
  return dtype == 0 ? (long long)smem_bytes<float>(G, d)
                    : (long long)smem_bytes<__nv_bfloat16>(G, d);
}

// Launches that D planes take: one per slab.
extern "C" int gwc_volume_bwd_slabs(int D) { return D > 0 ? slabs(D) : 0; }

// Blocks of the first launch that fit on one SM at once (cudaOccupancy...),
// or minus a cudaError_t.
extern "C" int gwc_volume_bwd_blocks_per_sm(int C, int G, int D, int dtype) {
  if (!supported(C, G) || D <= 0 || (dtype != 0 && dtype != 1)) return -(int)cudaErrorInvalidValue;
  if (dtype == 0) return G == 32 ? blocks_per_sm<float, 32>(D) : blocks_per_sm<float, 8>(D);
  return G == 32 ? blocks_per_sm<__nv_bfloat16, 32>(D) : blocks_per_sm<__nv_bfloat16, 8>(D);
}

// dtype: 0 = float32, 1 = bfloat16 (left, right, gbar, gleft, gright alike).
// Takes C = 8 G with G = 32 or 8 and any range of D shifts.  wl, wr are
// fp32 [B,H,W,C] workspaces, needed in bf16 when D takes more than one slab
// (else unread; fp32 sums in the output itself).  Returns a cudaError_t
// (0 = launched).
extern "C" int gwc_volume_bwd(const void* left, const void* right, const void* gbar, void* gleft,
                              void* gright, void* wl, void* wr, int B, int H, int W, int C, int G,
                              int shift_lo, int D, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || D <= 0 || !supported(C, G) || B > 65535 ||
      (dtype != 0 && dtype != 1) ||
      (dtype == 1 && slabs(D) > 1 && (wl == nullptr || wr == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    float *fl = static_cast<float*>(gleft), *fr = static_cast<float*>(gright);
    return G == 32 ? launch<float, 32>(left, right, gbar, gleft, gright, fl, fr, B, H, W,
                                       shift_lo, D, st)
                   : launch<float, 8>(left, right, gbar, gleft, gright, fl, fr, B, H, W, shift_lo,
                                      D, st);
  }
  float *fl = static_cast<float*>(wl), *fr = static_cast<float*>(wr);
  return G == 32 ? launch<__nv_bfloat16, 32>(left, right, gbar, gleft, gright, fl, fr, B, H, W,
                                             shift_lo, D, st)
                 : launch<__nv_bfloat16, 8>(left, right, gbar, gleft, gright, fl, fr, B, H, W,
                                            shift_lo, D, st);
}
