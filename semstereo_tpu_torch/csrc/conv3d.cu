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
// ~295 FLOP/byte ridge, so the products must run on the tensor cores.  All
// variants are implicit GEMMs with M = output voxels, N = F, K = 27 C; the
// halo and ragged edges read as zero and the BN affine and ReLU run in the
// epilogue.
//  * bf16, C % 8 == 0 (conv3d_tc_kernel): a block owns a TH x 32 tile of
//    output rows and columns and F-block, and walks a run of output planes.
//    Input planes (the tile's halo, all channels) sit in a ring of two
//    slots, each XOR-swizzled so that ldmatrix reads no padding and no bank
//    conflict.  Output plane od reads planes od*S - 1, od*S, od*S + 1 one
//    after the other (kd = 0, 1, 2); while kd = 1 runs, cp.async refills the
//    slot of the kd = 0 plane with the kd = 2 one, and at stride 2, while
//    kd = 2 runs, the slot of the kd = 1 plane with the next output plane's
//    kd = 1 one.  So an input plane crosses into shared memory once per
//    block instead of once per kd tap, and each load has nine taps of
//    products to hide behind.  The weights stream one tap (C x BN) at a time
//    through three more slots, two taps ahead.  Each warp owns WR output
//    rows x 32 columns x 32 channels and runs ldmatrix + mma.sync m16n8k16,
//    loading each B fragment once for all its A fragments.  Stride 2 uses
//    4-row tiles up to 64 channels and 2-row ones above.
//  * bf16, C < 8 (conv3d_narrow_kernel, the Cout=1 classifier convs' input
//    gradient): the 27 taps x C channels are packed into one K dimension
//    (27 x 1 channel in one K = 32 step) of an im2col tile, instead of
//    padding C to 8.
//  * fp32 (conv3d_kernel): the same GEMM on the CUDA cores with fp32 FMA, one
//    tap and 32 channels per step, and a TM x TN register tile per thread.
//    fp32 has no tensor-core path: TF32 would lose the 1e-4 agreement with
//    the plain version.

#include <algorithm>

#include "tc.cuh"

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
// bf16 tensor-core kernels
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// Stores the fp32 accumulators of one m16n8 tile row (the pair at columns f,
// f + 1) after the affine and ReLU; pairs as one 4-byte store where F is even.
__device__ __forceinline__ void store_pair(bf16* __restrict__ y, int64_t at, int f, int F, float v0,
                                           float v1, const float* __restrict__ scale,
                                           const float* __restrict__ bias, int relu) {
  if (f >= F) return;
  v0 = fmaf(v0, scale[f], bias[f]);
  if (relu) v0 = fmaxf(v0, 0.f);
  if (f + 1 < F) {
    v1 = fmaf(v1, scale[f + 1], bias[f + 1]);
    if (relu) v1 = fmaxf(v1, 0.f);
  }
  if ((F & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(y + at + f) = __floats2bfloat162_rn(v0, v1);
  } else {
    y[at + f] = __float2bfloat16(v0);
    if (f + 1 < F) y[at + f + 1] = __float2bfloat16(v1);
  }
}

constexpr int TW = 32;  // output columns of a tile

// Shared memory of conv3d_tc_kernel: two plane slots and three weight slots.
struct TcLayout {
  int CK, kch, CP, HR, HC, slab, wslot;
  __host__ __device__ TcLayout(int C, int S, int TH, int BN) {
    CK = (C + 15) & ~15;  // channels per tap, padded to the k16 step
    kch = CK / 8;         // 16-byte chunks of a voxel that are loaded
    CP = 2;               // chunks per voxel in a slot (a power of two, for the swizzle)
    while (CP < kch) CP <<= 1;
    HR = (TH - 1) * S + 3;
    HC = (TW - 1) * S + 3;
    slab = HR * HC * CP * 16;
    wslot = CK * BN * 2;
  }
  __host__ __device__ int bytes() const { return 2 * slab + 3 * wslot; }
};

template <int TH, int WR, int BN>
__host__ __device__ constexpr int tc_threads() {
  return (TH / WR) * (BN < 32 ? 1 : BN / 32) * 32;
}

// MINB blocks per SM bound the registers a thread may take (launch_tc_bn)
template <int TH, int WR, int BN, int MINB>
__global__ void __launch_bounds__(tc_threads<TH, WR, BN>(), MINB)
conv3d_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 bf16* __restrict__ y, int D, int H, int W, int C, int F, int S, int OD, int OH,
                 int OW, int relu, int tiles_w, int nsplit, int dper) {
  constexpr int WN = BN < 32 ? BN : 32;  // output channels of a warp
  constexpr int NT = WN / 8;             // its n8 tiles
  constexpr int WARPS_N = BN / WN;
  constexpr int NTH = tc_threads<TH, WR, BN>();
  constexpr int WCH = BN / 8;            // 16-byte chunks of a weight row
  extern __shared__ __align__(128) unsigned char smem[];

  const TcLayout L(C, S, TH, BN);
  const unsigned sbase = tc::smem_addr(smem);
  const unsigned wbase = sbase + 2 * L.slab;
  const tc::Swizzle xsw(L.CP, S), wsw(WCH, 1);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int h0 = (blockIdx.x / tiles_w) * TH, w0 = (blockIdx.x % tiles_w) * TW;
  const int b = blockIdx.y / nsplit;
  const int od0 = (blockIdx.y % nsplit) * dper;
  const int od1 = min(od0 + dper, OD);
  const int n0 = blockIdx.z * BN;
  const int64_t vb = (int64_t)b * D * H * W;
  if (od0 >= od1) return;

  // input plane p (all channels of the tile's halo) into slot p mod 2
  auto load_plane = [&](int p) {
    const unsigned dst = sbase + ((p + 2) & 1) * L.slab;
    const bool pin = p >= 0 && p < D;
    for (int q = tid; q < L.HR * L.HC * L.kch; q += NTH) {
      const int k = q % L.kch, v = q / L.kch;
      const int gh = h0 * S - 1 + v / L.HC, gw = w0 * S - 1 + v % L.HC, c = k * 8;
      const bool ok = pin && gh >= 0 && gh < H && gw >= 0 && gw < W && c < C;
      const bf16* src = ok ? x + (vb + ((int64_t)p * H + gh) * W + gw) * C + c : x;
      tc::cp_async16(dst + (v * L.CP + (k ^ xsw(v))) * 16, src, ok);
    }
  };
  // the weights of tap t (C x BN, zero-padded to CK rows) into slot j mod 3
  auto load_w = [&](int j) {
    const int t = j % 27;
    if ((F & 7) == 0) {
      const unsigned dst = wbase + (j % 3) * L.wslot;
      for (int q = tid; q < L.CK * WCH; q += NTH) {
        const int n8 = q % WCH, r = q / WCH, f = n0 + n8 * 8;
        const bool ok = r < C && f < F;
        const bf16* src = ok ? w + ((int64_t)t * C + r) * F + f : w;
        tc::cp_async16(dst + (r * WCH + (n8 ^ wsw(r))) * 16, src, ok);
      }
    } else {
      bf16* ws = reinterpret_cast<bf16*>(smem + 2 * L.slab + (j % 3) * L.wslot);
      for (int q = tid; q < L.CK * BN; q += NTH) {
        const int n = q % BN, r = q / BN, f = n0 + n;
        ws[(r * WCH + ((n >> 3) ^ wsw(r))) * 8 + (n & 7)] =
            (r < C && f < F) ? w[((int64_t)t * C + r) * F + f] : __float2bfloat16(0.f);
      }
    }
  };

  float acc[2 * WR][NT][4];
#pragma unroll
  for (int i = 0; i < 2 * WR; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load_plane(od0 * S - 1);
  load_plane(od0 * S);
  load_w(0);
  tc::cp_async_commit();
  load_w(1);
  tc::cp_async_commit();

  const int gid = lane >> 2, tig = lane & 3;
  const int steps = (od1 - od0) * 27;
  for (int g = 0; g < steps; ++g) {
    // step g's plane and weights have landed; every warp is done with step
    // g - 1, whose weight slot (and, at kd = 1 or 2, plane slot) is free
    tc::cp_async_wait<1>();
    __syncthreads();
    const int od = od0 + g / 27, t = g % 27;
    const int kd = t / 9, kh = (t / 3) % 3, kw = t % 3;
    if (g + 2 < steps) load_w(g + 2);
    // the kd = 0 plane od*S - 1 is done with: its slot takes the kd = 2
    // plane; at stride 2 the kd = 1 plane od*S is then done with too, and
    // its slot takes od*S + 2, output plane od + 1's kd = 1 plane (at
    // stride 1 the next output plane reads od*S and od*S + 1, still held)
    if (t == 9) load_plane(od * S + 1);
    if (S == 2 && t == 18 && od + 1 < od1) load_plane(od * S + 2);
    tc::cp_async_commit();

    const unsigned slab = sbase + ((od * S + kd + 1) & 1) * L.slab;
    const unsigned wsl = wbase + (g % 3) * L.wslot;
#pragma unroll 1
    for (int kc = 0; kc < L.CK / 16; ++kc) {
      unsigned bfr[NT][2];
      if constexpr (NT == 1) {
        const int r = kc * 16 + (lane & 15);
        unsigned t2[2];
        tc::ldsm_x2_t(t2, wsl + (r * WCH + ((wn * NT) ^ wsw(r))) * 16);
        bfr[0][0] = t2[0];
        bfr[0][1] = t2[1];
      } else {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int r = kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int ch = wn * NT + np * 2 + (lane >> 4);
          unsigned t4[4];
          tc::ldsm_x4_t(t4, wsl + (r * WCH + (ch ^ wsw(r))) * 16);
          bfr[2 * np][0] = t4[0];
          bfr[2 * np][1] = t4[1];
          bfr[2 * np + 1][0] = t4[2];
          bfr[2 * np + 1][1] = t4[3];
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2 * WR; ++mi) {
        const int row = (wm * WR + mi / 2) * S + kh;
        const int col = ((mi & 1) * 16 + (lane & 15)) * S + kw;
        const int v = row * L.HC + col;
        const int ch = kc * 2 + (lane >> 4);
        unsigned a[4];
        tc::ldsm_x4(a, slab + (v * L.CP + (ch ^ xsw(v))) * 16);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) tc::mma16816(acc[mi][ni], a, bfr[ni][0], bfr[ni][1]);
      }
    }

    if (t == 26) {  // output plane od is complete
#pragma unroll
      for (int mi = 0; mi < 2 * WR; ++mi) {
        const int oh = h0 + wm * WR + mi / 2;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int ow = w0 + (mi & 1) * 16 + gid + hr * 8;
          if (oh < OH && ow < OW) {
            const int64_t at = ((((int64_t)b * OD + od) * OH + oh) * OW + ow) * F;
#pragma unroll
            for (int ni = 0; ni < NT; ++ni)
              store_pair(y, at, n0 + wn * WN + ni * 8 + tig * 2, F, acc[mi][ni][2 * hr],
                         acc[mi][ni][2 * hr + 1], scale, bias, relu);
          }
        }
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
      }
    }
  }
}

// C < 8: 128 output voxels x BN per block, the 27 taps x C channels packed
// into one K = KP (27 C rounded up to 16) im2col tile.  Rows of both tiles
// are padded by 16 bytes (an odd number of 16-byte chunks apart), so
// ldmatrix reads 8 rows on 8 bank groups.
template <int BN>
__host__ __device__ constexpr int narrow_threads() {
  return 4 * (BN < 32 ? 1 : BN / 32) * 32;
}

template <int BN>
__global__ void __launch_bounds__(narrow_threads<BN>())
conv3d_narrow_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     bf16* __restrict__ y, int D, int H, int W, int C, int F, int S, int OD,
                     int OH, int OW, int64_t M, int relu) {
  constexpr int WN = BN < 32 ? BN : 32;
  constexpr int NT = WN / 8;
  constexpr int WARPS_N = BN / WN;
  constexpr int NTH = narrow_threads<BN>();
  constexpr int BS = BN == 8 ? 8 : BN + 8;  // weight row stride (elements)
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = 27 * C, KP = (K + 15) & ~15, AS = KP + 8;
  bf16* as = reinterpret_cast<bf16*>(smem);  // [128][AS]
  bf16* bs = as + 128 * AS;                  // [KP][BS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int64_t m0 = (int64_t)blockIdx.x * 128;
  const int n0 = blockIdx.y * BN;
  __shared__ int64_t rowb[128];  // voxel index of (b, 0, 0, 0)
  __shared__ int rowd[128], rowh[128], roww[128];

  for (int i = tid; i < 128; i += NTH) {
    const int64_t m = m0 + i;
    if (m < M) {
      const int ow = (int)(m % OW);
      int64_t t = m / OW;
      const int oh = (int)(t % OH);
      t /= OH;
      rowb[i] = (t / OD) * D * H * W;
      rowd[i] = (int)(t % OD) * S - 1;
      rowh[i] = oh * S - 1;
      roww[i] = ow * S - 1;
    } else {  // rows past M read zeros and are not stored
      rowb[i] = 0;
      rowd[i] = rowh[i] = roww[i] = -4;
    }
  }
  __syncthreads();
  for (int q = tid; q < KP * BN; q += NTH) {
    const int n = q % BN, r = q / BN, f = n0 + n;
    bs[r * BS + n] = (r < K && f < F) ? w[(int64_t)r * F + f] : __float2bfloat16(0.f);
  }
  for (int q = tid; q < 128 * KP; q += NTH) {
    const int r = q % KP, i = q / KP;
    bf16 v = __float2bfloat16(0.f);
    if (r < K) {
      const int tap = r / C, c = r % C;
      const int id = rowd[i] + tap / 9, ih = rowh[i] + (tap / 3) % 3, iw = roww[i] + tap % 3;
      if (id >= 0 && id < D && ih >= 0 && ih < H && iw >= 0 && iw < W)
        v = x[(rowb[i] + ((int64_t)id * H + ih) * W + iw) * C + c];
    }
    as[i * AS + r] = v;
  }
  __syncthreads();

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const unsigned abase = tc::smem_addr(as), bbase = tc::smem_addr(bs);
#pragma unroll 1
  for (int kc = 0; kc < KP / 16; ++kc) {
    unsigned bfr[NT][2];
    if constexpr (NT == 1) {
      const int r = kc * 16 + (lane & 15);
      unsigned t2[2];
      tc::ldsm_x2_t(t2, bbase + (r * BS + wn * WN) * 2);
      bfr[0][0] = t2[0];
      bfr[0][1] = t2[1];
    } else {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int r = kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int n = wn * WN + np * 16 + (lane >> 4) * 8;
        unsigned t4[4];
        tc::ldsm_x4_t(t4, bbase + (r * BS + n) * 2);
        bfr[2 * np][0] = t4[0];
        bfr[2 * np][1] = t4[1];
        bfr[2 * np + 1][0] = t4[2];
        bfr[2 * np + 1][1] = t4[3];
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int row = wm * 32 + mi * 16 + (lane & 15);
      unsigned a[4];
      tc::ldsm_x4(a, abase + (row * AS + kc * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) tc::mma16816(acc[mi][ni], a, bfr[ni][0], bfr[ni][1]);
    }
  }

  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int64_t m = m0 + wm * 32 + mi * 16 + gid + hr * 8;
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
        store_pair(y, m * F, n0 + wn * WN + ni * 8 + tig * 2, F, acc[mi][ni][2 * hr],
                   acc[mi][ni][2 * hr + 1], scale, bias, relu);
    }
}

constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may use
constexpr int NUM_SMS = 132;      // H100 SXM: the grids aim at a few blocks per SM

template <int TH, int WR, int BN, int MINB>
int launch_tc_cfg(const void* x, const void* w, const float* sc, const float* bi, void* y, int B,
                  int D, int H, int W, int C, int F, int S, int relu, cudaStream_t st) {
  const int smem = TcLayout(C, S, TH, BN).bytes();
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kern = conv3d_tc_kernel<TH, WR, BN, MINB>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int OD = (D - 1) / S + 1, OH = (H - 1) / S + 1, OW = (W - 1) / S + 1;
  const int tiles_w = (OW + TW - 1) / TW, tiles_h = (OH + TH - 1) / TH;
  const int fblocks = (F + BN - 1) / BN;
  // split the output planes so that the grid holds about four blocks per SM
  const int64_t base = (int64_t)tiles_w * tiles_h * B * fblocks;
  int nsplit = (int)std::min<int64_t>(OD, (4 * NUM_SMS + base - 1) / base);
  const int dper = (OD + nsplit - 1) / nsplit;
  nsplit = (OD + dper - 1) / dper;
  if ((int64_t)B * nsplit > 65535 || (int64_t)tiles_w * tiles_h > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  dim3 grid(tiles_w * tiles_h, B * nsplit, fblocks);
  kern<<<grid, tc_threads<TH, WR, BN>(), smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), sc, bi, static_cast<bf16*>(y), D,
      H, W, C, F, S, OD, OH, OW, relu, tiles_w, nsplit, dper);
  return (int)cudaGetLastError();
}

// Registers against blocks per SM, as measured on the main-path shapes:
// 4-warp blocks at most 170 registers a thread (three per SM); 8-warp ones
// (BN = 64) at most 128 (two per SM) where the halo is small (stride 2, or
// C <= 32), else what they need (one per SM), as 128 made those spill.
template <int TH, int WR>
int launch_tc_bn(const void* x, const void* w, const float* sc, const float* bi, void* y, int B,
                 int D, int H, int W, int C, int F, int S, int relu, cudaStream_t st) {
  if (F <= 8) return launch_tc_cfg<TH, WR, 8, 3>(x, w, sc, bi, y, B, D, H, W, C, F, S, relu, st);
  if (F <= 32) return launch_tc_cfg<TH, WR, 32, 3>(x, w, sc, bi, y, B, D, H, W, C, F, S, relu, st);
  if (S == 1 && C > 32)
    return launch_tc_cfg<TH, WR, 64, 1>(x, w, sc, bi, y, B, D, H, W, C, F, S, relu, st);
  return launch_tc_cfg<TH, WR, 64, 2>(x, w, sc, bi, y, B, D, H, W, C, F, S, relu, st);
}

// Tile height by stride and width: the two plane slots must fit beside the
// weight slots (stride 1: 8 rows up to 128 channels; stride 2: 4 rows up to
// 64 channels, 2 above).
int launch_tc(const void* x, const void* w, const float* sc, const float* bi, void* y, int B,
              int D, int H, int W, int C, int F, int S, int relu, cudaStream_t st) {
  if (S == 1) return launch_tc_bn<8, 2>(x, w, sc, bi, y, B, D, H, W, C, F, S, relu, st);
  return C <= 64 ? launch_tc_bn<4, 1>(x, w, sc, bi, y, B, D, H, W, C, F, S, relu, st)
                 : launch_tc_bn<2, 1>(x, w, sc, bi, y, B, D, H, W, C, F, S, relu, st);
}

template <int BN>
int launch_narrow_cfg(const void* x, const void* w, const float* sc, const float* bi, void* y,
                      int B, int D, int H, int W, int C, int F, int S, int relu, cudaStream_t st) {
  const int KP = (27 * C + 15) & ~15;
  const int smem = (128 * (KP + 8) + KP * (BN == 8 ? 8 : BN + 8)) * 2;
  auto kern = conv3d_narrow_kernel<BN>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int OD = (D - 1) / S + 1, OH = (H - 1) / S + 1, OW = (W - 1) / S + 1;
  const int64_t M = (int64_t)B * OD * OH * OW;
  const int64_t gx = (M + 127) / 128;
  if (gx > 2147483647LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)gx, (F + BN - 1) / BN);
  kern<<<grid, narrow_threads<BN>(), smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), sc, bi, static_cast<bf16*>(y), D,
      H, W, C, F, S, OD, OH, OW, M, relu);
  return (int)cudaGetLastError();
}

int launch_narrow(const void* x, const void* w, const float* sc, const float* bi, void* y, int B,
                  int D, int H, int W, int C, int F, int S, int relu, cudaStream_t st) {
  if (F <= 8) return launch_narrow_cfg<8>(x, w, sc, bi, y, B, D, H, W, C, F, S, relu, st);
  if (F <= 32) return launch_narrow_cfg<32>(x, w, sc, bi, y, B, D, H, W, C, F, S, relu, st);
  return launch_narrow_cfg<64>(x, w, sc, bi, y, B, D, H, W, C, F, S, relu, st);
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

// dtype: 0 = float32, 1 = bfloat16 (x, w and y; bf16 takes C % 8 == 0 or
// C < 8); scale/bias are float32 [F].  Returns a cudaError_t (0 = launched).
extern "C" int conv3d_bn_act(const void* x, const void* w, const void* scale, const void* bias,
                             void* y, int B, int D, int H, int W, int C, int F, int stride,
                             int relu, int dtype, void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0 || (stride != 1 && stride != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == 0) return launch_fp32(x, w, sc, bi, y, B, D, H, W, C, F, stride, relu, st);
  if (dtype == 1 && C < 8) return launch_narrow(x, w, sc, bi, y, B, D, H, W, C, F, stride, relu, st);
  if (dtype == 1 && C % 8 == 0) return launch_tc(x, w, sc, bi, y, B, D, H, W, C, F, stride, relu, st);
  return (int)cudaErrorInvalidValue;
}
