// Weight gradient of the 3x3x3 pad-1 convolution, stride 1 or 2, for sm_90a.
//
// Replaces the dw half of the TPU VJP semstereo_tpu/ops/pallas/conv3d_wl.py
// _vjp_bwd (its 27 [C, M] x [M, F] tap contractions, :369-387).
// Contract:  dw[tap, c, f] = sum_{b,o} x[b, o*s - 1 + tap, c] g[b, o, f]
// x [B,D,H,W,C] and g [B,OD,OH,OW,F] channels-last; reads outside the volume
// count as zero; fp32 sums.  Each block writes the partial sums of its run of
// voxels to part[split][27][C][F] (fp32); the caller sums the splits in a
// fixed order, so the result is deterministic (no atomics).
//
// What bounds it on the card: operations (2 x 27 C F per output voxel; the
// 13 volume convs of a batch-2 train step do about 785 GFLOP for a few
// hundred MB).  So it is an implicit GEMM on the tensor cores whose
// reduction axis is the voxels: M = C, N = F, K = output voxels.
//  * bf16 (wgrad_tc_kernel): a block owns one kd plane of taps (9 taps, one
//    warp each), a block of CB input and FB output channels, and a run of
//    output tiles (4 rows x 32 columns at stride 1, 2 x 32 at stride 2).
//    Each tile's input halo and its g tile are staged once by cp.async in a
//    three-slot ring, two tiles ahead, XOR-swizzled for ldmatrix; every warp
//    reads its tap's A fragments (x, transposed) as a strided view of the
//    halo and the B fragments (g, transposed) from the same g tile, and
//    accumulates CB x FB in fp32 registers over all its tiles.  Edges are
//    masked on load, so there is no padded or phase-split copy.  F <= 8
//    takes one n8 column tile per warp.
//  * bf16, F = 1 at stride 1 (wgrad_n1_kernel, the Cout=1 classifier convs):
//    one n8 tile would waste 7 of its 8 columns, so the taps go to N
//    instead: dw[tap, c] = sum_u x[u, c] g[u - tap + 1] over input voxels u,
//    M = C, N = 27 taps (32 columns), K = input voxels.  A block stages a
//    4 x 32 tile of x (no halo) and the g values around it (3 x 6 x 34), and
//    each warp builds its B fragments from those g values; x crosses into
//    shared memory once instead of once per kd.
//  * fp32 (wgrad_f32_kernel): the same tiling on the CUDA cores with fp32
//    FMA, a 4 x 4 register tile of (c, f) per thread and tap; TF32 would lose
//    the 1e-4 agreement with the plain version.

#include <algorithm>

#include "tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int TW = 32;  // output columns of a tile

__host__ __device__ inline int tile_rows(int S) { return S == 1 ? 4 : 2; }

// Where output tile T of a run lies: batch, output plane, first row, first column.
struct Tile {
  int b, od, oh0, ow0;
  __device__ Tile(int64_t T, int tiles_w, int tiles_h, int OD, int TR) {
    ow0 = (int)(T % tiles_w) * TW;
    int64_t u = T / tiles_w;
    oh0 = (int)(u % tiles_h) * TR;
    u /= tiles_h;
    od = (int)(u % OD);
    b = (int)(u / OD);
  }
};

// at most 113 registers a thread: two blocks per SM
template <int CB, int FB>
__global__ void __launch_bounds__(288, 2)
wgrad_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g, float* __restrict__ part,
                int D, int H, int W, int C, int F, int S, int OD, int OH, int OW, int tiles_w,
                int tiles_h, int64_t ntiles, int nsplit) {
  constexpr int XCH = CB / 8, GCH = FB / 8;  // 16-byte chunks of a halo voxel, of a g voxel
  constexpr int MT = CB / 16, NT = FB / 8;   // m16 and n8 tiles of a warp
  extern __shared__ __align__(128) unsigned char smem[];

  const int TR = tile_rows(S), HR = (TR - 1) * S + 3, HC = (TW - 1) * S + 3;
  const int xbytes = HR * HC * XCH * 16, gbytes = TR * TW * FB * 2;
  const unsigned sbase = tc::smem_addr(smem);
  const tc::Swizzle xsw(XCH, S), gsw(GCH, 1);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kh = warp / 3, kw = warp % 3;
  const int cblocks = (C + CB - 1) / CB, fblocks = (F + FB - 1) / FB;
  const int kd = blockIdx.y / (cblocks * fblocks);
  const int c0 = (blockIdx.y / fblocks) % cblocks * CB, f0 = blockIdx.y % fblocks * FB;
  const int64_t T0 = ntiles * blockIdx.x / nsplit, T1 = ntiles * (blockIdx.x + 1) / nsplit;
  const int64_t vb_stride = (int64_t)D * H * W;

  auto load = [&](int64_t T, int slot) {
    const Tile tl(T, tiles_w, tiles_h, OD, TR);
    const unsigned xs = sbase + slot * (xbytes + gbytes), gs = xs + xbytes;
    const int p = tl.od * S + kd - 1;
    const bool pin = p >= 0 && p < D;
    const int64_t xb = tl.b * vb_stride + (int64_t)p * H * W;
    for (int q = tid; q < HR * HC * XCH; q += 288) {
      const int k = q % XCH, v = q / XCH;
      const int gh = tl.oh0 * S - 1 + v / HC, gw = tl.ow0 * S - 1 + v % HC, c = c0 + k * 8;
      const bool ok = pin && gh >= 0 && gh < H && gw >= 0 && gw < W && c < C;
      const bf16* src = ok ? x + (xb + (int64_t)gh * W + gw) * C + c : x;
      tc::cp_async16(xs + (v * XCH + (k ^ xsw(v))) * 16, src, ok);
    }
    const int64_t gb = ((int64_t)tl.b * OD + tl.od) * OH;
    if ((F & 7) == 0) {
      for (int q = tid; q < TR * TW * GCH; q += 288) {
        const int k = q % GCH, i = q / GCH;
        const int oh = tl.oh0 + i / TW, ow = tl.ow0 + i % TW, f = f0 + k * 8;
        const bool ok = oh < OH && ow < OW && f < F;
        const bf16* src = ok ? g + ((gb + oh) * OW + ow) * F + f : g;
        tc::cp_async16(gs + (i * GCH + (k ^ gsw(i))) * 16, src, ok);
      }
    } else {
      bf16* gp = reinterpret_cast<bf16*>(smem + slot * (xbytes + gbytes) + xbytes);
      for (int q = tid; q < TR * TW * FB; q += 288) {
        const int n = q % FB, i = q / FB;
        const int oh = tl.oh0 + i / TW, ow = tl.ow0 + i % TW, f = f0 + n;
        gp[(i * GCH + ((n >> 3) ^ gsw(i))) * 8 + (n & 7)] =
            (oh < OH && ow < OW && f < F) ? g[((gb + oh) * OW + ow) * F + f]
                                          : __float2bfloat16(0.f);
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (T0 < T1) load(T0, 0);
  tc::cp_async_commit();
  if (T0 + 1 < T1) load(T0 + 1, 1);
  tc::cp_async_commit();

  for (int64_t T = T0; T < T1; ++T) {
    const int i = (int)(T - T0);
    tc::cp_async_wait<1>();
    __syncthreads();  // tile T has landed; every warp is done with tile T - 1
    if (T + 2 < T1) load(T + 2, (i + 2) % 3);
    tc::cp_async_commit();

    const unsigned xs = sbase + (i % 3) * (xbytes + gbytes), gs = xs + xbytes;
#pragma unroll 1
    for (int r = 0; r < TR; ++r) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // 16 output columns: one k16 step
        unsigned bfr[NT][2];
        if constexpr (NT == 1) {
          const int gi = r * TW + j * 16 + (lane & 15);
          unsigned t2[2];
          tc::ldsm_x2_t(t2, gs + (gi * GCH + gsw(gi)) * 16);
          bfr[0][0] = t2[0];
          bfr[0][1] = t2[1];
        } else {
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            const int gi = r * TW + j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
            const int ch = np * 2 + (lane >> 4);
            unsigned t4[4];
            tc::ldsm_x4_t(t4, gs + (gi * GCH + (ch ^ gsw(gi))) * 16);
            bfr[2 * np][0] = t4[0];
            bfr[2 * np][1] = t4[1];
            bfr[2 * np + 1][0] = t4[2];
            bfr[2 * np + 1][1] = t4[3];
          }
        }
        const int col = (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * S + kw;
        const int v = (r * S + kh) * HC + col;
#pragma unroll
        for (int mc = 0; mc < MT; ++mc) {
          const int ch = mc * 2 + ((lane >> 3) & 1);
          unsigned a[4];
          tc::ldsm_x4_t(a, xs + (v * XCH + (ch ^ xsw(v))) * 16);
#pragma unroll
          for (int ni = 0; ni < NT; ++ni) tc::mma16816(acc[mc][ni], a, bfr[ni][0], bfr[ni][1]);
        }
      }
    }
  }

  const int gid = lane >> 2, tig = lane & 3;
  float* out = part + ((int64_t)blockIdx.x * 27 + kd * 9 + warp) * C * F;
#pragma unroll
  for (int mc = 0; mc < MT; ++mc)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int c = c0 + mc * 16 + gid + hr * 8;
      if (c >= C) continue;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int f = f0 + ni * 8 + tig * 2;
        if (f < F) out[(int64_t)c * F + f] = acc[mc][ni][2 * hr];
        if (f + 1 < F) out[(int64_t)c * F + f + 1] = acc[mc][ni][2 * hr + 1];
      }
    }
}

// fp32: 144 threads = 9 taps x 4 channel quads x 4 output-channel quads of a
// 16 x 16 (c, f) block; one tile staged at a time.
__global__ void __launch_bounds__(144)
wgrad_f32_kernel(const float* __restrict__ x, const float* __restrict__ g, float* __restrict__ part,
                 int D, int H, int W, int C, int F, int S, int OD, int OH, int OW, int tiles_w,
                 int tiles_h, int64_t ntiles, int nsplit) {
  extern __shared__ __align__(16) float fsm[];
  const int TR = tile_rows(S), HR = (TR - 1) * S + 3, HC = (TW - 1) * S + 3;
  float* xs = fsm;               // [HR * HC][16]
  float* gs = fsm + HR * HC * 16;  // [TR * TW][16]

  const int tid = threadIdx.x;
  const int tap9 = tid / 16, cq = (tid / 4) % 4, fq = tid % 4;
  const int kh = tap9 / 3, kw = tap9 % 3;
  const int cblocks = (C + 15) / 16, fblocks = (F + 15) / 16;
  const int kd = blockIdx.y / (cblocks * fblocks);
  const int c0 = (blockIdx.y / fblocks) % cblocks * 16, f0 = blockIdx.y % fblocks * 16;
  const int64_t T0 = ntiles * blockIdx.x / nsplit, T1 = ntiles * (blockIdx.x + 1) / nsplit;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int64_t T = T0; T < T1; ++T) {
    const Tile tl(T, tiles_w, tiles_h, OD, TR);
    const int p = tl.od * S + kd - 1;
    const bool pin = p >= 0 && p < D;
    const int64_t xb = ((int64_t)tl.b * D + p) * H * W;
    const int64_t gb = ((int64_t)tl.b * OD + tl.od) * OH;
    __syncthreads();  // the previous tile's products are done
    for (int q = tid; q < HR * HC * 16; q += 144) {
      const int k = q % 16, v = q / 16;
      const int gh = tl.oh0 * S - 1 + v / HC, gw = tl.ow0 * S - 1 + v % HC, c = c0 + k;
      xs[q] = (pin && gh >= 0 && gh < H && gw >= 0 && gw < W && c < C)
                  ? x[(xb + (int64_t)gh * W + gw) * C + c] : 0.f;
    }
    for (int q = tid; q < TR * TW * 16; q += 144) {
      const int n = q % 16, i = q / 16;
      const int oh = tl.oh0 + i / TW, ow = tl.ow0 + i % TW, f = f0 + n;
      gs[q] = (oh < OH && ow < OW && f < F) ? g[((gb + oh) * OW + ow) * F + f] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < TR * TW; ++i) {
      const int v = ((i / TW) * S + kh) * HC + (i % TW) * S + kw;
      const float4 a = *reinterpret_cast<const float4*>(xs + v * 16 + cq * 4);
      const float4 b = *reinterpret_cast<const float4*>(gs + i * 16 + fq * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][e] = fmaf(av[u], bv[e], acc[u][e]);
    }
  }

  float* out = part + ((int64_t)blockIdx.x * 27 + kd * 9 + tap9) * C * F;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int c = c0 + cq * 4 + u;
    if (c >= C) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int f = f0 + fq * 4 + e;
      if (f < F) out[(int64_t)c * F + f] = acc[u][e];
    }
  }
}

constexpr int N1_ROWS = 4, N1_WARPS = 4;               // x tile rows; one warp a row
constexpr int N1_GR = N1_ROWS + 2, N1_GC = TW + 2;      // g values around the tile
constexpr int N1_GBYTES = (3 * N1_GR * N1_GC * 2 + 15) & ~15;

__global__ void __launch_bounds__(N1_WARPS * 32)
wgrad_n1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g, float* __restrict__ part,
                int D, int H, int W, int C, int tiles_w, int tiles_h, int64_t ntiles, int nsplit) {
  constexpr int NTH = N1_WARPS * 32, XCH = 4;  // 32 channels a block
  extern __shared__ __align__(128) unsigned char smem[];
  const int xbytes = N1_ROWS * TW * XCH * 16, slot_bytes = xbytes + N1_GBYTES;
  const unsigned sbase = tc::smem_addr(smem);
  const tc::Swizzle xsw(XCH, 1);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.y * 32;
  const int64_t T0 = ntiles * blockIdx.x / nsplit, T1 = ntiles * (blockIdx.x + 1) / nsplit;
  const int gid = lane >> 2, tig = lane & 3;
  // this thread's column of B in n8 tile ni is tap 8 ni + gid: the offset of
  // g[u - tap + 1] from g-tile position (row of u, column of u), or -1 past tap 26
  int goff[4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int tap = ni * 8 + gid;
    goff[ni] = tap < 27 ? ((2 - tap / 9) * N1_GR + 2 - (tap / 3) % 3) * N1_GC + 2 - tap % 3 : -1;
  }

  auto load = [&](int64_t T, int slot) {
    const Tile tl(T, tiles_w, tiles_h, D, N1_ROWS);
    const unsigned xs = sbase + slot * slot_bytes;
    const int64_t pb = ((int64_t)tl.b * D + tl.od) * H;
    for (int q = tid; q < N1_ROWS * TW * XCH; q += NTH) {
      const int k = q % XCH, v = q / XCH;
      const int h = tl.oh0 + v / TW, w = tl.ow0 + v % TW, c = c0 + k * 8;
      const bool ok = h < H && w < W && c < C;
      const bf16* src = ok ? x + ((pb + h) * W + w) * C + c : x;
      tc::cp_async16(xs + (v * XCH + (k ^ xsw(v))) * 16, src, ok);
    }
    bf16* gs = reinterpret_cast<bf16*>(smem + slot * slot_bytes + xbytes);
    for (int q = tid; q < 3 * N1_GR * N1_GC; q += NTH) {
      const int cc = q % N1_GC, rr = (q / N1_GC) % N1_GR, dd = q / (N1_GC * N1_GR);
      const int od = tl.od + dd - 1, oh = tl.oh0 + rr - 1, ow = tl.ow0 + cc - 1;
      gs[q] = (od >= 0 && od < D && oh >= 0 && oh < H && ow >= 0 && ow < W)
                  ? g[(((int64_t)tl.b * D + od) * H + oh) * W + ow] : __float2bfloat16(0.f);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (T0 < T1) load(T0, 0);
  tc::cp_async_commit();
  if (T0 + 1 < T1) load(T0 + 1, 1);
  tc::cp_async_commit();

  for (int64_t T = T0; T < T1; ++T) {
    const int i = (int)(T - T0);
    tc::cp_async_wait<1>();
    __syncthreads();  // tile T has landed; every warp is done with tile T - 1
    if (T + 2 < T1) load(T + 2, (i + 2) % 3);
    tc::cp_async_commit();

    const unsigned xs = sbase + (i % 3) * slot_bytes;
    const unsigned short* gs =
        reinterpret_cast<const unsigned short*>(smem + (i % 3) * slot_bytes + xbytes);
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // 16 input voxels of row `warp`: one k16 step
      unsigned bfr[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        // B[k][tap] = g[u_k - tap + 1], k = 2 tig, 2 tig + 1 (b0) and + 8 (b1)
        const int at = goff[ni] + warp * N1_GC + j * 16 + 2 * tig;
        unsigned b0 = 0, b1 = 0;
        if (goff[ni] >= 0) {
          b0 = gs[at] | ((unsigned)gs[at + 1] << 16);
          b1 = gs[at + 8] | ((unsigned)gs[at + 9] << 16);
        }
        bfr[ni][0] = b0;
        bfr[ni][1] = b1;
      }
      const int v = warp * TW + j * 16 + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
      for (int mc = 0; mc < 2; ++mc) {
        const int ch = mc * 2 + ((lane >> 3) & 1);
        unsigned a[4];
        tc::ldsm_x4_t(a, xs + (v * XCH + (ch ^ xsw(v))) * 16);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) tc::mma16816(acc[mc][ni], a, bfr[ni][0], bfr[ni][1]);
      }
    }
  }

  // one partial sum per warp: part[split * N1_WARPS + warp][tap][c]
  float* out = part + ((int64_t)blockIdx.x * N1_WARPS + warp) * 27 * C;
#pragma unroll
  for (int mc = 0; mc < 2; ++mc)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int c = c0 + mc * 16 + gid + hr * 8;
      if (c >= C) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int tap = ni * 8 + tig * 2;
        if (tap < 27) out[(int64_t)tap * C + c] = acc[mc][ni][2 * hr];
        if (tap + 1 < 27) out[(int64_t)(tap + 1) * C + c] = acc[mc][ni][2 * hr + 1];
      }
    }
}

constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may use
constexpr int NUM_SMS = 132;      // H100 SXM: the grids aim at a few blocks per SM

// Geometry of a launch: output tiles, and the split of the tiles over blocks
// that keeps the scratch under 64 MB.
struct Plan {
  int OD, OH, OW, tiles_w, tiles_h;
  int64_t ntiles;
  Plan(int B, int D, int H, int W, int S) {
    OD = (D - 1) / S + 1;
    OH = (H - 1) / S + 1;
    OW = (W - 1) / S + 1;
    tiles_w = (OW + TW - 1) / TW;
    tiles_h = (OH + tile_rows(S) - 1) / tile_rows(S);
    ntiles = (int64_t)B * OD * tiles_w * tiles_h;
  }
};

template <int CB, int FB>
int launch_tc_cfg(const void* x, const void* g, float* part, int nsplit, const Plan& P, int D,
                  int H, int W, int C, int F, int S, cudaStream_t st) {
  const int TR = tile_rows(S), HR = (TR - 1) * S + 3, HC = (TW - 1) * S + 3;
  const int smem = 3 * (HR * HC * CB * 2 + TR * TW * FB * 2);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kern = wgrad_tc_kernel<CB, FB>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(nsplit, 3 * ((C + CB - 1) / CB) * ((F + FB - 1) / FB));
  kern<<<grid, 288, smem, st>>>(static_cast<const bf16*>(x), static_cast<const bf16*>(g), part,
                                D, H, W, C, F, S, P.OD, P.OH, P.OW, P.tiles_w, P.tiles_h,
                                P.ntiles, nsplit);
  return (int)cudaGetLastError();
}

template <int CB>
int launch_tc_fb(const void* x, const void* g, float* part, int nsplit, const Plan& P, int D,
                 int H, int W, int C, int F, int S, cudaStream_t st) {
  if (F <= 8) return launch_tc_cfg<CB, 8>(x, g, part, nsplit, P, D, H, W, C, F, S, st);
  if (F <= 32) return launch_tc_cfg<CB, 32>(x, g, part, nsplit, P, D, H, W, C, F, S, st);
  return launch_tc_cfg<CB, 64>(x, g, part, nsplit, P, D, H, W, C, F, S, st);
}

}  // namespace

// The number of voxel splits (the leading extent of the scratch) that a
// launch with these shapes uses: about four blocks per SM, no more splits
// than tiles, and at most 64 MB of fp32 partial sums.
extern "C" int conv3d_wgrad_splits(int B, int D, int H, int W, int C, int F, int stride,
                                   int dtype) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0 || (stride != 1 && stride != 2))
    return 0;
  if (dtype == 1 && F == 1 && stride == 1) {  // wgrad_n1_kernel: a partial per warp
    const int64_t ntiles = (int64_t)B * D * ((H + N1_ROWS - 1) / N1_ROWS) * ((W + TW - 1) / TW);
    const int64_t cb = (C + 31) / 32;
    int64_t n = std::min<int64_t>((8 * NUM_SMS + cb - 1) / cb, ntiles);
    n = std::min<int64_t>(n, std::max<int64_t>(1, (64LL << 20) / (27LL * C * 4 * N1_WARPS)));
    return (int)std::max<int64_t>(std::min<int64_t>(n, 65535), 1) * N1_WARPS;
  }
  const Plan P(B, D, H, W, stride);
  const int fb = dtype == 1 ? (F <= 8 ? 8 : F <= 32 ? 32 : 64) : 16;
  const int cb = dtype == 1 ? (C <= 16 ? 16 : C >= 64 && fb == 32 ? 64 : 32) : 16;
  const int64_t base = 3LL * ((C + cb - 1) / cb) * ((F + fb - 1) / fb);
  int64_t n = (4 * NUM_SMS + base - 1) / base;
  n = std::min<int64_t>(n, P.ntiles);
  n = std::min<int64_t>(n, std::max<int64_t>(1, (64LL << 20) / (27LL * C * F * 4)));
  n = std::min<int64_t>(n, 65535);
  return (int)std::max<int64_t>(n, 1);
}

// x [B,D,H,W,C], g [B,OD,OH,OW,F] (dtype 0 = float32, 1 = bfloat16; bf16
// takes C % 8 == 0), part [nsplit][27][C][F] float32 with nsplit from
// conv3d_wgrad_splits (the partial sums of voxel splits, and for
// wgrad_n1_kernel of their warps).  Returns a cudaError_t (0 = launched).
extern "C" int conv3d_wgrad(const void* x, const void* g, void* part, int nsplit, int B, int D,
                            int H, int W, int C, int F, int stride, int dtype, void* stream) {
  if (nsplit != conv3d_wgrad_splits(B, D, H, W, C, F, stride, dtype) || nsplit <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan P(B, D, H, W, stride);
  float* pp = static_cast<float*>(part);
  if (dtype == 0) {
    const int TR = tile_rows(stride), HR = (TR - 1) * stride + 3, HC = (TW - 1) * stride + 3;
    const int smem = (HR * HC + TR * TW) * 16 * 4;
    cudaError_t e = cudaFuncSetAttribute(wgrad_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(nsplit, 3 * ((C + 15) / 16) * ((F + 15) / 16));
    wgrad_f32_kernel<<<grid, 144, smem, st>>>(static_cast<const float*>(x),
                                               static_cast<const float*>(g), pp, D, H, W, C, F,
                                               stride, P.OD, P.OH, P.OW, P.tiles_w, P.tiles_h,
                                               P.ntiles, nsplit);
    return (int)cudaGetLastError();
  }
  if (dtype == 1 && C % 8 == 0 && F == 1 && stride == 1) {
    const int smem = 3 * (N1_ROWS * TW * 64 + N1_GBYTES);
    cudaError_t e = cudaFuncSetAttribute(wgrad_n1_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + N1_ROWS - 1) / N1_ROWS;
    const int nb = nsplit / N1_WARPS;
    dim3 grid(nb, (C + 31) / 32);
    wgrad_n1_kernel<<<grid, N1_WARPS * 32, smem, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(g), pp, D, H, W, C, tiles_w,
        tiles_h, (int64_t)B * D * tiles_w * tiles_h, nb);
    return (int)cudaGetLastError();
  }
  if (dtype == 1 && C % 8 == 0) {
    if (C <= 16)
      return launch_tc_fb<16>(x, g, pp, nsplit, P, D, H, W, C, F, stride, st);
    if (C >= 64 && F > 8 && F <= 32)  // 16 mma per 6 ldmatrix, as (32, 64) has
      return launch_tc_cfg<64, 32>(x, g, pp, nsplit, P, D, H, W, C, F, stride, st);
    return launch_tc_fb<32>(x, g, pp, nsplit, P, D, H, W, C, F, stride, st);
  }
  return (int)cudaErrorInvalidValue;
}
