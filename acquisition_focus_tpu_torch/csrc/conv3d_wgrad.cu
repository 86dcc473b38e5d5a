// K4 — weight gradient of the 3x3x3 stride-1 SAME (zero-padded) conv:
//   dw[co, ci, kd, kh, kw] = sum over b, d, h, w of
//                            x[b, ci, d+kd-1, h+kh-1, w+kw-1] * g[b, co, d, h, w].
//
// Replaces acquisition_focus_tpu/ops/pallas/conv3d.py: conv3d_wgrad_pallas
// (_wgrad_kernel), the weight gradient of the decoder's full-resolution convs
// under use_pallas_conv3d 'wg' and 'full'.
//
// What bounds it on the H100: arithmetic, as for K3's forward. At the decoder's
// full-resolution level (2 x 96 x 128^3 input, 48 output channels) it is the
// same ~1.04 TFLOP as the forward, but the contraction runs over the
// B*D*H*W ~ 4.2 M voxels and the result is small (27 x 96 x 48 ~ 124 k
// floats). The Pallas kernel carries the whole (27, Ci, Co) sum across its
// sequential grid; blocks on the card run unordered, so the sum is split.
//
// Design (bf16, the main path): per tap a GEMM with M = input channels, N =
// output channels and K = voxels. TMA starts a box only at a 16-byte multiple
// of the innermost dimension, so it cannot shift NCDHW by one voxel along w;
// the launch first stages the input channels-last (hopper.cuh, channels_last),
// where w is an outer axis. A block owns one (dz, dy) tap pair and all three dx
// taps of it, 64 or 128 input channels (one or two consumer warpgroups of 64)
// and up to 64 output channels, over a chunk of consecutive (b, d, h) rows. Per
// K step of 64 voxels along w one producer thread issues two TMA loads into a
// ring stage: the cotangent tile [co][w] (NCDHW, K-major, 128-byte swizzle) and
// the input tile [channel group][66 w][8 channels] at (w0 - 1, h + dy, d + dz),
// loaded without swizzle, so each 16-byte row is one voxel and the three dx
// taps are the same tile at descriptor offsets of 0, 16 and 32 bytes (M-major,
// read transposed). TMA's zero fill outside the tensor is the SAME padding along
// w and the ragged channel edge; rows whose shifted row leaves the volume are
// skipped. Each consumer warpgroup issues 12 wgmma m64nNk16 per stage (4 k16 x
// 3 taps) into f32 accumulators in registers (3 x N/2 a thread: 72 at N = 48);
// each cotangent tile feeds three taps. A ring of full/empty mbarriers overlaps
// the loads with the products. Padding waste: Ci 96 takes 128 rows (32 idle),
// Ci 48 takes 64 (16 idle).
//
// The float32 variant (scalar FMA, no TF32, one shared-memory stage) is the
// first version of this kernel; it is off the main path.
//
// Reduction: each block writes its partial sums to its own slot of a
// workspace (chunk, 27, Ci', Co'); a second kernel sums the chunks in a fixed
// order into dw (Co, Ci, 3, 3, 3). No atomics, so the result is the same bits
// from run to run.

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMT = 48;              // input channels per block (3 warps x 16)
constexpr int kThreads = 96;
constexpr int kTargetBlocks = 1056;  // 8 blocks per SM on 132 SMs

struct Tiling {
  int nf, n_ci_tiles, n_co_tiles, cip, cop, n_chunks, rows_per_chunk;
};

Tiling tiling(int B, int Ci, int Co, int D, int H) {
  Tiling t;
  t.nf = Co > 48 ? 4 : (Co + 15) / 16;
  t.n_ci_tiles = (Ci + kMT - 1) / kMT;
  t.n_co_tiles = (Co + 16 * t.nf - 1) / (16 * t.nf);
  t.cip = t.n_ci_tiles * kMT;
  t.cop = t.n_co_tiles * 16 * t.nf;
  const int rows = B * D * H;
  const int per_chunk_blocks = 9 * t.n_ci_tiles * t.n_co_tiles;
  int n = (kTargetBlocks + per_chunk_blocks - 1) / per_chunk_blocks;
  n = n < 1 ? 1 : (n > rows ? rows : n);
  t.rows_per_chunk = (rows + n - 1) / n;
  t.n_chunks = (rows + t.rows_per_chunk - 1) / t.rows_per_chunk;
  return t;
}

// Stage one row step: the input row of tap pair (dz, dy) at w0-1 .. w0+KT into
// As[s][cl][m] = x[ci0+cl, w0 + m + s - 1] (s = dx + 1), and the cotangent
// tile into Bs[nl][m] = g[co0+nl, w0 + m]. xrow/grow point at channel 0 of
// the row; channels are DHW apart.
template <typename T, int KT, int TN, int LDA, int LDB>
__device__ __forceinline__ void stage_row(const T* __restrict__ xrow,
                                          const T* __restrict__ grow, T* As, T* Bs,
                                          int ci0, int co0, int Ci, int Co, long long DHW,
                                          int w0, int W) {
  const T zero = afk::from_f<T>(0.0f);
  for (int e = threadIdx.x; e < kMT * (KT + 2); e += kThreads) {
    const int cl = e / (KT + 2), p = e % (KT + 2) - 1;
    const int ci = ci0 + cl, wi = w0 + p;
    const T v = (ci < Ci && wi >= 0 && wi < W) ? xrow[ci * DHW + wi] : zero;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int m = p - (s - 1);
      if (m >= 0 && m < KT) As[(s * kMT + cl) * LDA + m] = v;
    }
  }
  for (int e = threadIdx.x; e < TN * KT; e += kThreads) {
    const int nl = e / KT, m = e % KT;
    const int co = co0 + nl, wi = w0 + m;
    Bs[nl * LDB + m] = (co < Co && wi < W) ? grow[co * DHW + wi] : zero;
  }
}

// The block's coordinates: tap pair, channel tiles, row range.
struct Block {
  int dz, dy, ci0, co0, r0, r1;
};

__device__ __forceinline__ Block block_coords(int n_ci_tiles, int tn, int rows,
                                              int rows_per_chunk) {
  Block k;
  k.dz = (int)blockIdx.y / 3 - 1;
  k.dy = (int)blockIdx.y % 3 - 1;
  k.ci0 = ((int)blockIdx.z % n_ci_tiles) * kMT;
  k.co0 = ((int)blockIdx.z / n_ci_tiles) * tn;
  k.r0 = (int)blockIdx.x * rows_per_chunk;
  k.r1 = min(rows, k.r0 + rows_per_chunk);
  return k;
}

// Row r = (b, d, h): pointers to channel 0 of the shifted input row and of the
// cotangent row, or false when the shifted row lies outside the volume.
template <typename T>
__device__ __forceinline__ bool row_ptrs(const T* x, const T* g, int r, const Block& k,
                                         int Ci, int Co, int D, int H, int W,
                                         const T** xrow, const T** grow) {
  const int h = r % H, d = (r / H) % D, b = r / (H * D);
  const int zi = d + k.dz, yi = h + k.dy;
  if (zi < 0 || zi >= D || yi < 0 || yi >= H) return false;
  const long long HW = (long long)H * W, DHW = (long long)D * HW;
  *xrow = x + (long long)b * Ci * DHW + zi * HW + (long long)yi * W;
  *grow = g + (long long)b * Co * DHW + d * HW + (long long)h * W;
  return true;
}

template <int NF>
__global__ void __launch_bounds__(kThreads)
wgrad_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                 float* __restrict__ part, int B, int Ci, int Co, int D, int H, int W,
                 int rows_per_chunk, int n_ci_tiles, int cip, int cop) {
  constexpr int KT = 32, TN = 16 * NF, LDA = KT + 1, LDB = KT + 1;
  constexpr int NJ = TN / 2;         // output channels per thread
  __shared__ float As[3 * kMT * LDA];
  __shared__ float Bs[TN * LDB];

  const Block k = block_coords(n_ci_tiles, TN, B * D * H, rows_per_chunk);
  const int cl = threadIdx.x % kMT, nh = threadIdx.x / kMT;
  const long long DHW = (long long)D * H * W;

  float acc[3][NJ];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[s][j] = 0.0f;

  for (int r = k.r0; r < k.r1; ++r) {
    const float *xrow, *grow;
    if (!row_ptrs(x, g, r, k, Ci, Co, D, H, W, &xrow, &grow)) continue;  // block-uniform
    for (int w0 = 0; w0 < W; w0 += KT) {
      stage_row<float, KT, TN, LDA, LDB>(xrow, grow, As, Bs, k.ci0, k.co0, Ci, Co, DHW, w0,
                                         W);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KT; ++kk) {
        const float a0 = As[(0 * kMT + cl) * LDA + kk];
        const float a1 = As[(1 * kMT + cl) * LDA + kk];
        const float a2 = As[(2 * kMT + cl) * LDA + kk];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float b = Bs[(nh + 2 * j) * LDB + kk];
          acc[0][j] = fmaf(a0, b, acc[0][j]);
          acc[1][j] = fmaf(a1, b, acc[1][j]);
          acc[2][j] = fmaf(a2, b, acc[2][j]);
        }
      }
      __syncthreads();
    }
  }

  const int chunk = blockIdx.x, tap0 = blockIdx.y * 3;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    float* dst = part + (((long long)chunk * 27 + tap0 + s) * cip + k.ci0 + cl) * cop + k.co0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dst[nh + 2 * j] = acc[s][j];
  }
}

// dw[co, ci, tap] = sum over chunks, in chunk order, of part[chunk, tap, ci, co].
__global__ void wgrad_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                    int n_chunks, int Ci, int Co, int cip, int cop) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 27LL * Ci * Co) return;
  const int co = (int)(i % Co), ci = (int)((i / Co) % Ci), tap = (int)(i / ((long long)Co * Ci));
  const long long stride = 27LL * cip * cop;
  const float* p = part + ((long long)tap * cip + ci) * cop + co;
  float s = 0.0f;
  for (int c = 0; c < n_chunks; ++c) s += p[c * stride];
  dw[((long long)co * Ci + ci) * 27 + tap] = s;
}

// ------------------------------------------------------------------ bf16: TMA + wgmma

constexpr int kKT = 64;                  // voxels per K step
constexpr int kRows = kKT + 2;           // input voxels per step: the dx halo on each side
constexpr int kXGroup = kRows * 16;      // bytes of one 8-channel group of the input tile

struct Plan {
  int nwg, nt, n_ci_tiles, n_co_tiles, cip, cop, n_chunks, rows_per_chunk, stages, smem;
};

// bytes of a stage's input area (NWG x 8 channel groups), rounded up to the
// cotangent tile's 1024-byte alignment, and of a whole stage
inline int x_area(int nwg) { return (nwg * 8 * kXGroup + 1023) / 1024 * 1024; }
inline int stage_bytes(int nwg, int nt) { return x_area(nwg) + nt * kKT * 2; }

// One or two consumer warpgroups (64 input channels each), N = 16/32/48/64
// output channels, and enough row chunks for ~4 waves of blocks.
Plan plan_bf16(int B, int Ci, int Co, int D, int H) {
  Plan p;
  p.nwg = Ci > 64 ? 2 : 1;
  const int mt = 64 * p.nwg;
  p.nt = Co > 48 ? 64 : Co > 32 ? 48 : Co > 16 ? 32 : 16;
  p.n_ci_tiles = (Ci + mt - 1) / mt;
  p.n_co_tiles = (Co + p.nt - 1) / p.nt;
  p.cip = p.n_ci_tiles * mt;
  p.cop = p.n_co_tiles * p.nt;
  const int blocks_per_sm = 3 - p.nwg;   // two blocks of one consumer warpgroup, or one of two
  const int budget = 227 * 1024 / blocks_per_sm - 2048;
  const int sb = stage_bytes(p.nwg, p.nt);
  p.stages = budget / sb < 6 ? budget / sb : 6;
  p.smem = p.stages * sb + 1024 + 2 * 8 * p.stages;
  const int rows = B * D * H;
  const int per_chunk_blocks = 9 * p.n_ci_tiles * p.n_co_tiles;
  const int target = 4 * blocks_per_sm * afk::hopper::num_sms();
  int n = (target + per_chunk_blocks - 1) / per_chunk_blocks;
  n = n < 1 ? 1 : (n > rows ? rows : n);
  p.rows_per_chunk = (rows + n - 1) / n;
  p.n_chunks = (rows + p.rows_per_chunk - 1) / p.rows_per_chunk;
  return p;
}

// Block (tap pair (dz, dy) = blockIdx.x, row chunk blockIdx.y, channel tiles
// blockIdx.z). Warps 0 .. 4 NWG - 1 are the consumer warpgroups, warp 4 NWG
// the producer. A K step is 64 voxels of one row: the input tile [8 NWG
// channel groups][66 w][8] from the channels-last copy at w0 - 1 (no swizzle:
// 16-byte rows, so the dx tap is a 16-byte offset of the wgmma descriptor) and
// the cotangent tile [NT co][64 w] (NCDHW, 128-byte swizzle). Rows whose
// shifted row leaves the volume are skipped (the map folds D and B into one
// axis); w outside the volume arrives as zeros.
template <int NWG, int NT>
__global__ void __launch_bounds__(NWG * 128 + 32, 3 - NWG)
wgrad_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap gmap, float* __restrict__ part, int D,
                 int H, int W, int rows, int rows_per_chunk, int n_ci_tiles, int cip, int cop,
                 int stages, int x_area_bytes) {
  using namespace afk::hopper;
  constexpr int MT = 64 * NWG;
  constexpr int XB = NWG * 8 * kXGroup, GT = NT * kKT * 2;
  const int STAGE = x_area_bytes + GT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint64_t* full = (uint64_t*)(smem + stages * STAGE);
  uint64_t* empty = full + stages;

  const int dz = (int)blockIdx.x / 3 - 1, dy = (int)blockIdx.x % 3 - 1;
  const int ci0 = ((int)blockIdx.z % n_ci_tiles) * MT;
  const int co0 = ((int)blockIdx.z / n_ci_tiles) * NT;
  const int r0 = (int)blockIdx.y * rows_per_chunk;
  const int r1 = min(rows, r0 + rows_per_chunk);
  const int n_w = (W + kKT - 1) / kKT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == NWG * 4) {
    // producer: one thread keeps the ring full
    if (lane != 0) return;
    tma_prefetch_map(&xmap);
    tma_prefetch_map(&gmap);
    int it = 0;
    for (int r = r0; r < r1; ++r) {
      const int h = r % H, d = (r / H) % D, b = r / (H * D);
      if (h + dy < 0 || h + dy >= H || d + dz < 0 || d + dz >= D) continue;
      for (int w0 = 0; w0 < W; w0 += kKT, ++it) {
        const int s = it % stages;
        mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
        uint8_t* st = smem + s * STAGE;
        mbar_arrive_expect_tx(&full[s], XB + GT);
        tma_load_5d(st, &xmap, &full[s], 0, w0 - 1, ci0 / 8, h + dy, b * D + d + dz);
        tma_load_5d(st + x_area_bytes, &gmap, &full[s], w0, h, d, co0, b);
      }
    }
  } else {
    // consumers: warpgroup wg multiplies input channels wg*64 .. wg*64+63
    const int wg = warp / 4;
    float acc[3][NT / 2];
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[t][i] = 0.0f;
    int it = 0;
    for (int r = r0; r < r1; ++r) {
      const int h = r % H, d = (r / H) % D;
      if (h + dy < 0 || h + dy >= H || d + dz < 0 || d + dz >= D) continue;
      for (int w0 = 0; w0 < W; w0 += kKT, ++it) {
        const int s = it % stages;
        mbar_wait(&full[s], (it / stages) & 1);
        const uint8_t* sx = smem + s * STAGE + wg * 8 * kXGroup;
        const uint8_t* sg = smem + s * STAGE + x_area_bytes;
        // A [64 ci][k = w] M-major, no swizzle: the k16 step is 16 rows of 16 bytes,
        // dx one row; 8-row groups 128 bytes apart (LBO), 8-channel groups kXGroup
        // apart (SBO). B [NT co][64 w] K-major, 128-byte swizzle: k16 steps 32
        // bytes. Offsets are added to the descriptors' address field (16-byte units).
        const uint64_t a0 = smem_desc(sx, 128, kXGroup, 0), b0 = smem_desc(sg, 16, 1024, 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKT / 16; ++kk)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            wgmma<NT, 1>(acc[dx], a0 + dx + kk * 16, b0 + kk * 2);
        wgmma_commit();
        // the products of step it-1 are done: hand its stage back
        wgmma_wait<1>();
        if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % stages]);
      }
    }
    wgmma_wait<0>();

    const int row = ci0 + wg * 64 + (warp % 4) * 16 + lane / 4;
    const int col = co0 + 2 * (lane % 4);
    const int tap0 = (int)blockIdx.x * 3;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      float* dst = part + (((long long)blockIdx.y * 27 + tap0 + dx) * cip + row) * cop + col;
#pragma unroll
      for (int j = 0; j < NT / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *(float2*)(dst + (long long)8 * i * cop + 8 * j) =
              make_float2(acc[dx][4 * j + 2 * i], acc[dx][4 * j + 2 * i + 1]);
    }
  }
}

template <int NWG, int NT>
int launch_bf16(const CUtensorMap& xm, const CUtensorMap& gm, float* part, int B, int D,
                int H, int W, const Plan& p, cudaStream_t st) {
  auto kernel = wgrad_tma_kernel<NWG, NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(9, p.n_chunks, p.n_ci_tiles * p.n_co_tiles);
  kernel<<<grid, NWG * 128 + 32, p.smem, st>>>(xm, gm, part, D, H, W, B * D * H,
                                               p.rows_per_chunk, p.n_ci_tiles, p.cip, p.cop,
                                               p.stages, x_area(NWG));
  return (int)cudaGetLastError();
}

template <int NWG>
int launch_bf16_nt(const CUtensorMap& xm, const CUtensorMap& gm, float* part, int B, int D,
                   int H, int W, const Plan& p, cudaStream_t st) {
  switch (p.nt) {
    case 16: return launch_bf16<NWG, 16>(xm, gm, part, B, D, H, W, p, st);
    case 32: return launch_bf16<NWG, 32>(xm, gm, part, B, D, H, W, p, st);
    case 48: return launch_bf16<NWG, 48>(xm, gm, part, B, D, H, W, p, st);
    default: return launch_bf16<NWG, 64>(xm, gm, part, B, D, H, W, p, st);
  }
}

int wgrad_bf16(const void* x, const void* g, void* xcl, float* part, int B, int Ci, int Co,
               int D, int H, int W, cudaStream_t st) {
  const Plan p = plan_bf16(B, Ci, Co, D, H);
  const int ci8 = (Ci + 7) / 8 * 8;
  int err = afk::hopper::channels_last(x, xcl, B, Ci, ci8, (long long)D * H * W, st);
  if (err) return err;
  CUtensorMap xm, gm;
  // xcl (B, D, H, W, ci8) walked as (8 channels, w, channel group, h, b*D + d)
  const long long xdims[5] = {8, W, ci8 / 8, H, (long long)B * D};
  const long long xstrides[4] = {2LL * ci8, 16, 2LL * W * ci8, 2LL * H * W * ci8};
  const int xbox[5] = {8, kRows, 8 * p.nwg, 1, 1};
  const long long gdims[5] = {W, H, D, Co, B};
  const int gbox[5] = {kKT, 1, 1, p.nt, 1};
  err = afk::hopper::encode_bf16_map(&xm, xcl, 5, xdims, xstrides, xbox,
                                     CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  err = afk::hopper::encode_bf16_map(&gm, g, 5, gdims, nullptr, gbox,
                                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  return p.nwg == 2 ? launch_bf16_nt<2>(xm, gm, part, B, D, H, W, p, st)
                    : launch_bf16_nt<1>(xm, gm, part, B, D, H, W, p, st);
}

template <int NF>
void launch_f32(const void* x, const void* g, float* part, int B, int Ci, int Co, int D,
                int H, int W, const Tiling& t, cudaStream_t st) {
  const dim3 grid(t.n_chunks, 9, t.n_ci_tiles * t.n_co_tiles);
  wgrad_f32_kernel<NF><<<grid, kThreads, 0, st>>>(
      (const float*)x, (const float*)g, part, B, Ci, Co, D, H, W, t.rows_per_chunk,
      t.n_ci_tiles, t.cip, t.cop);
}

// (chunks, padded Ci, padded Co) of the workspace for these shapes and dtype
void workspace_dims(int B, int Ci, int Co, int D, int H, int is_bf16, int* n_chunks, int* cip,
                    int* cop) {
  if (is_bf16) {
    const Plan p = plan_bf16(B, Ci, Co, D, H);
    *n_chunks = p.n_chunks, *cip = p.cip, *cop = p.cop;
  } else {
    const Tiling t = tiling(B, Ci, Co, D, H);
    *n_chunks = t.n_chunks, *cip = t.cip, *cop = t.cop;
  }
}

}  // namespace

// Workspace of afk_conv3d_wgrad for these shapes and dtype: out[0] chunks,
// out[1] floats per chunk; the caller allocates out[0] * out[1] floats.
extern "C" int afk_conv3d_wgrad_workspace(int B, int Ci, int Co, int D, int H, int is_bf16,
                                          int* out) {
  int cip, cop;
  workspace_dims(B, Ci, Co, D, H, is_bf16, &out[0], &cip, &cop);
  out[1] = 27 * cip * cop;
  return 0;
}

// x (B, Ci, D, H, W) and g (B, Co, D, H, W), one dtype, float32 (is_bf16 = 0)
// or bfloat16 (is_bf16 = 1; W a multiple of 8 and 16-byte aligned bases, for
// TMA), contiguous; xcl: bf16 scratch of B * D*H*W * Ci8 elements (Ci rounded
// up to 8) for the channels-last input, unused for float32; part: the
// workspace above (f32); dw (Co, Ci, 3, 3, 3) float32.
extern "C" int afk_conv3d_wgrad(const void* x, const void* g, void* xcl, float* part, float* dw,
                                int B, int Ci, int Co, int D, int H, int W, int is_bf16,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    const int err = wgrad_bf16(x, g, xcl, part, B, Ci, Co, D, H, W, st);
    if (err) return err;
  } else {
    const Tiling t = tiling(B, Ci, Co, D, H);
    switch (t.nf) {
      case 1: launch_f32<1>(x, g, part, B, Ci, Co, D, H, W, t, st); break;
      case 2: launch_f32<2>(x, g, part, B, Ci, Co, D, H, W, t, st); break;
      case 3: launch_f32<3>(x, g, part, B, Ci, Co, D, H, W, t, st); break;
      default: launch_f32<4>(x, g, part, B, Ci, Co, D, H, W, t, st); break;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  int n_chunks, cip, cop;
  workspace_dims(B, Ci, Co, D, H, is_bf16, &n_chunks, &cip, &cop);
  const long long n = 27LL * Ci * Co;
  wgrad_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, dw, n_chunks, Ci, Co,
                                                                  cip, cop);
  return (int)cudaGetLastError();
}
