// K3 — 3x3x3 stride-1 SAME (zero-padded) 3D convolution, forward.
//
// Replaces acquisition_focus_tpu/ops/pallas/conv3d.py: conv3d_pallas
// (_kernel), the forward of the decoder's full-resolution convs, and, on the
// spatially flipped, IO-swapped weights, their input gradient under 'dx' and
// 'full' (ops/kernels/conv3d.py).
//
// What bounds it on the H100: arithmetic. At the decoder's full-resolution
// level (2 x 96 x 128^3 -> 48) the conv is ~1 TFLOP against ~1.2 GB of
// activations, well above the card's ~295 FLOP/byte bf16 ridge, so the
// tensor cores must do the products.
//
// Design (bf16, the main path: forward, and the input gradient under 'dx' and
// 'full'): implicit GEMM with M = output voxels (two rows along h of 128 voxels
// along w, one consumer warpgroup a row, two m64 halves each), N = output
// channels (48 forward, 96 as the input gradient of the first conv) and K = 27
// taps x input channels. TMA starts a box only at a 16-byte multiple of the
// innermost dimension, so it cannot shift NCDHW by one voxel along w: the
// launch first stages the input channels-last (hopper.cuh, channels_last, one
// pass over x), where w is an outer axis. A K step is one (dz, dy) tap pair and
// 32 input channels; one producer thread issues two TMA loads into a ring
// stage: the input rows (h0 + dy, h0 + dy + 1) of slice d + dz at w0 - 1 .. w0
// + 128 as [row][channel group][130 w][8 channels], without swizzle, so each
// 16-byte row is one voxel and the three dx taps are the same tile at
// descriptor offsets of 0, 16 and 32 bytes; and the three dx taps' weight tiles
// [N co][32 ci] (64-byte swizzle) from the wrapper's K-major (27, Co, Ci8) copy
// of the weights. Both operands are K-major. TMA's zero fill is the SAME
// padding along w and h and the ragged channel edge; tap pairs whose slice
// leaves the volume are skipped. Each consumer warpgroup issues 12 wgmma
// m64nNk16 per step into f32 accumulators. Blocks are persistent and walk over
// row pairs, so the ring keeps loading the next tile while the consumers store
// the last. The bias is added in f32 before the single rounding to bf16; stores
// go straight from the accumulators to NCDHW, 16 bytes per 8 voxels along w.
// The channels-last copy is read from L2 about 4.5 times (each input row by
// the three output row pairs whose dy taps reach it, with the halo), the
// weights once per output row pair.
//
// The float32 variant (same tiling as the first version: one shared-memory
// stage, scalar FMA, no TF32) serves f32 callers exactly; it is off the main
// path.

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kTM = 64;           // output voxels per block (along w)
constexpr int kTK = 16;           // input channels per contraction step
constexpr int kThreads = 128;     // 4 warps x 16 voxels
constexpr int kLDA = kTM + 8;     // As[k][m]: A (m x k) stored column-major

struct Tile {
  int b, d, h, w0, n0;
};

__device__ __forceinline__ Tile block_tile(int D, int H, int n_wtiles, int tn) {
  Tile t;
  long long blk = blockIdx.x;
  t.w0 = (int)(blk % n_wtiles) * kTM;
  blk /= n_wtiles;
  t.h = (int)(blk % H);
  blk /= H;
  t.d = (int)(blk % D);
  t.b = (int)(blk / D);
  t.n0 = blockIdx.y * tn;
  return t;
}

// Stage the (kTK x kTM) input tile of tap (dz, dy, dx), channels k0.., and the
// (kTK x TN) weight tile. wt is (27, Ci, Co).
template <typename T, int TN, int LDB>
__device__ __forceinline__ void stage_tiles(const T* __restrict__ xb,
                                            const T* __restrict__ wt, T* As, T* Bs,
                                            const Tile& t, int tap, int k0, int Ci,
                                            int Co, int D, int H, int W) {
  const int dz = tap / 9 - 1, dy = (tap / 3) % 3 - 1, dx = tap % 3 - 1;
  const int zi = t.d + dz, yi = t.h + dy;
  const bool row_ok = zi >= 0 && zi < D && yi >= 0 && yi < H;
  const long long HW = (long long)H * W, DHW = (long long)D * HW;
  const T zero = afk::from_f<T>(0.0f);
  for (int e = threadIdx.x; e < kTK * kTM; e += kThreads) {
    const int kk = e / kTM, m = e % kTM;
    const int ci = k0 + kk, wi = t.w0 + m + dx;
    T v = zero;
    if (row_ok && ci < Ci && wi >= 0 && wi < W)
      v = xb[ci * DHW + zi * HW + (long long)yi * W + wi];
    As[kk * kLDA + m] = v;
  }
  for (int e = threadIdx.x; e < kTK * TN; e += kThreads) {
    const int kk = e / TN, nn = e % TN;
    const int ci = k0 + kk, co = t.n0 + nn;
    Bs[kk * LDB + nn] = (ci < Ci && co < Co) ? wt[((long long)tap * Ci + ci) * Co + co] : zero;
  }
}

template <int NF>
__global__ void __launch_bounds__(kThreads)
conv3d_f32_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                  const float* __restrict__ bias, float* __restrict__ out, int Ci, int Co,
                  int D, int H, int W, int n_wtiles) {
  constexpr int TN = 16 * NF;
  constexpr int LDB = TN;
  constexpr int NJ = TN / 2;        // output channels per thread
  __shared__ float As[kTK * kLDA];
  __shared__ float Bs[kTK * LDB];

  const Tile t = block_tile(D, H, n_wtiles, TN);
  const int m = threadIdx.x % kTM, col0 = threadIdx.x / kTM;
  const long long DHW = (long long)D * H * W;
  const float* xb = x + (long long)t.b * Ci * DHW;

  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.0f;

  for (int tap = 0; tap < 27; ++tap) {
    for (int k0 = 0; k0 < Ci; k0 += kTK) {
      stage_tiles<float, TN, LDB>(xb, wt, As, Bs, t, tap, k0, Ci, Co, D, H, W);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTK; ++kk) {
        const float a = As[kk * kLDA + m];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[j] = fmaf(a, Bs[kk * LDB + col0 + 2 * j], acc[j]);
      }
      __syncthreads();
    }
  }

  const long long HW = (long long)H * W;
  const int wi = t.w0 + m;
  if (wi >= W) return;
  float* ob = out + (long long)t.b * Co * DHW + t.d * HW + (long long)t.h * W + wi;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int co = t.n0 + col0 + 2 * j;
    if (co < Co) ob[co * DHW] = acc[j] + bias[co];
  }
}

// ------------------------------------------------------------------ bf16: TMA + wgmma

constexpr int kKC = 32;                  // input channels per K step
constexpr int kRows = 130;               // input voxels per row tile: 128 + the dx halo
constexpr int kXRow = kRows * 16;        // bytes of one 8-channel group of a row tile
constexpr int kXBytes = 2 * 4 * kXRow;   // x tile: 2 rows x 4 channel groups
constexpr int kXArea = 17 * 1024;        // kXBytes rounded up to the weight tiles' alignment

template <int NT>
__host__ __device__ constexpr int stage_bytes() { return kXArea + 3 * NT * kKC * 2; }

// A persistent loop over tiles t = ((b, d, h pair, w block), co tile), co tile
// fastest, so the blocks that share input rows run together. Warps 0-7: two
// consumer warpgroups, warpgroup g computes output row h0 + g, as two m64 halves
// of the 128-voxel w block; warp 8: the producer. A K step is one (dz, dy) tap
// pair and 32 input channels: the x tile [2 rows][4 channel groups][130 w][8]
// (no swizzle: 16-byte rows, so the dx tap is a 16-byte offset of the wgmma
// descriptor) and the weight tiles of the three dx taps [3][NT co][32 ci]
// (64-byte swizzle). Each warpgroup issues 3 dx x 2 halves x 2 k16 wgmma per
// step. Tap pairs whose d + dz leaves the volume are skipped (the map folds D
// and B into one axis); h + dy outside the volume arrives as zeros.
template <int NT>
__global__ void __launch_bounds__(288, NT <= 48 ? 2 : 1)
conv3d_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap, const float* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, int Co, int D, int H, int W, int ci_pad,
                  int n_wtiles, int n_co_tiles, int n_tiles, int stages) {
  using namespace afk::hopper;
  constexpr int WT = NT * kKC * 2, STAGE = stage_bytes<NT>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint64_t* full = (uint64_t*)(smem + stages * STAGE);
  uint64_t* empty = full + stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_chunks = (ci_pad + kKC - 1) / kKC;
  const int n_hp = (H + 1) / 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {
    if (lane != 0) return;
    tma_prefetch_map(&xmap);
    tma_prefetch_map(&wmap);
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int co0 = (t % n_co_tiles) * NT;
      int r = t / n_co_tiles;
      const int w0 = (r % n_wtiles) * 128;
      r /= n_wtiles;
      const int h0 = (r % n_hp) * 2, d = (r / n_hp) % D, b = r / (n_hp * D);
      for (int p = 0; p < 9; ++p) {
        const int dz = p / 3 - 1, dy = p % 3 - 1;
        if (d + dz < 0 || d + dz >= D) continue;
        for (int c = 0; c < n_chunks; ++c, ++it) {
          const int s = it % stages;
          mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
          uint8_t* st = smem + s * STAGE;
          mbar_arrive_expect_tx(&full[s], kXBytes + 3 * WT);
          tma_load_5d(st, &xmap, &full[s], 0, w0 - 1, c * 4, h0 + dy, b * D + d + dz);
          tma_load_3d(st + kXArea, &wmap, &full[s], c * kKC, co0, 9 * (dz + 1) + 3 * (dy + 1));
        }
      }
    }
  } else {
    const int wg = warp / 4;
    float acc[2][NT / 2];
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int co0 = (t % n_co_tiles) * NT;
      int r = t / n_co_tiles;
      const int w0 = (r % n_wtiles) * 128;
      r /= n_wtiles;
      const int h0 = (r % n_hp) * 2, d = (r / n_hp) % D, b = r / (n_hp * D);
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) acc[q][i] = 0.0f;
      bool first = true;
      for (int p = 0; p < 9; ++p) {
        const int dz = p / 3 - 1;
        if (d + dz < 0 || d + dz >= D) continue;
        for (int c = 0; c < n_chunks; ++c, ++it) {
          const int s = it % stages;
          mbar_wait(&full[s], (it / stages) & 1);
          const uint8_t* sx = smem + s * STAGE + wg * 4 * kXRow;
          const uint8_t* sw = smem + s * STAGE + kXArea;
          // A: input voxel w0 - 1 + (q*64 + m + dx) of row h0 + wg; K-major, no
          // swizzle: 8-row groups 128 bytes apart, 8-channel groups kXRow apart.
          // B [NT co][32 ci] K-major, 64-byte swizzle: k16 steps 32 bytes. Offsets
          // are added to the descriptors' address field (16-byte units).
          const uint64_t a0 = smem_desc(sx, kXRow, 128, 0), b0 = smem_desc(sw, 16, 512, 2);
          wgmma_fence();
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
#pragma unroll
            for (int kk = 0; kk < 2; ++kk)
#pragma unroll
              for (int q = 0; q < 2; ++q)
                wgmma<NT, 0>(acc[q], a0 + (((q * 64 + dx) * 16 + kk * 2 * kXRow) >> 4),
                             b0 + ((dx * WT + kk * 32) >> 4));
          wgmma_commit();
          // the products of the previous step are done: hand its stage back
          wgmma_wait<1>();
          if (!first && lane == 0) mbar_arrive(&empty[(it - 1) % stages]);
          first = false;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[(it - 1) % stages]);

      const int h = h0 + wg;
      if (h >= H) continue;
      const long long DHW = (long long)D * H * W;
      __nv_bfloat16* ob = out + (long long)b * Co * DHW + ((long long)d * H + h) * W;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int wi = w0 + q * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
        for (int j = 0; j < NT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int co = co0 + 8 * j + 2 * (lane % 4) + e;
            if (co >= Co) continue;
            const float bv = bias[co];
#pragma unroll
            for (int i = 0; i < 2; ++i)
              if (wi + 8 * i < W)
                ob[co * DHW + wi + 8 * i] = __float2bfloat16(acc[q][4 * j + 2 * i + e] + bv);
          }
      }
    }
  }
}

template <int NT>
int launch_bf16(const CUtensorMap& xm, const CUtensorMap& wm, const float* bias, void* out,
                int B, int Co, int D, int H, int W, int ci_pad, cudaStream_t st) {
  constexpr int blocks_per_sm = NT <= 48 ? 2 : 1;
  constexpr int budget = 227 * 1024 / blocks_per_sm - 2048;
  const int stages = budget / stage_bytes<NT>() < 8 ? budget / stage_bytes<NT>() : 8;
  const int smem = stages * stage_bytes<NT>() + 1024 + 16 * stages;
  auto kernel = conv3d_tma_kernel<NT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  const int n_wtiles = (W + 127) / 128, n_co_tiles = (Co + NT - 1) / NT;
  const long long n_tiles = (long long)B * D * ((H + 1) / 2) * n_wtiles * n_co_tiles;
  const long long slots = (long long)blocks_per_sm * afk::hopper::num_sms();
  const int grid = (int)(n_tiles < slots ? n_tiles : slots);
  kernel<<<grid, 288, smem, st>>>(xm, wm, bias, (__nv_bfloat16*)out, Co, D, H, W, ci_pad,
                                  n_wtiles, n_co_tiles, (int)n_tiles, stages);
  return (int)cudaGetLastError();
}

int conv3d_bf16(const void* x, const void* wt, const float* bias, void* out, void* xcl, int B,
                int Ci, int Co, int D, int H, int W, int ci_pad, cudaStream_t st) {
  const int nt = Co > 96 ? 64 : Co > 64 ? 96 : Co > 48 ? 64 : Co > 32 ? 48 : Co > 16 ? 32 : 16;
  const long long S = (long long)D * H * W;
  int err = afk::hopper::channels_last(x, xcl, B, Ci, ci_pad, S, st);
  if (err) return err;
  CUtensorMap xm, wm;
  // xcl (B, D, H, W, ci_pad) walked as (8 channels, w, channel group, h, b*D + d)
  const long long xdims[5] = {8, W, ci_pad / 8, H, (long long)B * D};
  const long long xstrides[4] = {2LL * ci_pad, 16, 2LL * W * ci_pad, 2LL * H * W * ci_pad};
  const int xbox[5] = {8, kRows, kKC / 8, 2, 1};
  const long long wdims[3] = {ci_pad, Co, 27};
  const int wbox[3] = {kKC, nt, 3};
  err = afk::hopper::encode_bf16_map(&xm, xcl, 5, xdims, xstrides, xbox,
                                     CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  err = afk::hopper::encode_bf16_map(&wm, wt, 3, wdims, nullptr, wbox,
                                     CU_TENSOR_MAP_SWIZZLE_64B);
  if (err) return err;
  switch (nt) {
    case 16: return launch_bf16<16>(xm, wm, bias, out, B, Co, D, H, W, ci_pad, st);
    case 32: return launch_bf16<32>(xm, wm, bias, out, B, Co, D, H, W, ci_pad, st);
    case 48: return launch_bf16<48>(xm, wm, bias, out, B, Co, D, H, W, ci_pad, st);
    case 64: return launch_bf16<64>(xm, wm, bias, out, B, Co, D, H, W, ci_pad, st);
    default: return launch_bf16<96>(xm, wm, bias, out, B, Co, D, H, W, ci_pad, st);
  }
}

template <int NF>
void launch_f32(const void* x, const void* wt, const float* bias, void* out, int B, int Ci,
                int Co, int D, int H, int W, cudaStream_t st) {
  const int n_wtiles = (W + kTM - 1) / kTM;
  const dim3 grid((unsigned)((long long)B * D * H * n_wtiles), (Co + 16 * NF - 1) / (16 * NF));
  conv3d_f32_kernel<NF><<<grid, kThreads, 0, st>>>(
      (const float*)x, (const float*)wt, bias, (float*)out, Ci, Co, D, H, W, n_wtiles);
}

}  // namespace

// x (B, Ci, D, H, W), bias (Co,) f32 -> out (B, Co, D, H, W); x, wt and out
// share the dtype; all contiguous. float32 (is_bf16 = 0): wt (27, Ci, Co), the
// weight permuted to (kd, kh, kw, Ci, Co). bfloat16 (is_bf16 = 1): wt (27, Co,
// ci_pad), the weight permuted to (kd, kh, kw, Co, Ci) with Ci zero-padded to
// ci_pad, a multiple of 8 (TMA's 16-byte stride rule), W a multiple of 8,
// 16-byte aligned bases, and xcl a bf16 scratch of B * D*H*W * ci_pad elements
// for the channels-last input (unused for float32).
extern "C" int afk_conv3d_fwd(const void* x, const void* wt, const float* bias, void* out,
                              void* xcl, int B, int Ci, int Co, int D, int H, int W,
                              int is_bf16, int ci_pad, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) return conv3d_bf16(x, wt, bias, out, xcl, B, Ci, Co, D, H, W, ci_pad, st);
  const int nf = Co > 48 ? 4 : (Co + 15) / 16;
  switch (nf) {
    case 1: launch_f32<1>(x, wt, bias, out, B, Ci, Co, D, H, W, st); break;
    case 2: launch_f32<2>(x, wt, bias, out, B, Ci, Co, D, H, W, st); break;
    case 3: launch_f32<3>(x, wt, bias, out, B, Ci, Co, D, H, W, st); break;
    default: launch_f32<4>(x, wt, bias, out, B, Ci, Co, D, H, W, st); break;
  }
  return (int)cudaGetLastError();
}
