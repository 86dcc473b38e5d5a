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
// Design: implicit GEMM per tap with split-K over voxel rows, read straight
// from NCDHW. A block owns one (dz, dy) tap pair, all three dx taps of it, 48
// input channels (3 warps x 16) and 16*NF output channels, over a chunk of
// consecutive (b, d, h) rows. Per row and 64-voxel step along w it stages the
// cotangent tile once and the input row once with a one-voxel halo, written
// into three dx-shifted copies (zero outside the volume, which is SAME
// padding, so no edge masks are needed), then multiplies with bf16 WMMA
// fragments into f32 accumulators: each cotangent fragment feeds three taps.
// Rows whose (dz, dy) neighbour lies outside the volume contribute zero and
// are skipped. Loads coalesce along w. A float32 variant (same tiling, scalar
// FMA, no TF32) serves f32 callers.
//
// Reduction: each block writes its partial sums to its own slot of a
// workspace (chunk, 27, Ci', Co'); a second kernel sums the chunks in a fixed
// order into dw (Co, Ci, 3, 3, 3). No atomics, so the result is the same bits
// from run to run.
// Simple first: no TMA, no wgmma, no multi-stage pipeline yet.

#include <mma.h>

#include "common.cuh"

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
wgrad_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                  float* __restrict__ part, int B, int Ci, int Co, int D, int H, int W,
                  int rows_per_chunk, int n_ci_tiles, int cip, int cop) {
  using namespace nvcuda;
  constexpr int KT = 64, TN = 16 * NF, LDA = KT + 8, LDB = KT + 8;
  __shared__ __align__(32) __nv_bfloat16 As[3 * kMT * LDA];
  __shared__ __align__(32) __nv_bfloat16 Bs[TN * LDB];

  const Block k = block_coords(n_ci_tiles, TN, B * D * H, rows_per_chunk);
  const int warp = threadIdx.x / 32;
  const long long DHW = (long long)D * H * W;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[3][NF];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[s][f], 0.0f);

  for (int r = k.r0; r < k.r1; ++r) {
    const __nv_bfloat16 *xrow, *grow;
    if (!row_ptrs(x, g, r, k, Ci, Co, D, H, W, &xrow, &grow)) continue;  // block-uniform
    for (int w0 = 0; w0 < W; w0 += KT) {
      stage_row<__nv_bfloat16, KT, TN, LDA, LDB>(xrow, grow, As, Bs, k.ci0, k.co0, Ci, Co,
                                                 DHW, w0, W);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KT; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f) wmma::load_matrix_sync(fb[f], Bs + f * 16 * LDB + kk, LDB);
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, As + (s * kMT + warp * 16) * LDA + kk, LDA);
#pragma unroll
          for (int f = 0; f < NF; ++f) wmma::mma_sync(acc[s][f], fa, fb[f], acc[s][f]);
        }
      }
      __syncthreads();
    }
  }

  const int chunk = blockIdx.x, tap0 = blockIdx.y * 3;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    float* dst = part + (((long long)chunk * 27 + tap0 + s) * cip + k.ci0 + warp * 16) * cop
                 + k.co0;
#pragma unroll
    for (int f = 0; f < NF; ++f)
      wmma::store_matrix_sync(dst + f * 16, acc[s][f], cop, wmma::mem_row_major);
  }
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

template <int NF>
void launch(const void* x, const void* g, float* part, int B, int Ci, int Co, int D, int H,
            int W, const Tiling& t, int is_bf16, cudaStream_t st) {
  const dim3 grid(t.n_chunks, 9, t.n_ci_tiles * t.n_co_tiles);
  if (is_bf16) {
    wgrad_bf16_kernel<NF><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)g, part, B, Ci, Co, D, H, W,
        t.rows_per_chunk, t.n_ci_tiles, t.cip, t.cop);
  } else {
    wgrad_f32_kernel<NF><<<grid, kThreads, 0, st>>>(
        (const float*)x, (const float*)g, part, B, Ci, Co, D, H, W, t.rows_per_chunk,
        t.n_ci_tiles, t.cip, t.cop);
  }
}

}  // namespace

// Workspace of afk_conv3d_wgrad for these shapes: out[0] chunks, out[1] floats
// per chunk; the caller allocates out[0] * out[1] floats.
extern "C" int afk_conv3d_wgrad_workspace(int B, int Ci, int Co, int D, int H, int* out) {
  const Tiling t = tiling(B, Ci, Co, D, H);
  out[0] = t.n_chunks;
  out[1] = 27 * t.cip * t.cop;
  return 0;
}

// x (B, Ci, D, H, W) and g (B, Co, D, H, W), one dtype, float32 (is_bf16 = 0)
// or bfloat16 (is_bf16 = 1), contiguous; part: the workspace above (f32);
// dw (Co, Ci, 3, 3, 3) float32.
extern "C" int afk_conv3d_wgrad(const void* x, const void* g, float* part, float* dw, int B,
                                int Ci, int Co, int D, int H, int W, int is_bf16,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Tiling t = tiling(B, Ci, Co, D, H);
  switch (t.nf) {
    case 1: launch<1>(x, g, part, B, Ci, Co, D, H, W, t, is_bf16, st); break;
    case 2: launch<2>(x, g, part, B, Ci, Co, D, H, W, t, is_bf16, st); break;
    case 3: launch<3>(x, g, part, B, Ci, Co, D, H, W, t, is_bf16, st); break;
    default: launch<4>(x, g, part, B, Ci, Co, D, H, W, t, is_bf16, st); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = 27LL * Ci * Co;
  wgrad_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, dw, t.n_chunks, Ci,
                                                                  Co, t.cip, t.cop);
  return (int)cudaGetLastError();
}
