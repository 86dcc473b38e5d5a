// K1 — plane re-embedding, forward and backward.
//
// Replaces acquisition_focus_tpu/ops/pallas/plane_resample.py:
// plane_resample_pallas -> _forward_impl (_fwd_kernel) and _bwd_rule
// (_bwd_kernel). It re-embeds a (B, C, S, S) feature plane into a
// (B, C, So, So, So) volume along an affine given as (B, 3, 4) coefficients
// mapping output voxel (d, h, w) to continuous plane coordinates
// i_r = c0 + cd*d + ch*h + cw*w for r = (ix, iy, iz). A voxel's value is the
// bilinear (z, y) tap of the plane times the plane weight
// max(0, 1 - |ix - S/2|).
//
// What bounds it on the H100: memory. The forward writes B*C*So^3 values, most
// of them zero (the plane crosses ~2/So of the voxels); the backward needs the
// cotangent only at the band voxels, where the plane weight is non-zero.
//
// Forward: one thread per output voxel, looping over channels, so the
// coordinate math is done once per voxel and every channel's store is
// coalesced across the warp (neighbouring threads, neighbouring w). Inactive
// voxels store zeros.
//
// Backward: work only in the band |ix - S/2| <= 1 (the plane weight is
// non-zero inside it, and on its edge it still has the slope that autograd of
// the plain version's clamp gives), and no float atomics, so two runs give the
// same bits. A voxel belongs to the plane cell (z0, y0) of its nudged floor
// (cells -1..S-1 on each axis; any other cell has no valid tap). One thread
// owns one (cell, group of 8 channels) and enumerates the cell's band voxels
// itself: the voxels whose (ix, iy, iz) lie in the box |ix - S/2| <= 1,
// [y0, y0 + 1), [z0, z0 + 1) (widened by a margin) form a parallelepiped whose
// bounding box comes from the inverse of the coefficient matrix; within it the
// thread walks lines along the output axis with the largest |d ix / d axis|,
// each line's interval in closed form, and keeps a voxel only if the voxel's own
// coordinates, computed exactly as the forward computes them, fall in the cell
// and the band. So every band voxel is visited once, by one thread, with 32-bit
// index math. A rotation puts ~2 voxels in a cell, so the deep levels (S <= 16,
// C >= 128) spread over channel groups rather than loop over 256 channels.
//
// The thread sums, per channel and per tap k = (dz, dy), the voxels'
// contributions to the four texels of its cell into registers and stores them
// to a workspace P[k][b][c][cell]; a second kernel adds, for each texel, the
// four cells that touch it in a fixed order (d_slices). d_coef: each thread
// sums its voxels' 12 terms, each block reduces its threads in a fixed order to
// a partial, and the second kernel adds the partials in block order. As the
// plain version's autograd, the backward has no coordinate slope where the
// nudged floor clamps the fraction to 0.

#include "common.cuh"

namespace {

struct Coords {
  float d, h, w, ix, iy, iz;
};

__device__ __forceinline__ Coords voxel_coords(const float* cf, long long n, int So) {
  Coords c;
  c.d = (float)(n / ((long long)So * So));
  c.h = (float)((n / So) % So);
  c.w = (float)(n % So);
  c.ix = cf[0] + cf[1] * c.d + cf[2] * c.h + cf[3] * c.w;
  c.iy = cf[4] + cf[5] * c.d + cf[6] * c.h + cf[7] * c.w;
  c.iz = cf[8] + cf[9] * c.d + cf[10] * c.h + cf[11] * c.w;
  return c;
}

// The four (z, y) taps of a point: bilinear weights without the plane weight,
// validity and plane offsets z*S + y.
struct Taps {
  float wz[4], wy[4];
  int off[4];
  bool ok[4];
};

__device__ __forceinline__ Taps plane_taps(float iy, float iz, int S) {
  Taps t;
  float fy, fz;
  const int y0 = afk::nudged_cell(iy, S, &fy);
  const int z0 = afk::nudged_cell(iz, S, &fz);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dz = k >> 1, dy = k & 1;
    const int zi = z0 + dz, yi = y0 + dy;
    t.ok[k] = zi >= 0 && zi < S && yi >= 0 && yi < S;
    t.wz[k] = dz ? fz : 1.0f - fz;
    t.wy[k] = dy ? fy : 1.0f - fy;
    t.off[k] = t.ok[k] ? zi * S + yi : 0;
  }
  return t;
}

template <typename T>
__global__ void plane_fwd_kernel(const T* __restrict__ slices,
                                 const float* __restrict__ coef,
                                 T* __restrict__ out, int C, int S, int So) {
  const long long n_out = (long long)So * So * So;
  const int b = blockIdx.y;
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_out) return;
  const Coords p = voxel_coords(coef + b * 12, n, So);
  const float pw = fmaxf(0.0f, 1.0f - fabsf(p.ix - (float)(S / 2)));
  T* o = out + (long long)b * C * n_out + n;
  if (pw <= 0.0f) {
    for (int c = 0; c < C; ++c) o[c * n_out] = afk::from_f<T>(0.0f);
    return;
  }
  const Taps t = plane_taps(p.iy, p.iz, S);
  float w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = t.ok[k] ? pw * t.wz[k] * t.wy[k] : 0.0f;
  const T* src = slices + (long long)b * C * S * S;
  for (int c = 0; c < C; ++c) {
    const T* sc = src + (long long)c * S * S;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc += afk::to_f(sc[t.off[k]]) * w[k];
    o[c * n_out] = afk::from_f<T>(acc);
  }
}

// ------------------------------------------------------------------ backward

constexpr int kGroup = 8;         // channels per backward thread
constexpr int kBwdThreads = 128;  // threads per backward block
// Widening of the cell's box in plane coordinates for the enumeration; every
// candidate is then checked with its exact coordinates, so the margin only has
// to exceed the rounding of the bounding box and line intervals.
constexpr float kMargin = 1.0f / 64.0f;

// Voxel bounds [lo, hi] (inclusive, within [0, So - 1]) on each output axis of
// the parallelepiped {v : |M v + c0 - ctr| <= half} (per row), from the inverse
// of M. A singular or non-finite M gives the whole volume.
__device__ __forceinline__ void cell_bbox(const float M[3][3], const float c0[3],
                                          const float ctr[3], const float half[3], int So,
                                          int lo[3], int hi[3]) {
  const float cof[3][3] = {
      {M[1][1] * M[2][2] - M[1][2] * M[2][1], M[0][2] * M[2][1] - M[0][1] * M[2][2],
       M[0][1] * M[1][2] - M[0][2] * M[1][1]},
      {M[1][2] * M[2][0] - M[1][0] * M[2][2], M[0][0] * M[2][2] - M[0][2] * M[2][0],
       M[0][2] * M[1][0] - M[0][0] * M[1][2]},
      {M[1][0] * M[2][1] - M[1][1] * M[2][0], M[0][1] * M[2][0] - M[0][0] * M[2][1],
       M[0][0] * M[1][1] - M[0][1] * M[1][0]}};
  const float det = M[0][0] * cof[0][0] + M[0][1] * cof[1][0] + M[0][2] * cof[2][0];
  const float inv_det = 1.0f / det;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float vc = 0.0f, e = 0.0f;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float m = cof[j][r] * inv_det;
      vc += m * (ctr[r] - c0[r]);
      e += fabsf(m) * half[r];
    }
    // fmaxf/fminf take the number over a NaN: a singular M spans the volume;
    // both ends are clamped before the int conversion
    lo[j] = (int)fminf(fmaxf(ceilf(vc - e), 0.0f), (float)So);
    hi[j] = (int)fmaxf(fminf(floorf(vc + e), (float)(So - 1)), -1.0f);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
plane_bwd_cell_kernel(const T* __restrict__ slices, const float* __restrict__ coef,
                      const T* __restrict__ grad, float* __restrict__ P,
                      float* __restrict__ partial, int C, int S, int So) {
  __shared__ float red[12][kBwdThreads / 32];
  const int b = blockIdx.y, B = gridDim.y;
  const int S1 = S + 1, n_cells = S1 * S1;
  const int n_groups = (C + kGroup - 1) / kGroup;
  const int idx = blockIdx.x * kBwdThreads + threadIdx.x;
  const int g = idx / n_cells, cell = idx - g * n_cells;
  const int z0 = cell / S1 - 1, y0 = cell - (cell / S1) * S1 - 1;
  const int c_lo = g * kGroup;
  const float* cf = coef + b * 12;
  const float center = (float)(S / 2);
  const int n_out = So * So * So;

  float dc[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) dc[j] = 0.0f;
  float acc[4][kGroup];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < kGroup; ++i) acc[k][i] = 0.0f;

  if (g < n_groups) {
    // the cell's four texels, per channel (0 where a tap leaves the plane)
    const T* src = slices + ((long long)b * C + c_lo) * S * S;
    float sv[4][kGroup];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int zi = z0 + (k >> 1), yi = y0 + (k & 1);
      const bool ok = zi >= 0 && zi < S && yi >= 0 && yi < S;
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        sv[k][i] = ok && c_lo + i < C ? afk::to_f(src[i * S * S + zi * S + yi]) : 0.0f;
    }
    float M[3][3], c0[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      c0[r] = cf[r * 4];
#pragma unroll
      for (int j = 0; j < 3; ++j) M[r][j] = cf[r * 4 + 1 + j];
    }
    const float ctr[3] = {center, (float)y0 + 0.5f, (float)z0 + 0.5f};
    const float half[3] = {1.0f + kMargin, 0.5f + kMargin, 0.5f + kMargin};
    int lo[3], hi[3];
    cell_bbox(M, c0, ctr, half, So, lo, hi);
    // enumerate along the axis where ix moves fastest: the band is thinnest there
    const int a = fabsf(M[0][0]) >= fabsf(M[0][1]) && fabsf(M[0][0]) >= fabsf(M[0][2])
                      ? 0 : (fabsf(M[0][1]) >= fabsf(M[0][2]) ? 1 : 2);
    const int p = a == 0 ? 1 : 0, q = a == 2 ? 1 : 2;
    const T* gb = grad + ((long long)b * C + c_lo) * n_out;

    for (int vp = lo[p]; vp <= hi[p]; ++vp) {
      for (int vq = lo[q]; vq <= hi[q]; ++vq) {
        float t_lo = (float)lo[a], t_hi = (float)hi[a];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const float base = c0[r] + M[r][p] * (float)vp + M[r][q] * (float)vq;
          const float lo_r = ctr[r] - half[r] - base, hi_r = ctr[r] + half[r] - base;
          if (fabsf(M[r][a]) > 1e-20f) {
            const float t1 = lo_r / M[r][a], t2 = hi_r / M[r][a];
            t_lo = fmaxf(t_lo, fminf(t1, t2));
            t_hi = fminf(t_hi, fmaxf(t1, t2));
          } else if (lo_r > 0.0f || hi_r < 0.0f) {
            t_hi = -1.0f;
          }
        }
        for (int va = (int)fminf(ceilf(t_lo), (float)So); (float)va <= t_hi; ++va) {
          int v[3];
          v[a] = va;
          v[p] = vp;
          v[q] = vq;
          const float d = (float)v[0], h = (float)v[1], w = (float)v[2];
          const float ix = cf[0] + cf[1] * d + cf[2] * h + cf[3] * w;
          const float delta = ix - center;
          // |delta| = 1 has no weight but, as the plain version's clamp, a slope
          if (fabsf(delta) > 1.0f) continue;
          const float pw = fmaxf(0.0f, 1.0f - fabsf(delta));
          const float iy = cf[4] + cf[5] * d + cf[6] * h + cf[7] * w;
          const float iz = cf[8] + cf[9] * d + cf[10] * h + cf[11] * w;
          float fy, fz;
          if (afk::nudged_cell(iy, S, &fy) != y0 || afk::nudged_cell(iz, S, &fz) != z0)
            continue;
          const float wz[4] = {1.0f - fz, 1.0f - fz, fz, fz};
          const float wy[4] = {1.0f - fy, fy, 1.0f - fy, fy};
          const int n = (v[0] * So + v[1]) * So + v[2];
          float g_bil = 0.0f, g_dy = 0.0f, g_dz = 0.0f;
#pragma unroll
          for (int i = 0; i < kGroup; ++i) {
            const float gc = c_lo + i < C ? afk::to_f(gb[(long long)i * n_out + n]) : 0.0f;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float sz = (k >> 1) ? 1.0f : -1.0f;   // d wz / d iz
              const float sy = (k & 1) ? 1.0f : -1.0f;    // d wy / d iy
              acc[k][i] += gc * pw * wz[k] * wy[k];
              g_bil += gc * wz[k] * wy[k] * sv[k][i];
              g_dy += gc * wz[k] * sy * sv[k][i];
              g_dz += gc * sz * wy[k] * sv[k][i];
            }
          }
          const float dpw = delta > 0.0f ? -1.0f : (delta < 0.0f ? 1.0f : 0.0f);
          const float di[3] = {g_bil * dpw, pw * g_dy * afk::nudged_cell_slope(iy),
                               pw * g_dz * afk::nudged_cell_slope(iz)};
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            dc[r * 4 + 0] += di[r];
            dc[r * 4 + 1] += di[r] * d;
            dc[r * 4 + 2] += di[r] * h;
            dc[r * 4 + 3] += di[r] * w;
          }
        }
      }
    }
    // P[k][b][c][cell]: every (k, c, cell) is stored, zeros included
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        if (c_lo + i < C)
          P[(((long long)k * B + b) * C + c_lo + i) * n_cells + cell] = acc[k][i];
  }

  // d_coef: this block's partial, reduced in a fixed order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const float v = afk::warp_sum(dc[j]);
    if (lane == 0) red[j][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < 12) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kBwdThreads / 32; ++w) s += red[threadIdx.x][w];
    partial[((long long)b * gridDim.x + blockIdx.x) * 12 + threadIdx.x] = s;
  }
}

// d_slices[b, c, z, y] = the four cells touching texel (z, y), in tap order;
// the first B * 12 warps also add each batch's d_coef partials: lane l takes
// blocks l, l + 32, ... in order, then a fixed shuffle tree adds the lanes.
__global__ void plane_bwd_sum_kernel(const float* __restrict__ P,
                                     const float* __restrict__ partial,
                                     float* __restrict__ d_slices, float* __restrict__ d_coef,
                                     int B, int C, int S, int n_blocks) {
  const int S1 = S + 1, n_cells = S1 * S1;
  const int plane = B * C * n_cells;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < B * 12 * 32) {
    const int bj = e >> 5, lane = e & 31;
    const int b = bj / 12, j = bj - b * 12;
    float s = 0.0f;
    for (int i = lane; i < n_blocks; i += 32) s += partial[(b * n_blocks + i) * 12 + j];
    s = afk::warp_sum(s);
    if (lane == 0) d_coef[bj] = s;
  }
  if (e >= B * C * S * S) return;
  const int zy = e % (S * S), bc = e / (S * S);
  const int z = zy / S, y = zy - z * S;
  const float* pb = P + bc * n_cells;
  // tap k = (dz, dy) of cell (z - dz, y - dy), stored at cell index (z - dz + 1, y - dy + 1)
  d_slices[e] = pb[(z + 1) * S1 + y + 1] + pb[plane + (z + 1) * S1 + y] +
                pb[2 * plane + z * S1 + y + 1] + pb[3 * plane + z * S1 + y];
}

constexpr int kThreads = 256;

int bwd_blocks(int C, int S) {
  const int n = (S + 1) * (S + 1) * ((C + kGroup - 1) / kGroup);
  return (n + kBwdThreads - 1) / kBwdThreads;
}

}  // namespace

// slices (B, C, S, S), coef (B, 3, 4) f32 -> out (B, C, So, So, So), all
// contiguous; dtype float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1).
extern "C" int afk_plane_resample_fwd(const void* slices, const float* coef, void* out,
                                      int B, int C, int S, int So, int is_bf16,
                                      void* stream) {
  const long long n_out = (long long)So * So * So;
  const dim3 grid((unsigned)((n_out + kThreads - 1) / kThreads), B);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    plane_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)slices, coef, (__nv_bfloat16*)out, C, S, So);
  } else {
    plane_fwd_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)slices, coef, (float*)out, C, S, So);
  }
  return (int)cudaGetLastError();
}

// Floats of the backward's workspace: the per-tap cell sums, then the d_coef
// partials.
extern "C" long long afk_plane_resample_bwd_workspace(int B, int C, int S) {
  return 4LL * B * C * (S + 1) * (S + 1) + 12LL * B * bwd_blocks(C, S);
}

// grad (B, C, So, So, So) in the slices' dtype -> d_slices (B, C, S, S) f32 and
// d_coef (B, 3, 4) f32, both written whole; ws: the workspace above (f32). The
// cotangent's volume and the workspace's cell indices must fit 32 bits.
extern "C" int afk_plane_resample_bwd(const void* slices, const float* coef,
                                      const void* grad, float* ws, float* d_slices,
                                      float* d_coef, int B, int C, int S, int So,
                                      int is_bf16, void* stream) {
  if ((long long)So * So * So >= (1LL << 31) ||
      4LL * B * C * (S + 1) * (S + 1) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int n_blocks = bwd_blocks(C, S);
  float* P = ws;
  float* partial = ws + 4LL * B * C * (S + 1) * (S + 1);
  const dim3 grid(n_blocks, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    plane_bwd_cell_kernel<__nv_bfloat16><<<grid, kBwdThreads, 0, st>>>(
        (const __nv_bfloat16*)slices, coef, (const __nv_bfloat16*)grad, P, partial, C, S,
        So);
  } else {
    plane_bwd_cell_kernel<float><<<grid, kBwdThreads, 0, st>>>(
        (const float*)slices, coef, (const float*)grad, P, partial, C, S, So);
  }
  const int n_sum = B * C * S * S, n_threads = n_sum > 12 * 32 * B ? n_sum : 12 * 32 * B;
  plane_bwd_sum_kernel<<<(n_threads + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      P, partial, d_slices, d_coef, B, C, S, n_blocks);
  return (int)cudaGetLastError();
}

extern "C" const char* afk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
