// K1 — plane re-embedding, forward and backward.
//
// Replaces acquisition_focus_tpu/ops/pallas/plane_resample.py:
// plane_resample_pallas -> _forward_impl (_fwd_kernel) and _bwd_rule
// (_bwd_kernel). It re-embeds a (B, C, S, S) feature plane into a
// (B, C, So, So, So) volume along an affine given as (B, 3, 4) coefficients
// mapping output voxel (d, h, w) to continuous plane coordinates
// i_r = c0 + cd*d + ch*h + cw*w for r = (ix, iy, iz). A voxel's value is the
// bilinear (z, y) tap of the plane times the plane weight
// max(0, 1 - |ix - S/2|). One launch takes V views of one batch: coefficients
// (V, B, 3, 4), planes (B, V*C, S, S) (view v owns channels v*C..), and the
// volume of view v, channel c lands in channel c_off + v*C + c of a caller's
// (B, C_out, So, So, So) buffer: the skip connector writes straight into the
// decoder's concat buffer, and the backward reads the cotangent there in place.
//
// What bounds it on the H100: memory. The forward writes B*V*C*So^3 values, most
// of them zero (the plane crosses ~2/So of the voxels); the backward needs the
// cotangent only at the band voxels, where the plane weight is non-zero.
//
// Forward: one thread owns a run of kRun = 8 consecutive output voxels (along w,
// in the flat (d, h, w) order) and a group of G <= 4 channels of one (b, v); the
// runs are the fastest grid index, so a warp stores 32 neighbouring 16-byte
// vectors per channel. A thread first computes ix at its 8 voxels; a run whose
// 8 plane weights are all 0 (most runs at 128^3: the band is ~2 voxels thick)
// stores zero vectors and does no tap math, which streams at about the memory
// rate. The rest is the band: a warp whose lines cross it holds a few band runs
// among ~30 zero runs, so a thread looping over its run's channels would keep
// the warp (and its SM slot) waiting while 31 lanes idle. Instead the warp
// shares its band runs: 32 / kRunLanes runs at a time, one lane per (voxel,
// channel stride) of a run, the channels' loads issued together. Where most runs
// hold band voxels (the deep levels, S 4..16) each thread computes its own run.
// Every voxel computes its coordinates, plane weight and taps exactly as a
// voxel-per-thread kernel would, so the outputs are the same bits. G is the
// largest that still gives kFwdMinThreads threads, down to 1 at the deep levels
// (128-256 channels), which spread over the card instead of looping over all
// channels in one thread; small G keeps the band work of a warp short and the
// registers few (more warps per SM to hide the taps' latency). The planes
// (<= 512 KB per (b, v)) stay in L2 for the taps.
//
// Backward: work only in the band |ix - S/2| <= 1 (the plane weight is
// non-zero inside it, and on its edge it still has the slope that autograd of
// the plain version's clamp gives), and no float atomics, so two runs give the
// same bits. A voxel belongs to the plane cell (z0, y0) of its nudged floor
// (cells -1..S-1 on each axis; any other cell has no valid tap). One thread
// owns one (cell, group of 8 channels) of one (b, v) and enumerates the cell's
// band voxels itself: the voxels whose (ix, iy, iz) lie in the box
// |ix - S/2| <= 1, [y0, y0 + 1), [z0, z0 + 1) (widened by a margin) form a
// parallelepiped whose bounding box comes from the inverse of the coefficient
// matrix; within it the thread walks lines along the output axis with the
// largest |d ix / d axis|, each line's interval in closed form, and keeps a
// voxel only if the voxel's own coordinates, computed exactly as the forward
// computes them, fall in the cell and the band. So every band voxel is visited
// once, by one thread, with 32-bit index math. A rotation puts ~2 voxels in a
// cell, so the deep levels (S <= 16, C >= 128) spread over channel groups
// rather than loop over 256 channels.
//
// The thread sums, per channel and per tap k = (dz, dy), the voxels'
// contributions to the four texels of its cell into registers and stores them
// to a workspace P[k][b][v*C + c][cell]; a second kernel adds, for each texel,
// the four cells that touch it in a fixed order (d_slices). d_coef: each thread
// sums its voxels' 12 terms, each block reduces its threads in a fixed order to
// a partial, and the second kernel adds the partials in block order. The grid
// of a view is the grid of a one-view launch, so a V-view launch gives the bits
// of V one-view launches. As the plain version's autograd, the backward has no
// coordinate slope where the nudged floor clamps the fraction to 0.

#include "common.cuh"

namespace {

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

constexpr int kRun = 8;                      // output voxels per forward thread
constexpr int kFwdThreads = 256;             // threads per forward block
constexpr int kFwdMinThreads = 1 << 17;      // forward threads a launch aims for
// Resident forward blocks per SM: caps the registers at 48 (no spills), 40
// warps per SM to hide the band taps' latency.
constexpr int kFwdMinBlocks = 5;
constexpr int kMaxGroup = 4;                 // most channels per forward thread
// A warp with at most kCoopRuns * min(G, 2) band runs shares their work.
constexpr int kCoopRuns = 8;
constexpr int kRunLanes = 16;                // lanes that share one band run
constexpr int kRunStride = kRunLanes / kRun;  // their channel stride

// 8 values to p: one 16-byte store (bf16) or two (f32) where ``vec`` (p 16-byte
// aligned), else the first n one by one.
__device__ __forceinline__ void store_run(float* p, const float v[kRun], bool vec, int n) {
  if (vec) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    for (int j = 0; j < n; ++j) p[j] = v[j];
  }
}

__device__ __forceinline__ void store_run(__nv_bfloat16* p, const float v[kRun], bool vec,
                                          int n) {
  if (vec) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < kRun / 2; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    for (int j = 0; j < n; ++j) p[j] = __float2bfloat16(v[j]);
  }
}

// A band voxel's four taps: weights with the plane weight pw folded in (0 for a
// tap off the plane) and plane offsets.
struct VoxelTaps {
  float w[4];
  int off[4];
};

__device__ __forceinline__ VoxelTaps voxel_taps(const float* cf, float d, float h, float w,
                                                float pw, int S) {
  const float iy = cf[4] + cf[5] * d + cf[6] * h + cf[7] * w;
  const float iz = cf[8] + cf[9] * d + cf[10] * h + cf[11] * w;
  const Taps t = plane_taps(iy, iz, S);
  VoxelTaps v;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v.w[k] = t.ok[k] ? pw * t.wz[k] * t.wy[k] : 0.0f;
    v.off[k] = t.off[k];
  }
  return v;
}

template <typename T>
__device__ __forceinline__ float tap_sum(const T* sc, const VoxelTaps& v) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) acc += afk::to_f(sc[v.off[k]]) * v.w[k];
  return acc;
}

__device__ __forceinline__ float plane_weight(const float* cf, float d, float h, float w,
                                              float center) {
  const float ix = cf[0] + cf[1] * d + cf[2] * h + cf[3] * w;
  return fmaxf(0.0f, 1.0f - fabsf(ix - center));
}

// An output voxel, walked along the flat (d, h, w) order: integer w and h for
// the wraps, float coordinates stepped by 1 (exact) so that no step converts.
struct Voxel {
  int w, h;
  float fd, fh, fw;
};

__device__ __forceinline__ Voxel first_voxel(int n, int So) {
  const int line = n / So, d = line / So;
  return {n - line * So, line - d * So, (float)d, (float)(line - d * So), (float)(n - line * So)};
}

__device__ __forceinline__ void next_voxel(Voxel& p, int So) {
  if (++p.w < So) {
    p.fw += 1.0f;
    return;
  }
  p.w = 0;
  p.fw = 0.0f;
  if (++p.h < So) {
    p.fh += 1.0f;
    return;
  }
  p.h = 0;
  p.fh = 0.0f;
  p.fd += 1.0f;
}

// Grid: x the runs (fastest), y the channel groups, z the (v, b) pairs. A thread
// tests its run's 8 voxels; a run with no band voxel stores zero vectors for the
// group's G channels. ``vec``: every run's first voxel is 16-byte aligned in every
// channel (So^3 % 8 == 0, aligned out). A warp's band runs: when there are few
// (a thin band crossing the warp's lines), the whole warp computes them,
// 32 / kRunLanes runs at a time, lane (slot, q, j) taking voxel j of its slot's
// run and channels q, q + kRunStride, ..., so no lane idles while one thread
// loops over G channels; when there are many (the deep levels, where most runs
// hold band voxels), each thread computes its own run.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads, kFwdMinBlocks)
plane_fwd_kernel(const T* __restrict__ slices, const float* __restrict__ coef,
                 T* __restrict__ out, long long out_bstride, int c_off, int V, int B, int C,
                 int S, int So, int G, bool vec) {
  const int n_out = So * So * So, n_runs = (n_out + kRun - 1) / kRun;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int vb = blockIdx.z, v = vb / B, b = vb - v * B;
  const int c_lo = blockIdx.y * G, c_hi = min(C, c_lo + G);
  const float* cf = coef + vb * 12;
  const float center = (float)(S / 2);
  const int n0 = r * kRun, n_run = r < n_runs ? min(kRun, n_out - n0) : 0;
  const Voxel first = first_voxel(n0, So);

  unsigned in_band = 0;  // bit j: voxel j of the run has a plane weight > 0
  Voxel p = first;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    if (j < n_run && plane_weight(cf, p.fd, p.fh, p.fw, center) > 0.0f) in_band |= 1u << j;
    next_voxel(p, So);
  }
  float val[kRun];
  T* o = out + (long long)b * out_bstride + (long long)(c_off + v * C + c_lo) * n_out + n0;
  if (n_run > 0 && !in_band) {
#pragma unroll
    for (int j = 0; j < kRun; ++j) val[j] = 0.0f;
    for (int c = c_lo; c < c_hi; ++c, o += n_out) store_run(o, val, vec, n_run);
  }
  const T* sc = slices + ((long long)b * V * C + v * C) * S * S;
  unsigned bands = __ballot_sync(0xffffffffu, in_band != 0);
  if (__popc(bands) > kCoopRuns * min(G, 2)) {
    if (!in_band) return;
#pragma unroll 1
    for (int c = c_lo; c < c_hi; ++c, o += n_out) {
      p = first;
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        val[j] = in_band >> j & 1
                     ? tap_sum(sc + (long long)c * S * S,
                               voxel_taps(cf, p.fd, p.fh, p.fw,
                                          plane_weight(cf, p.fd, p.fh, p.fw, center), S))
                     : 0.0f;
        next_voxel(p, So);
      }
      store_run(o, val, vec, n_run);
    }
    return;
  }
  const int lane = threadIdx.x & 31, slot = lane / kRunLanes;
  const int j = lane % kRun, q = lane % kRunLanes / kRun;
  while (bands) {
    unsigned mine = bands;
    for (int k = 0; k < slot; ++k) mine &= mine - 1;
    for (int k = 0; k < 32 / kRunLanes; ++k) bands &= bands - 1;
    const int src = mine ? __ffs(mine) - 1 : lane;
    const int rs = __shfl_sync(0xffffffffu, r, src);
    const int ws = __shfl_sync(0xffffffffu, first.w, src);
    const int hs = __shfl_sync(0xffffffffu, first.h, src);
    const float ds = __shfl_sync(0xffffffffu, first.fd, src);
    const int n = rs * kRun + j;
    if (!mine || n >= n_out) continue;
    p = {ws, hs, ds, (float)hs, (float)ws};
    for (int k = 0; k < j; ++k) next_voxel(p, So);
    const float pw = plane_weight(cf, p.fd, p.fh, p.fw, center);
    VoxelTaps t = {};
    if (pw > 0.0f) t = voxel_taps(cf, p.fd, p.fh, p.fw, pw, S);
    T* os = out + (long long)b * out_bstride + (long long)(c_off + v * C) * n_out + n;
    const int c0 = c_lo + q;
    float acc[kMaxGroup / kRunStride];
#pragma unroll
    for (int i = 0; i < kMaxGroup / kRunStride; ++i) {
      const int c = c0 + i * kRunStride;
      acc[i] = pw > 0.0f && c < c_hi ? tap_sum(sc + (long long)c * S * S, t) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kMaxGroup / kRunStride; ++i) {
      const int c = c0 + i * kRunStride;
      if (c < c_hi) os[(long long)c * n_out] = afk::from_f<T>(acc[i]);
    }
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
                      const T* __restrict__ grad, long long g_bstride, int g_coff,
                      float* __restrict__ P, float* __restrict__ partial, int V, int B,
                      int C, int S, int So) {
  __shared__ float red[12][kBwdThreads / 32];
  const int vb = blockIdx.y, v = vb / B, b = vb - v * B;
  const int S1 = S + 1, n_cells = S1 * S1;
  const int n_groups = (C + kGroup - 1) / kGroup;
  const int idx = blockIdx.x * kBwdThreads + threadIdx.x;
  const int g = idx / n_cells, cell = idx - g * n_cells;
  const int z0 = cell / S1 - 1, y0 = cell - (cell / S1) * S1 - 1;
  const int c_lo = g * kGroup;
  const float* cf = coef + vb * 12;
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
    const T* src = slices + ((long long)b * V * C + v * C + c_lo) * S * S;
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
    const T* gb = grad + (long long)b * g_bstride + (long long)(g_coff + v * C + c_lo) * n_out;

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
    // P[k][b][v*C + c][cell]: every (k, c, cell) is stored, zeros included
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        if (c_lo + i < C)
          P[(((long long)k * B + b) * V * C + v * C + c_lo + i) * n_cells + cell] = acc[k][i];
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
    partial[((long long)vb * gridDim.x + blockIdx.x) * 12 + threadIdx.x] = s;
  }
}

// d_slices[b, c, z, y] = the four cells touching texel (z, y), in tap order,
// over all VC = V * C channels of a batch; the first VB * 12 warps (VB = V * B)
// also add each (v, b)'s d_coef partials: lane l takes blocks l, l + 32, ... in
// order, then a fixed shuffle tree adds the lanes.
__global__ void plane_bwd_sum_kernel(const float* __restrict__ P,
                                     const float* __restrict__ partial,
                                     float* __restrict__ d_slices, float* __restrict__ d_coef,
                                     int VB, int B, int VC, int S, int n_blocks) {
  const int S1 = S + 1, n_cells = S1 * S1;
  const int plane = B * VC * n_cells;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < VB * 12 * 32) {
    const int bj = e >> 5, lane = e & 31;
    const int vb = bj / 12, j = bj - vb * 12;
    float s = 0.0f;
    for (int i = lane; i < n_blocks; i += 32) s += partial[(vb * n_blocks + i) * 12 + j];
    s = afk::warp_sum(s);
    if (lane == 0) d_coef[bj] = s;
  }
  if (e >= B * VC * S * S) return;
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

// Channels per forward thread: the most, up to 16, that still give
// kFwdMinThreads threads (at 128^3 16, at 4^3 and 8^3 with 256 channels 1).
int fwd_group(long long n_runs, int VB, int C) {
  int G = kMaxGroup;
  while (G > 1 && n_runs * VB * ((C + G - 1) / G) < kFwdMinThreads) G /= 2;
  return G;
}

}  // namespace

// V views: slices (B, V*C, S, S), coef (V, B, 3, 4) f32 -> view v, channel c
// into channel c_off + v*C + c of out, a (B, C_out, So, So, So) buffer with
// batch stride out_bstride elements; slices and coef contiguous; dtype float32
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1). Every voxel of those channels is
// written; no other element of out is touched.
extern "C" int afk_plane_resample_fwd(const void* slices, const float* coef, void* out,
                                      long long out_bstride, int c_off, int V, int B, int C,
                                      int S, int So, int is_bf16, void* stream) {
  const long long n_out = (long long)So * So * So;
  const long long n_runs = (n_out + kRun - 1) / kRun;
  const int G = fwd_group(n_runs, V * B, C);
  // small blocks where a volume has few runs (the deep levels), so that few lanes idle
  const int threads = n_runs >= kFwdThreads ? kFwdThreads : (int)(n_runs + 31) / 32 * 32;
  const dim3 grid((unsigned)((n_runs + threads - 1) / threads), (C + G - 1) / G, V * B);
  // the kernel's index math is 32-bit
  if (n_out >= (1LL << 31) || grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidValue;
  // runs start on 8-element boundaries in every channel and batch when n_out % 8
  // == 0 (then so is the batch stride), so 16-byte stores need an aligned base
  const bool vec = n_out % kRun == 0 && out_bstride % kRun == 0 &&
                   reinterpret_cast<unsigned long long>(out) % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    plane_fwd_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        (const __nv_bfloat16*)slices, coef, (__nv_bfloat16*)out, out_bstride, c_off, V, B, C,
        S, So, G, vec);
  } else {
    plane_fwd_kernel<float><<<grid, threads, 0, st>>>(
        (const float*)slices, coef, (float*)out, out_bstride, c_off, V, B, C, S, So, G, vec);
  }
  return (int)cudaGetLastError();
}

// Floats of the backward's workspace: the per-tap cell sums, then the d_coef
// partials.
extern "C" long long afk_plane_resample_bwd_workspace(int V, int B, int C, int S) {
  return 4LL * V * B * C * (S + 1) * (S + 1) + 12LL * V * B * bwd_blocks(C, S);
}

// V views, as the forward: the cotangent of view v, channel c is channel
// g_coff + v*C + c of grad, a (B, C_g, So, So, So) buffer in the slices' dtype
// with batch stride g_bstride elements, read in place -> d_slices (B, V*C, S, S)
// f32 and d_coef (V, B, 3, 4) f32, both written whole; ws: the workspace above
// (f32). The cotangent's volume and the workspace's cell indices must fit 32 bits.
extern "C" int afk_plane_resample_bwd(const void* slices, const float* coef,
                                      const void* grad, long long g_bstride, int g_coff,
                                      float* ws, float* d_slices, float* d_coef, int V, int B,
                                      int C, int S, int So, int is_bf16, void* stream) {
  const long long n_cell_sums = 4LL * V * B * C * (S + 1) * (S + 1);
  if ((long long)So * So * So >= (1LL << 31) || n_cell_sums >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int n_blocks = bwd_blocks(C, S);
  float* P = ws;
  float* partial = ws + n_cell_sums;
  const dim3 grid(n_blocks, V * B);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    plane_bwd_cell_kernel<__nv_bfloat16><<<grid, kBwdThreads, 0, st>>>(
        (const __nv_bfloat16*)slices, coef, (const __nv_bfloat16*)grad, g_bstride, g_coff, P,
        partial, V, B, C, S, So);
  } else {
    plane_bwd_cell_kernel<float><<<grid, kBwdThreads, 0, st>>>(
        (const float*)slices, coef, (const float*)grad, g_bstride, g_coff, P, partial, V, B,
        C, S, So);
  }
  const int n_sum = B * V * C * S * S;
  const int n_threads = n_sum > 12 * 32 * V * B ? n_sum : 12 * 32 * V * B;
  plane_bwd_sum_kernel<<<(n_threads + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      P, partial, d_slices, d_coef, V * B, B, V * C, S, n_blocks);
  return (int)cudaGetLastError();
}

extern "C" const char* afk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
