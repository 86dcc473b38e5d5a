// K2 — forward-only trilinear affine volume resample.
//
// Replaces acquisition_focus_tpu/ops/pallas/volume_resample.py:
// affine_volume_resample_pallas (_kernel): torch grid_sample semantics
// (align_corners=False, zero padding) for T affines sharing B volumes — affine
// row t samples volume t % B. Affines arrive as (T, 3, 4) coefficients mapping
// output voxel (d, h, w) to continuous source coordinates
// i_r = c0 + cd*d + ch*h + cw*w for r = (x->W, y->H, z->D).
//
// What bounds it on the H100: each input read and each output written once
// would take ~0.06 ms at (2, 6, 128^3) -> (6, 6, 128^3) bf16. A gather straight
// from NCDHW issues 8 corners x C scattered 2-byte loads per output voxel, whose
// planes lie D*H*W elements apart; under a rotation each warp-wide load touches
// dozens of sectors, so such a kernel is bound by load transactions, not bytes.
//
// Design, in two kernels of one launch:
// 1. volume_resample_stage_kernel copies each volume channels-last into the
//    wrapper's scratch, (B, D*H*W, C8) with channels zero-padded to C8 = C
//    rounded up to 8: one thread per (voxel, group of 8 channels) reads the 8
//    channels (coalesced along the voxel axis) and writes them as one 16-byte
//    (bf16) or two (f32) vector stores. After it, a trilinear corner is one
//    16-byte load per 8 channels.
// 2. volume_resample_brick_kernel gives each block a brick of 32 w x 8 h x 16 d
//    output voxels, walked in 8 steps of 2 d, so the block's source footprint is
//    a compact parallelepiped whose lines the next step finds in L1 under any
//    rotation, and each thread two neighbouring w voxels: per channel it stores
//    them as one 4-byte (bf16) or 8-byte (f32) pair, coalesced along w.
// What holds it back (device times on the H100; ncu does not run there): the
// gather takes ~10x the staging pass at the shape above. Other brick shapes, more
// resident blocks and staging each brick's source box in shared memory (the
// TPU's bbox DMA, per block) were no faster. The likely limit: under a rotation a
// warp's 32 loads of one corner fall on as many different 128-byte lines, or
// shared-memory banks, and each trilinear sample needs 8 corners.
// The TPU kernel's bounding-box DMA and its static bbox sizes exist only
// because a TPU core cannot gather; a gather has no scale limit, so the bbox
// cascade and its runtime scale guard have no counterpart here. Interpolation
// weights are f32, accumulation is f32 in the corner order (z, y, x), cell
// assignment is the JAX resampler's epsilon-nudged floor.

#include "common.cuh"

namespace {

constexpr int kStageThreads = 256;
// A brick's threads (2 w voxels each) and their steps along d: 32 w x 8 h x 16 d
// output voxels per block.
constexpr int kBx = 16, kBy = 8, kBz = 2, kDsteps = 8;

// 8 values of T as 16-byte vectors: one for bf16, two for f32.
template <typename T>
struct Vec8 {
  static constexpr int kWords = sizeof(T) * 8 / 16;
  uint4 u[kWords];
};

__device__ __forceinline__ void unpack(const Vec8<__nv_bfloat16>& v, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(v.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void unpack(const Vec8<float>& v, float* f) {
  const float* p = reinterpret_cast<const float*>(v.u);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = p[i];
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store_pair(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}

// vol (B, C, n_vox) -> vcl (B, n_vox, C8); blockIdx.y = b * n_groups + group.
template <typename T>
__global__ void __launch_bounds__(kStageThreads)
volume_resample_stage_kernel(const T* __restrict__ vol, T* __restrict__ vcl, int C, int C8,
                             int n_vox) {
  const int s = blockIdx.x * kStageThreads + threadIdx.x;
  if (s >= n_vox) return;
  const int n_groups = C8 / 8;
  const int b = blockIdx.y / n_groups, g = blockIdx.y - b * n_groups;
  Vec8<T> v;
  T* vals = reinterpret_cast<T*>(v.u);
  const T* src = vol + ((long long)b * C + g * 8) * n_vox + s;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    vals[i] = g * 8 + i < C ? src[(long long)i * n_vox] : afk::from_f<T>(0.0f);
  Vec8<T>* dst = reinterpret_cast<Vec8<T>*>(vcl + ((long long)b * n_vox + s) * C8 + g * 8);
  *dst = v;
}

template <typename T>
__global__ void __launch_bounds__(kBx * kBy * kBz)
volume_resample_brick_kernel(const T* __restrict__ vcl, const float* __restrict__ coef,
                             T* __restrict__ out, int B, int C, int C8, int D, int H, int W,
                             int Do, int Ho, int Wo, int n_bz) {
  const int t = blockIdx.z / n_bz;
  const int h = blockIdx.y * kBy + threadIdx.y;
  const int w0 = (blockIdx.x * kBx + threadIdx.x) * 2;
  if (h >= Ho || w0 >= Wo) return;
  const float* cf = coef + t * 12;
  const int HW = H * W;
  const long long n_out = (long long)Do * Ho * Wo;
  const T* src = vcl + (long long)(t % B) * D * HW * C8;
  const bool pair = w0 + 1 < Wo && Wo % 2 == 0;
  const int d_lo = (blockIdx.z - t * n_bz) * kBz * kDsteps + threadIdx.z;

  for (int step = 0; step < kDsteps; ++step) {
    const int d = d_lo + step * kBz;
    if (d >= Do) return;
    float wk[2][8];
    int off[2][8];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float fd = (float)d, fh = (float)h, fw = (float)(w0 + j);
      const float ix = cf[0] + cf[1] * fd + cf[2] * fh + cf[3] * fw;
      const float iy = cf[4] + cf[5] * fd + cf[6] * fh + cf[7] * fw;
      const float iz = cf[8] + cf[9] * fd + cf[10] * fh + cf[11] * fw;
      float fx, fy, fz;
      const int x0 = afk::nudged_cell(ix, W, &fx);
      const int y0 = afk::nudged_cell(iy, H, &fy);
      const int z0 = afk::nudged_cell(iz, D, &fz);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
        const int zi = z0 + dz, yi = y0 + dy, xi = x0 + dx;
        const bool ok = w0 + j < Wo && zi >= 0 && zi < D && yi >= 0 && yi < H && xi >= 0 &&
                        xi < W;
        wk[j][k] = ok ? (dz ? fz : 1.0f - fz) * (dy ? fy : 1.0f - fy) * (dx ? fx : 1.0f - fx)
                      : 0.0f;
        off[j][k] = ok ? zi * HW + yi * W + xi : -1;
      }
    }

    T* o = out + (long long)t * C * n_out + ((long long)d * Ho + h) * Wo + w0;
    for (int g = 0; g * 8 < C8; ++g) {
      float acc[2][8];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[j][i] = 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (off[j][k] < 0) continue;
          const Vec8<T> v = *reinterpret_cast<const Vec8<T>*>(
              src + (long long)off[j][k] * C8 + g * 8);
          float f[8];
          unpack(v, f);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[j][i] += f[i] * wk[j][k];
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = g * 8 + i;
        if (c >= C) break;
        T* oc = o + c * n_out;
        if (pair) {
          store_pair(oc, acc[0][i], acc[1][i]);
        } else {
          oc[0] = afk::from_f<T>(acc[0][i]);
          if (w0 + 1 < Wo) oc[1] = afk::from_f<T>(acc[1][i]);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* vol, const float* coef, void* scratch, void* out, int B, int C,
           int D, int H, int W, int T_, int Do, int Ho, int Wo, cudaStream_t st) {
  const int C8 = (C + 7) / 8 * 8, n_vox = D * H * W;
  const dim3 stage_grid((n_vox + kStageThreads - 1) / kStageThreads, B * (C8 / 8));
  volume_resample_stage_kernel<T><<<stage_grid, kStageThreads, 0, st>>>(
      (const T*)vol, (T*)scratch, C, C8, n_vox);
  const int n_bz = (Do + kBz * kDsteps - 1) / (kBz * kDsteps);
  const dim3 grid((Wo + 2 * kBx - 1) / (2 * kBx), (Ho + kBy - 1) / kBy, T_ * n_bz);
  volume_resample_brick_kernel<T><<<grid, dim3(kBx, kBy, kBz), 0, st>>>(
      (const T*)scratch, coef, (T*)out, B, C, C8, D, H, W, Do, Ho, Wo, n_bz);
  return (int)cudaGetLastError();
}

}  // namespace

// vol (B, C, D, H, W), coef (T, 3, 4) f32 -> out (T, C, Do, Ho, Wo), all
// contiguous; dtype float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); scratch:
// B * D*H*W * C8 elements of that dtype (C8 = C rounded up to 8), 16-byte
// aligned, for the channels-last copy.
extern "C" int afk_volume_resample(const void* vol, const float* coef, void* scratch,
                                   void* out, int B, int C, int D, int H, int W, int T,
                                   int Do, int Ho, int Wo, int is_bf16, void* stream) {
  const int n_bz = (Do + kBz * kDsteps - 1) / (kBz * kDsteps);
  if ((long long)D * H * W >= (1LL << 31) || (long long)T * n_bz > 65535 ||
      (long long)B * ((C + 7) / 8) > 65535 || (unsigned long long)scratch % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(vol, coef, scratch, out, B, C, D, H, W, T, Do, Ho, Wo, st);
  return launch<float>(vol, coef, scratch, out, B, C, D, H, W, T, Do, Ho, Wo, st);
}
