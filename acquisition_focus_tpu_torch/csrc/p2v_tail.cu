// (E)Pix2Vox's 128^3 tail: the merger's five 3^3 conv + batch norm +
// leaky-ReLU blocks (9 -> 16 -> 8 -> 4 -> 2 -> 1 channels, padding 1, bias)
// and the weight gradient of the decoder's last transposed conv (up5: 32 -> 8
// channels, 4^3, stride 2, padding 1, 64^3 -> 128^3). float32 storage, FP32
// FMA arithmetic (no TF32, no bf16).
//
// Replaces no TPU kernel: the JAX package leaves these layers to XLA. They are
// here because cuDNN runs them with direct float32 kernels far from their bound
// on the H100 (up5's weight gradient alone took a third of the step; PERF.md).
//
// What bounds them: arithmetic at the float32 FMA rate. The merger's convs are
// ~71 GFLOP a forward at batch 2 (and as much again for each gradient) against
// ~1 GB of activations; with 1 to 16 channels the products are too narrow for
// the tensor cores' tiles without padding, so they run as register-blocked
// FMA.
//
// p2v_merge_fwd: a block's conv. A block of 8 warps takes a tile of VPT
// (depth) x 8 (rows) x 32 (lanes) output voxels; each thread keeps CO x VPT
// sums for its column of VPT voxels along d. The input goes through shared
// memory one channel at a time (double-buffered, the next channel's loads in
// flight during the products); the previous block's batch norm and leaky-ReLU
// are applied as the tile is staged, so no separate pass runs over the 128^3
// tensor, and the conv's zero padding stays zero. The weights sit in shared
// memory as [ci][tap][co], read as broadcast float4s. The epilogue adds the
// bias, stores, and writes each channel's sum and sum of squares for the tile
// (a fixed-order block sum) as one row of partials.
// p2v_merge_dx: the same body on the cotangent with the spatially flipped,
// IO-swapped weights (read so from the forward's weight), no bias, no sums.
// p2v_merge_dw: the weight and bias gradients. Each thread owns one (ci, kd,
// kh) and 3 kw x CO sums; the lanes of a warp are 32 owners over the same
// voxels, so the cotangent is a broadcast float4 and the input's padded
// strides put the 32 owners on 32 banks. A fixed grid of blocks walks the
// voxel tiles in a fixed order and writes one row of partials each.
// p2v_merge_norm: the pointwise passes of a norm: the last block's forward
// activation, and the backward's per-channel sums (sum dz, sum dz * xhat) and
// its apply (dy = k dz + al y + be, in place over the cotangent it reads).
// p2v_merge_sum: the ordered sum of partial rows (one warp a column, float64),
// with the norm's statistics or backward coefficients worked out from the sums.
// p2v_up_dw: up5's weight gradient. Output voxel o = 2j + p (per axis) takes
// inputs i = j + delta with tap k = p + 1 - 2 delta, so for each of the 8
// parity classes it is a 2^3-tap correlation on the 64^3 grid. A thread owns 4
// input channels x 2 taps along w x 8 output channels for one parity class and
// (delta_d, delta_h); the tile's input is staged channels-last and the
// cotangent by parity class, both read as float4s.
//
// Every sum runs in a fixed order: two runs give the same bits.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTW = 32, kTH = 8;                 // p2v_merge_fwd/dx tile: lanes x warps
constexpr int kHW = kTW + 2, kHH = kTH + 2;      // its input halo
constexpr int kPartBlocks = 256;                 // fixed grid of the reducing kernels
constexpr int kNormChunk = kThreads * 16;        // voxels of one p2v_merge_norm block

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// depth of a thread's column: CO x VPT sums stay within ~128 registers
__host__ __device__ constexpr int vpt_for(int co) { return co >= 8 ? 8 : 16; }

__device__ __forceinline__ float leaky(float z, float slope) { return z > 0.f ? z : z * slope; }

// the norm's scale and shift of channel c from its statistics: every kernel
// forms them with the same operations, so z = y * sc + sh has the same bits in
// the forward, the weight gradient's staging and the backward
__device__ __forceinline__ void norm_affine(const float* st, const float* gamma, const float* beta,
                                            int C, int c, float* sc, float* sh) {
  const float s = gamma[c] * st[C + c];          // st = [mean (C), rstd (C)]
  *sc = s;
  *sh = fmaf(-st[c], s, beta[c]);
}

struct Norm {                                    // the previous block's norm, or none
  const float* st;
  const float* gamma;
  const float* beta;
  float slope;
};

// ------------------------------------------------------------ fwd and dx

template <int CI, int CO, bool ACT, bool FLIP>
__device__ __forceinline__ void tile_body(const float* __restrict__ x, Norm nm,
                                          const float* __restrict__ w,
                                          const float* __restrict__ bias, float* __restrict__ out,
                                          float* __restrict__ part, int D, int H, int W) {
  constexpr int VPT = vpt_for(CO);
  constexpr int TS = (VPT + 2) * kHH * kHW;      // one input channel's halo tile
  constexpr int NPRE = cdiv(TS, kThreads);
  constexpr int NW = cdiv(CI * 27 * CO, 4) * 4;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                              // [ci][tap][co]
  float* xs = smem + NW;                         // [2][TS]
  const int tid = threadIdx.x, lane = tid & 31, ty = tid >> 5;
  int b = blockIdx.x;
  const int nwt = cdiv(W, kTW), nht = cdiv(H, kTH), ndt = cdiv(D, VPT);
  const int w0 = (b % nwt) * kTW; b /= nwt;
  const int h0 = (b % nht) * kTH; b /= nht;
  const int d0 = (b % ndt) * VPT;
  const int n = b / ndt;
  const long long plane = (long long)D * H * W;

  for (int e = tid; e < CI * 27 * CO; e += kThreads) {
    const int co = e % CO, r = e / CO, t = r % 27, ci = r / 27;
    // dx reads the forward's (CI, CO, 27) weight in its own terms, taps flipped
    ws[e] = FLIP ? w[((long long)ci * CO + co) * 27 + (26 - t)]
                 : w[((long long)co * CI + ci) * 27 + t];
  }
  int off[NPRE];                                 // each staged element's offset in a plane
#pragma unroll
  for (int k = 0; k < NPRE; ++k) {
    const int e = tid + k * kThreads;
    const int ww = e % kHW, r = e / kHW, hh = r % kHH, dd = r / kHH;
    const int gd = d0 + dd - 1, gh = h0 + hh - 1, gw = w0 + ww - 1;
    off[k] = (e < TS && gd >= 0 && gd < D && gh >= 0 && gh < H && gw >= 0 && gw < W)
                 ? (gd * H + gh) * W + gw : -1;
  }
  const float* xn = x + (long long)n * CI * plane;
  float pre[NPRE];
  auto load = [&](int ci) {
#pragma unroll
    for (int k = 0; k < NPRE; ++k) pre[k] = off[k] >= 0 ? __ldg(xn + ci * plane + off[k]) : 0.f;
  };
  auto store = [&](int ci, float* dst) {
    float sc = 1.f, sh = 0.f;
    if (ACT) norm_affine(nm.st, nm.gamma, nm.beta, CI, ci, &sc, &sh);
#pragma unroll
    for (int k = 0; k < NPRE; ++k) {
      const int e = tid + k * kThreads;
      if (e < TS) dst[e] = (ACT && off[k] >= 0) ? leaky(fmaf(pre[k], sc, sh), nm.slope) : pre[k];
    }
  };

  float acc[CO][VPT];
#pragma unroll
  for (int co = 0; co < CO; ++co)
#pragma unroll
    for (int v = 0; v < VPT; ++v) acc[co][v] = 0.f;

  load(0);
  store(0, xs);
  __syncthreads();
#pragma unroll 1
  for (int ci = 0; ci < CI; ++ci) {
    if (ci + 1 < CI) load(ci + 1);
    const float* xb = xs + (ci & 1) * TS + ty * kHW + lane;
    const float* wc = ws + ci * 27 * CO;
#pragma unroll 1
    for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        float col[VPT + 2];
#pragma unroll
        for (int dd = 0; dd < VPT + 2; ++dd) col[dd] = xb[(dd * kHH + kh) * kHW + kw];
#pragma unroll
        for (int kd = 0; kd < 3; ++kd) {
          const float* wk = wc + ((kd * 3 + kh) * 3 + kw) * CO;
          if constexpr (CO % 4 == 0) {
#pragma unroll
            for (int c4 = 0; c4 < CO / 4; ++c4) {
              const float4 q = *reinterpret_cast<const float4*>(wk + 4 * c4);
#pragma unroll
              for (int v = 0; v < VPT; ++v) {
                const float a = col[v + kd];
                acc[4 * c4][v] = fmaf(q.x, a, acc[4 * c4][v]);
                acc[4 * c4 + 1][v] = fmaf(q.y, a, acc[4 * c4 + 1][v]);
                acc[4 * c4 + 2][v] = fmaf(q.z, a, acc[4 * c4 + 2][v]);
                acc[4 * c4 + 3][v] = fmaf(q.w, a, acc[4 * c4 + 3][v]);
              }
            }
          } else {
#pragma unroll
            for (int co = 0; co < CO; ++co) {
              const float q = wk[co];
#pragma unroll
              for (int v = 0; v < VPT; ++v) acc[co][v] = fmaf(q, col[v + kd], acc[co][v]);
            }
          }
        }
      }
    }
    if (ci + 1 < CI) store(ci + 1, xs + ((ci + 1) & 1) * TS);
    __syncthreads();
  }

  const int oh = h0 + ty, ow = w0 + lane;
  const bool inside = oh < H && ow < W;
  float* on = out + (long long)n * CO * plane;
  float s1[CO], s2[CO];
#pragma unroll
  for (int co = 0; co < CO; ++co) {
    const float bc = FLIP ? 0.f : __ldg(bias + co);
    s1[co] = 0.f;
    s2[co] = 0.f;
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int od = d0 + v;
      if (inside && od < D) {
        const float val = acc[co][v] + bc;
        on[co * plane + ((long long)od * H + oh) * W + ow] = val;
        s1[co] += val;
        s2[co] = fmaf(val, val, s2[co]);
      }
    }
  }
  if (FLIP) return;
  float* red = xs;                               // free after the loop's last barrier
#pragma unroll
  for (int co = 0; co < CO; ++co) {
    const float a = afk::warp_sum(s1[co]), q = afk::warp_sum(s2[co]);
    if (lane == 0) {
      red[ty * 2 * CO + co] = a;
      red[ty * 2 * CO + CO + co] = q;
    }
  }
  __syncthreads();
  if (tid < 2 * CO) {
    float t = 0.f;
    for (int k = 0; k < kThreads / 32; ++k) t += red[k * 2 * CO + tid];
    part[(long long)blockIdx.x * 2 * CO + tid] = t;
  }
}

template <int CI, int CO, bool ACT>
__global__ void __launch_bounds__(kThreads) p2v_merge_fwd(const float* __restrict__ x, Norm nm,
                                                          const float* __restrict__ w,
                                                          const float* __restrict__ bias,
                                                          float* __restrict__ y,
                                                          float* __restrict__ part, int D, int H,
                                                          int W) {
  tile_body<CI, CO, ACT, false>(x, nm, w, bias, y, part, D, H, W);
}

template <int CI, int CO>
__global__ void __launch_bounds__(kThreads) p2v_merge_dx(const float* __restrict__ g,
                                                         const float* __restrict__ w,
                                                         float* __restrict__ dx, int D, int H,
                                                         int W) {
  tile_body<CI, CO, false, true>(g, Norm{}, w, nullptr, dx, nullptr, D, H, W);
}

template <int CI, int CO>
constexpr int tile_smem_bytes() {
  return (cdiv(CI * 27 * CO, 4) * 4 + 2 * (vpt_for(CO) + 2) * kHH * kHW) * 4;
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int CI, int CO>
int launch_fwd(const float* x, Norm nm, bool act, const float* w, const float* bias, float* y,
               float* part, int N, int D, int H, int W, cudaStream_t st) {
  const int grid = N * cdiv(D, vpt_for(CO)) * cdiv(H, kTH) * cdiv(W, kTW);
  const int bytes = tile_smem_bytes<CI, CO>();
  auto kernel = act ? p2v_merge_fwd<CI, CO, true> : p2v_merge_fwd<CI, CO, false>;
  cudaError_t e = set_smem(kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, bytes, st>>>(x, nm, w, bias, y, part, D, H, W);
  return (int)cudaGetLastError();
}

// dx of a forward block (ci -> co): the body maps co -> ci
template <int CI, int CO>
int launch_dx(const float* g, const float* w, float* dx, int N, int D, int H, int W,
              cudaStream_t st) {
  const int grid = N * cdiv(D, vpt_for(CI)) * cdiv(H, kTH) * cdiv(W, kTW);
  const int bytes = tile_smem_bytes<CO, CI>();
  cudaError_t e = set_smem(p2v_merge_dx<CO, CI>, bytes);
  if (e != cudaSuccess) return (int)e;
  p2v_merge_dx<CO, CI><<<grid, kThreads, bytes, st>>>(g, w, dx, D, H, W);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ dw

constexpr int kDwTD = 2, kDwTH = 8, kDwTW = 32;
// the staged input's halo (4 x 10 x 34) with strides = 3, 9, 27 (mod 32): an
// owner (ci, kd, kh) starts at 3 * (9 ci + 3 kd + kh) (mod 32), so 32
// consecutive owners fall on 32 banks
constexpr int kDwSH = 35, kDwSD = 361, kDwSC = 1467;

__host__ __device__ constexpr int dw_groups(int ci) {
  return ci >= 16 ? 2 : ci >= 8 ? 3 : ci >= 4 ? 4 : 8;
}
__host__ __device__ constexpr int dw_threads(int ci) { return cdiv(ci * 9, 32) * 32 * dw_groups(ci); }

template <int CI, int CO>
constexpr int dw_smem_bytes() {
  return (cdiv(CI * kDwSC, 4) * 4 + CO * kDwTD * kDwTH * kDwTW) * 4;
}

template <int CI, int CO, bool ACT>
__global__ void __launch_bounds__(dw_threads(CI)) p2v_merge_dw(const float* __restrict__ x, Norm nm,
                                                               const float* __restrict__ g,
                                                               float* __restrict__ part, int N,
                                                               int D, int H, int W) {
  constexpr int NOWN = CI * 9, OWNP = cdiv(NOWN, 32) * 32, G = dw_groups(CI);
  constexpr int NT = OWNP * G, ROWS = kDwTD * kDwTH, TV = ROWS * kDwTW;
  constexpr int NCOL = CO * CI * 27;
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                              // [ci][4][10][34], padded strides
  float* gs = smem + cdiv(CI * kDwSC, 4) * 4;    // [co][2][8][32]
  const int tid = threadIdx.x, grp = tid / OWNP, o = tid % OWNP;
  const bool own = o < NOWN;
  const int ci = o / 9, kd = (o / 3) % 3, kh = o % 3;
  const int nwt = cdiv(W, kDwTW), nht = cdiv(H, kDwTH), ndt = cdiv(D, kDwTD);
  const int ntiles = N * ndt * nht * nwt;
  const long long plane = (long long)D * H * W;

  float acc[3][CO], db[CO];
#pragma unroll
  for (int co = 0; co < CO; ++co) {
    db[co] = 0.f;
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) acc[kw][co] = 0.f;
  }
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    int b = t;
    const int w0 = (b % nwt) * kDwTW; b /= nwt;
    const int h0 = (b % nht) * kDwTH; b /= nht;
    const int d0 = (b % ndt) * kDwTD;
    const int n = b / ndt;
    __syncthreads();                             // the last tile's reads are done
    for (int e = tid; e < CI * 4 * kHH * kHW; e += NT) {
      const int ww = e % kHW;
      int r = e / kHW;
      const int hh = r % kHH;
      r /= kHH;
      const int dd = r % 4, c = r / 4;
      const int gd = d0 + dd - 1, gh = h0 + hh - 1, gw = w0 + ww - 1;
      float v = 0.f;
      if (gd >= 0 && gd < D && gh >= 0 && gh < H && gw >= 0 && gw < W) {
        v = __ldg(x + ((long long)n * CI + c) * plane + ((long long)gd * H + gh) * W + gw);
        if (ACT) {
          float sc, sh;
          norm_affine(nm.st, nm.gamma, nm.beta, CI, c, &sc, &sh);
          v = leaky(fmaf(v, sc, sh), nm.slope);
        }
      }
      as[c * kDwSC + dd * kDwSD + hh * kDwSH + ww] = v;
    }
    for (int e = tid; e < CO * TV; e += NT) {
      const int ww = e % kDwTW;
      int r = e / kDwTW;
      const int hh = r % kDwTH;
      r /= kDwTH;
      const int dd = r % kDwTD, c = r / kDwTD;
      const int gd = d0 + dd, gh = h0 + hh, gw = w0 + ww;
      gs[e] = (gd < D && gh < H && gw < W)
                  ? __ldg(g + ((long long)n * CO + c) * plane + ((long long)gd * H + gh) * W + gw)
                  : 0.f;
    }
    __syncthreads();
    if (!own) continue;
    const float* ab = as + ci * kDwSC + kd * kDwSD + kh * kDwSH;
    for (int r = grp; r < ROWS; r += G) {
      const int dd = r / kDwTH, hh = r % kDwTH;
      const float* arow = ab + dd * kDwSD + hh * kDwSH;
      const float* grow = gs + r * kDwTW;
      float a[6];
      a[0] = arow[0];
      a[1] = arow[1];
#pragma unroll 2
      for (int w4 = 0; w4 < kDwTW; w4 += 4) {
#pragma unroll
        for (int j = 2; j < 6; ++j) a[j] = arow[w4 + j];
#pragma unroll
        for (int co = 0; co < CO; ++co) {
          const float4 q = *reinterpret_cast<const float4*>(grow + co * TV + w4);
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            float s = acc[kw][co];
            s = fmaf(a[kw], q.x, s);
            s = fmaf(a[kw + 1], q.y, s);
            s = fmaf(a[kw + 2], q.z, s);
            acc[kw][co] = fmaf(a[kw + 3], q.w, s);
          }
          if (o == 0) db[co] += (q.x + q.y) + (q.z + q.w);
        }
        a[0] = a[4];
        a[1] = a[5];
      }
    }
  }
  // the groups' sums, in order of group
  __syncthreads();
  float* red = smem;                             // [G][NOWN][3][CO], then [G][CO]
  if (own) {
#pragma unroll
    for (int kw = 0; kw < 3; ++kw)
#pragma unroll
      for (int co = 0; co < CO; ++co) red[((grp * NOWN + o) * 3 + kw) * CO + co] = acc[kw][co];
    if (o == 0)
#pragma unroll
      for (int co = 0; co < CO; ++co) red[G * NOWN * 3 * CO + grp * CO + co] = db[co];
  }
  __syncthreads();
  float* prow = part + (long long)blockIdx.x * (NCOL + CO);
  for (int e = tid; e < NOWN * 3 * CO; e += NT) {
    const int co = e % CO, r = e / CO, kw = r % 3, ow = r / 3;
    float s = 0.f;
    for (int q = 0; q < G; ++q) s += red[((q * NOWN + ow) * 3 + kw) * CO + co];
    prow[(co * CI + ow / 9) * 27 + (ow % 9) * 3 + kw] = s;   // (CO, CI, kd, kh, kw)
  }
  if (tid < CO) {
    float s = 0.f;
    for (int q = 0; q < G; ++q) s += red[G * NOWN * 3 * CO + q * CO + tid];
    prow[NCOL + tid] = s;
  }
}

template <int CI, int CO>
int launch_dw(const float* x, Norm nm, bool act, const float* g, float* part, int N, int D,
              int H, int W, cudaStream_t st) {
  const int ntiles = N * cdiv(D, kDwTD) * cdiv(H, kDwTH) * cdiv(W, kDwTW);
  const int grid = ntiles < kPartBlocks ? ntiles : kPartBlocks;
  const int bytes = dw_smem_bytes<CI, CO>();
  auto kernel = act ? p2v_merge_dw<CI, CO, true> : p2v_merge_dw<CI, CO, false>;
  cudaError_t e = set_smem(kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, dw_threads(CI), bytes, st>>>(x, nm, g, part, N, D, H, W);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ norm (pointwise)

enum { kNormAct = 0, kNormReduce = 1, kNormApply = 2 };

// kNormAct: out = leaky(y sc + sh). kNormReduce: part[row] = (sum dz, sum dz
// xhat) per channel, dz = da * leaky'(z). kNormApply: out = k dz + al y + be
// (out may be da). coef (kNormApply): [k, al, be] x C.
template <int MODE>
__global__ void __launch_bounds__(kThreads) p2v_merge_norm(const float* da, const float* __restrict__ y,
                                                           const float* __restrict__ st,
                                                           const float* __restrict__ gamma,
                                                           const float* __restrict__ beta,
                                                           const float* __restrict__ coef,
                                                           float* out, float* __restrict__ part,
                                                           int C, long long plane, float slope) {
  const int chunk = blockIdx.x, c = blockIdx.y, n = blockIdx.z;
  const long long base = ((long long)n * C + c) * plane;
  float sc, sh;
  norm_affine(st, gamma, beta, C, c, &sc, &sh);
  const float mean = st[c], rstd = st[C + c];
  float k = 0.f, al = 0.f, be = 0.f;
  if (MODE == kNormApply) {
    k = coef[c];
    al = coef[C + c];
    be = coef[2 * C + c];
  }
  float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
  for (int j = 0; j < kNormChunk / kThreads; ++j) {
    const long long i = (long long)chunk * kNormChunk + j * kThreads + threadIdx.x;
    if (i >= plane) break;
    const float yv = y[base + i];
    const float z = fmaf(yv, sc, sh);
    if (MODE == kNormAct) {
      out[base + i] = leaky(z, slope);
      continue;
    }
    const float a = da[base + i];
    const float dz = z > 0.f ? a : a * slope;
    if (MODE == kNormReduce) {
      s1 += dz;
      s2 = fmaf(dz, (yv - mean) * rstd, s2);
    } else {
      out[base + i] = fmaf(k, dz, fmaf(al, yv, be));
    }
  }
  if (MODE != kNormReduce) return;
  __shared__ float red[2][kThreads / 32];
  s1 = afk::warp_sum(s1);
  s2 = afk::warp_sum(s2);
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = s1;
    red[1][threadIdx.x >> 5] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, q = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      a += red[0][w];
      q += red[1][w];
    }
    const long long row = (long long)n * gridDim.x + chunk;
    part[row * 2 * C + c] = a;
    part[row * 2 * C + C + c] = q;
  }
}

// ------------------------------------------------------------ sum

enum { kSumPlain = 0, kSumStats = 1, kSumBackward = 2 };

// One warp a column: out[j] = sum over rows of part[r * ld + j] in float64, in
// a fixed order. kSumStats: columns j and n + j are channel j's sum and sum of
// squares over `count` values -> st = [mean (n), rstd (n)]. kSumBackward:
// columns j and n + j are sum dz and sum dz xhat -> coef = [k, al, be] x n
// (dy = k dz + al y + be) and out2 = [dgamma (n), dbeta (n)].
__global__ void __launch_bounds__(kThreads) p2v_merge_sum(const float* __restrict__ part, int rows,
                                                          int ld, int n, int mode,
                                                          const float* __restrict__ gamma,
                                                          const float* __restrict__ st,
                                                          float* __restrict__ out,
                                                          float* __restrict__ out2, long long count,
                                                          float eps) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (j >= n) return;
  double s1 = 0.0, s2 = 0.0;
  for (int r = lane; r < rows; r += 32) {
    s1 += part[(long long)r * ld + j];
    if (mode != kSumPlain) s2 += part[(long long)r * ld + n + j];
  }
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  if (lane != 0) return;
  const double m = (double)count;
  if (mode == kSumPlain) {
    out[j] = (float)s1;
  } else if (mode == kSumStats) {
    const double mean = s1 / m;
    const double var = fmax(s2 / m - mean * mean, 0.0);
    out[j] = (float)mean;
    out[n + j] = (float)(1.0 / sqrt(var + (double)eps));
  } else {
    const double rstd = st[n + j], k = (double)gamma[j] * rstd;
    const double al = -k * rstd * s2 / m;
    out[j] = (float)k;
    out[n + j] = (float)al;
    out[2 * n + j] = (float)(-k * s1 / m - al * (double)st[j]);
    out2[j] = (float)s2;
    out2[n + j] = (float)s1;
  }
}

// ------------------------------------------------------------ up5's weight gradient

constexpr int kUpCI = 32, kUpCO = 8;
constexpr int kUpTD = 2, kUpTH = 4, kUpTW = 16;             // tile of the 64^3 grid
constexpr int kUpXD = kUpTD + 2, kUpXH = kUpTH + 2, kUpXW = kUpTW + 2;
constexpr int kUpXV = kUpXD * kUpXH * kUpXW;                // 432 staged input voxels
constexpr int kUpXS = 36;                                   // floats per staged voxel
constexpr int kUpJ = kUpTD * kUpTH * kUpTW;                 // 128 voxels j a tile
constexpr int kUpGS = kUpJ * kUpCO + 4;                     // floats per parity class
constexpr int kUpSmem = (kUpXV * kUpXS + 8 * kUpGS) * 4;
constexpr int kUpCols = kUpCI * kUpCO * 64;

// tap of an axis from the output parity p and the input offset bit b
// (delta = 0, or -1 for p = 0 and +1 for p = 1): k = p + 1 - 2 delta
__device__ __forceinline__ int up_delta(int p, int b) { return b ? (p ? 1 : -1) : 0; }
__device__ __forceinline__ int up_tap(int p, int b) { return p + 1 - 2 * up_delta(p, b); }

__global__ void __launch_bounds__(kThreads) p2v_up_dw(const float* __restrict__ x,
                                                      const float* __restrict__ g,
                                                      float* __restrict__ part, int N, int D,
                                                      int H, int W) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                              // [voxel][ci], 36 floats a voxel
  float* gs = smem + kUpXV * kUpXS;              // [parity][j][co]
  const int tid = threadIdx.x, cig = tid & 7, cgp = tid >> 3;
  const int p = cgp >> 2, bd = (cgp >> 1) & 1, bh = cgp & 1;
  const int pd = p >> 2, ph = (p >> 1) & 1, pw = p & 1;
  const int dd = up_delta(pd, bd) + 1, dh = up_delta(ph, bh) + 1;
  const int dw0 = 1, dw1 = up_delta(pw, 1) + 1;
  const int Do = 2 * D, Ho = 2 * H, Wo = 2 * W;
  const long long plane = (long long)D * H * W, oplane = 8 * plane;
  const int nwt = cdiv(W, kUpTW), nht = cdiv(H, kUpTH), ndt = cdiv(D, kUpTD);
  const int ntiles = N * ndt * nht * nwt;

  float acc[2][4][kUpCO];
#pragma unroll
  for (int bw = 0; bw < 2; ++bw)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int co = 0; co < kUpCO; ++co) acc[bw][c][co] = 0.f;

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    int b = t;
    const int w0 = (b % nwt) * kUpTW; b /= nwt;
    const int h0 = (b % nht) * kUpTH; b /= nht;
    const int d0 = (b % ndt) * kUpTD;
    const int n = b / ndt;
    __syncthreads();
    for (int e = tid; e < kUpCI * kUpXV; e += kThreads) {
      const int v = e % kUpXV, c = e / kUpXV;
      const int vw = v % kUpXW, vh = (v / kUpXW) % kUpXH, vd = v / (kUpXW * kUpXH);
      const int gd = d0 + vd - 1, gh = h0 + vh - 1, gw = w0 + vw - 1;
      xs[v * kUpXS + c] =
          (gd >= 0 && gd < D && gh >= 0 && gh < H && gw >= 0 && gw < W)
              ? __ldg(x + ((long long)n * kUpCI + c) * plane + ((long long)gd * H + gh) * W + gw)
              : 0.f;
    }
    for (int e = tid; e < kUpCO * 8 * kUpJ; e += kThreads) {
      const int ow = e % (2 * kUpTW);
      int r = e / (2 * kUpTW);
      const int oh = r % (2 * kUpTH);
      r /= 2 * kUpTH;
      const int od = r % (2 * kUpTD), c = r / (2 * kUpTD);
      const int gd = 2 * d0 + od, gh = 2 * h0 + oh, gw = 2 * w0 + ow;
      const int par = ((od & 1) * 2 + (oh & 1)) * 2 + (ow & 1);
      const int jl = ((od >> 1) * kUpTH + (oh >> 1)) * kUpTW + (ow >> 1);
      gs[par * kUpGS + jl * kUpCO + c] =
          (gd < Do && gh < Ho && gw < Wo)
              ? __ldg(g + ((long long)n * kUpCO + c) * oplane + ((long long)gd * Ho + gh) * Wo + gw)
              : 0.f;
    }
    __syncthreads();
    const float* gp = gs + p * kUpGS;
#pragma unroll 1
    for (int jr = 0; jr < kUpTD * kUpTH; ++jr) {
      const int jd = jr / kUpTH, jh = jr % kUpTH;
      const float* xrow = xs + ((jd + dd) * kUpXH + (jh + dh)) * kUpXW * kUpXS + 4 * cig;
#pragma unroll 4
      for (int jw = 0; jw < kUpTW; ++jw) {
        const float* gq = gp + (jr * kUpTW + jw) * kUpCO;
        const float4 g0 = *reinterpret_cast<const float4*>(gq);
        const float4 g1 = *reinterpret_cast<const float4*>(gq + 4);
        const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
        for (int bw = 0; bw < 2; ++bw) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xrow + (jw + (bw ? dw1 : dw0)) * kUpXS);
          const float xc[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int co = 0; co < kUpCO; ++co) acc[bw][c][co] = fmaf(xc[c], gv[co], acc[bw][c][co]);
        }
      }
    }
  }
  // weight layout (CI, CO, 4, 4, 4); this thread owns 4 ci x 8 co x 2 kw
  float* prow = part + (long long)blockIdx.x * kUpCols;
  const int kd = up_tap(pd, bd), kh = up_tap(ph, bh);
#pragma unroll
  for (int bw = 0; bw < 2; ++bw) {
    const int kw = up_tap(pw, bw);
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int co = 0; co < kUpCO; ++co)
        prow[(((4 * cig + c) * kUpCO + co) * 4 + kd) * 16 + kh * 4 + kw] = acc[bw][c][co];
  }
}

}  // namespace

// ------------------------------------------------------------ C interface

// Rows of partials a launch writes: kind 0 p2v_merge_fwd (2 co columns each),
// 1 p2v_merge_dw (co * ci * 27 + co columns), 2 p2v_merge_norm (per channel),
// 3 p2v_up_dw (32 * 8 * 64 columns). ci, co: the forward block's channels.
extern "C" int afk_p2v_rows(int kind, int N, int ci, int co, int D, int H, int W) {
  switch (kind) {
    case 0: return N * cdiv(D, vpt_for(co)) * cdiv(H, kTH) * cdiv(W, kTW);
    case 1: {
      const int t = N * cdiv(D, kDwTD) * cdiv(H, kDwTH) * cdiv(W, kDwTW);
      return t < kPartBlocks ? t : kPartBlocks;
    }
    case 2: return N * (int)(((long long)D * H * W + kNormChunk - 1) / kNormChunk);
    case 3: {
      const int t = N * cdiv(D, kUpTD) * cdiv(H, kUpTH) * cdiv(W, kUpTW);
      return t < kPartBlocks ? t : kPartBlocks;
    }
    default: return -1;
  }
}

#define P2V_BLOCKS(X) X(9, 16) X(16, 8) X(8, 4) X(4, 2) X(2, 1)

// y = conv(act(x)) + bias and its per-tile channel sums; act: the previous
// block's norm (st = [mean, rstd], gamma, beta) and leaky-ReLU, or none.
extern "C" int afk_p2v_merge_fwd(const float* x, const float* st, const float* gamma,
                                 const float* beta, const float* w, const float* bias, float* y,
                                 float* part, int N, int ci, int co, int D, int H, int W, int act,
                                 float slope, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Norm nm{st, gamma, beta, slope};
#define X(A, B) \
  if (ci == A && co == B) return launch_fwd<A, B>(x, nm, act, w, bias, y, part, N, D, H, W, s);
  P2V_BLOCKS(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// the input gradient of a forward block (ci -> co): g (N, co, ...) -> dx (N, ci, ...)
extern "C" int afk_p2v_merge_dx(const float* g, const float* w, float* dx, int N, int ci, int co,
                                int D, int H, int W, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define X(A, B) \
  if (ci == A && co == B) return launch_dx<A, B>(g, w, dx, N, D, H, W, s);
  P2V_BLOCKS(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// weight and bias gradients of a forward block: partial rows of (co, ci, 27) + co
extern "C" int afk_p2v_merge_dw(const float* x, const float* st, const float* gamma,
                                const float* beta, const float* g, float* part, int N, int ci,
                                int co, int D, int H, int W, int act, float slope, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Norm nm{st, gamma, beta, slope};
#define X(A, B) \
  if (ci == A && co == B) return launch_dw<A, B>(x, nm, act, g, part, N, D, H, W, s);
  P2V_BLOCKS(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

extern "C" int afk_p2v_merge_norm(const float* da, const float* y, const float* st,
                                  const float* gamma, const float* beta, const float* coef,
                                  float* out, float* part, int N, int C, int D, int H, int W,
                                  int mode, float slope, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long plane = (long long)D * H * W;
  const dim3 grid((unsigned)((plane + kNormChunk - 1) / kNormChunk), C, N);
  switch (mode) {
    case kNormAct:
      p2v_merge_norm<kNormAct><<<grid, kThreads, 0, s>>>(da, y, st, gamma, beta, coef, out, part,
                                                         C, plane, slope);
      break;
    case kNormReduce:
      p2v_merge_norm<kNormReduce><<<grid, kThreads, 0, s>>>(da, y, st, gamma, beta, coef, out,
                                                            part, C, plane, slope);
      break;
    case kNormApply:
      p2v_merge_norm<kNormApply><<<grid, kThreads, 0, s>>>(da, y, st, gamma, beta, coef, out,
                                                           part, C, plane, slope);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int afk_p2v_merge_sum(const float* part, int rows, int ld, int n, int mode,
                                 const float* gamma, const float* st, float* out, float* out2,
                                 long long count, float eps, void* stream) {
  const int warps = kThreads / 32;
  p2v_merge_sum<<<cdiv(n, warps), kThreads, 0, (cudaStream_t)stream>>>(
      part, rows, ld, n, mode, gamma, st, out, out2, count, eps);
  return (int)cudaGetLastError();
}

// up5's weight gradient: x (N, 32, D, H, W), g (N, 8, 2D, 2H, 2W) -> partial
// rows of the (32, 8, 4, 4, 4) gradient
extern "C" int afk_p2v_up_dw(const float* x, const float* g, float* part, int N, int D, int H,
                             int W, void* stream) {
  const int ntiles = N * cdiv(D, kUpTD) * cdiv(H, kUpTH) * cdiv(W, kUpTW);
  const int grid = ntiles < kPartBlocks ? ntiles : kPartBlocks;
  cudaError_t e = set_smem(p2v_up_dw, kUpSmem);
  if (e != cudaSuccess) return (int)e;
  p2v_up_dw<<<grid, kThreads, kUpSmem, (cudaStream_t)stream>>>(x, g, part, N, D, H, W);
  return (int)cudaGetLastError();
}
