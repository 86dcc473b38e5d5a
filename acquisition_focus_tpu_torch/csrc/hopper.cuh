// Hopper building blocks of the port's bf16 conv kernels (K3 csrc/conv3d.cu, K4
// csrc/conv3d_wgrad.cu): mbarriers, TMA tensor loads, wgmma shared-memory
// descriptors and the m64nNk16 bf16 wgmma instructions, and the host-side
// encoding of a tiled tensor map. Plain PTX, no CUTLASS: the build stays in
// seconds. Everything here needs sm_90a.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace afk {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase differs from `parity`. A wait that has not
// completed after ~2^34 cycles (seconds) traps, so a wrong phase or byte count
// ends the launch with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

// ------------------------------------------------------------------ TMA loads

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Load the box at coordinates (c0 innermost .. c4) of a 5-D map into dst;
// elements outside the tensor arrive as zeros. Completion counts the box's
// bytes on `bar`.
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ------------------------------------------------------------------ wgmma

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle of the layout (1: 128 B, 2: 64 B,
// 3: 32 B), which must be the swizzle the TMA load wrote it with.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes, uint32_t swizzle) {
  uint64_t d = 0;
  d |= (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)swizzle << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D (64 x N, f32, in registers) += A (64 x 16) * B (16 x N), bf16 from shared
// memory. TA = 0: A is K-major (K contiguous); TA = 1: A is M-major. B is
// K-major. Accumulator layout per thread t of the warpgroup (warp w = t / 32,
// lane l = t % 32): d[4 j + 2 i + e] is row 16 w + l / 4 + 8 i, column
// 8 j + 2 (l % 4) + e.
template <int TA>
__device__ __forceinline__ void wgmma_m64n16(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", %8, %9, p, 1, 1, %11, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

template <int TA>
__device__ __forceinline__ void wgmma_m64n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, %19, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

template <int TA>
__device__ __forceinline__ void wgmma_m64n48(float (&d)[24], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}"
      ", %24, %25, p, 1, 1, %27, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

template <int TA>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, %35, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

template <int TA>
__device__ __forceinline__ void wgmma_m64n96(float (&d)[48], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"
      ", %48, %49, p, 1, 1, %51, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

template <int N, int TA>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 16) wgmma_m64n16<TA>(d, da, db);
  else if constexpr (N == 32) wgmma_m64n32<TA>(d, da, db);
  else if constexpr (N == 48) wgmma_m64n48<TA>(d, da, db);
  else if constexpr (N == 64) wgmma_m64n64<TA>(d, da, db);
  else { static_assert(N == 96, "wgmma: N in {16, 32, 48, 64, 96}"); wgmma_m64n96<TA>(d, da, db); }
}

// ------------------------------------------------------------------ channels-last staging

// TMA takes the start coordinate of a box's innermost (contiguous) dimension
// only at 16-byte multiples (a one-voxel shift along w in NCDHW is an illegal
// instruction, measured on the H100), so the conv kernels read their shifted
// operand channels-last: xcl (B, D*H*W, C8) from x (B, C, D*H*W), channels
// zero-padded to C8 = C rounded up to 8 (TMA's 16-byte stride rule). One block
// moves a 64-channel x 64-voxel tile through shared memory, reading 16 bytes
// (8 voxels) and writing 16 bytes (8 channels) a thread; the 16-byte chunks of a
// tile row are XOR-swizzled by the row's channel octet, so the transposed reads
// spread over the banks. S % 8 == 0.
static __global__ void __launch_bounds__(256)
channels_last_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ xcl,
                     int C, int C8, long long S) {
  __shared__ __align__(16) __nv_bfloat16 tile[64][64];
  const long long s0 = (long long)blockIdx.x * 64;
  const int c0 = blockIdx.y * 64, b = blockIdx.z;
  for (int e = threadIdx.x; e < 64 * 8; e += 256) {
    const int cl = e / 8, v = e % 8;
    const int c = c0 + cl;
    const long long s = s0 + 8 * v;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (c < C && s < S) val = *(const uint4*)(x + ((long long)b * C + c) * S + s);
    *(uint4*)&tile[cl][8 * (v ^ (cl / 8))] = val;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 64 * 8; e += 256) {
    const int sl = e / 8, v = e % 8;
    const int c = c0 + 8 * v;
    const long long s = s0 + sl;
    if (c >= C8 || s >= S) continue;
    __align__(16) __nv_bfloat16 vals[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) vals[k] = tile[8 * v + k][8 * ((sl / 8) ^ v) + sl % 8];
    *(uint4*)(xcl + ((long long)b * S + s) * C8 + c) = *(const uint4*)vals;
  }
}

inline int channels_last(const void* x, void* xcl, int B, int C, int C8, long long S,
                         cudaStream_t st) {
  if (S % 8) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((S + 63) / 64), (C8 + 63) / 64, B);
  channels_last_kernel<<<grid, 256, 0, st>>>((const __nv_bfloat16*)x, (__nv_bfloat16*)xcl, C,
                                              C8, S);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ host: tensor maps

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// A bf16 tensor map of `rank` dims (dims[0] contiguous), loading boxes of `box`
// elements with zero fill outside the tensor. `strides` gives the byte strides
// of dims 1 .. rank-1, in any order (a map may walk an outer axis before an
// inner one); nullptr means a dense tensor in dims order.
// cuTensorMapEncodeTiled is a driver call, fetched through the runtime so the
// library needs no -lcuda. Returns a cudaError_t value.
inline int encode_bf16_map(CUtensorMap* map, const void* base, int rank, const long long* dims,
                           const long long* strides, const int* box,
                           CUtensorMapSwizzle swizzle) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorNotSupported;
    encode = (EncodeTiledFn)fn;
  }
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t bdim[5], estride[5];
  long long stride = 2;
  for (int i = 0; i < rank; ++i) {
    gdim[i] = (cuuint64_t)dims[i];
    bdim[i] = (cuuint32_t)box[i];
    estride[i] = 1;
    if (i > 0) gstride[i - 1] = (cuuint64_t)(strides ? strides[i - 1] : stride);
    stride *= dims[i];
  }
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                      const_cast<void*>(base), gdim, gstride, bdim, estride,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

inline int num_sms() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 132;
}

}  // namespace hopper
}  // namespace afk
