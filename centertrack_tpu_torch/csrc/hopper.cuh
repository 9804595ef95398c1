// Hopper (sm_90a) building blocks shared by the bf16 DCN kernels
// (dcn_local_bf16.cu, dcn_local_bwd_bf16.cu): asynchronous global ->
// shared copies (cp.async, 16 bytes, zero-filled past the source), the
// shared-memory matrix descriptor of wgmma for the layout without swizzle,
// and one warpgroup product, m64n64k16 bf16 x bf16 -> float32.
//
// Operand layout in shared memory ("interleaved", no swizzle): a core
// matrix is 8 rows of 16 bytes (8 bf16), stored as 128 contiguous bytes.
// An operand tile is a grid of core matrices; the descriptor carries the
// byte stride between core matrices along K (LBO) and along M or N (SBO).
// A K-major operand holds, in each 16-byte row, 8 consecutive K values of
// one M (or N) index; an MN-major one (B with trans-b = 1) 8 consecutive
// N values of one K index.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; the bytes past `src_bytes` (0 or 16) are
// zero-filled and not read, so `src` need only be a valid address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 8 consecutive bf16 at `src` into the 16 bytes at `dst`: a cp.async
// when all 8 are live and the source is 16-byte aligned, else `live`
// (0-8) values by plain loads and stores, zeros after them.
__device__ __forceinline__ void copy8(void* dst, const __nv_bfloat16* src,
                                      int live, bool aligned) {
  if (live >= 8 && aligned) {
    cp_async16(dst, src, 16);
  } else if (live <= 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  } else {
    __nv_bfloat16 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = i < live ? src[i] : __float2bfloat16(0.f);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
  }
}

// Makes this thread's generic-proxy writes to shared memory (st.shared,
// cp.async) visible to the async proxy that wgmma reads through; a
// barrier after it publishes them to the warpgroup.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of an interleaved (no swizzle) operand starting at `p`.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous product.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64 float32, the warpgroup's fragments) += A (64 x 16, K-major)
// * B (16 x 64; K-major when TRANS_B = 0, MN-major when 1); with
// accumulate = 0 the product overwrites d. Thread T of the warpgroup
// holds, for j = 0..7, rows 16 (T / 32) + (T % 32) / 4 (+ 8) and columns
// 8 j + 2 (T % 4) (+ 1): d[4 j + 2 h + e] is row + 8 h, column + e.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

}  // namespace hopper

// Phase counters of the bf16 DCN kernels, read by
// centertrack_tpu_torch/tools/dcn_bf16_phases.py. Built with -DDCN_PHASES,
// a kernel's thread 0 of each block adds the clock64() cycles between its
// DCN_PHASE(k) marks to slot k of dcn_phase_cycles, and dcn_read_phases
// copies and clears the slots; otherwise the marks compile to nothing.
#ifdef DCN_PHASES
__device__ unsigned long long dcn_phase_cycles[8];
#define DCN_PHASES_BEGIN               \
  unsigned long long dcn_p[8] = {};    \
  unsigned long long dcn_c0 = clock64()
#define DCN_PHASE(k)                                \
  do {                                              \
    const unsigned long long dcn_c1 = clock64();    \
    dcn_p[k] += dcn_c1 - dcn_c0;                    \
    dcn_c0 = dcn_c1;                                \
  } while (0)
#define DCN_PHASES_END                                         \
  do {                                                         \
    if (threadIdx.x == 0)                                      \
      for (int k = 0; k < 8; ++k)                              \
        atomicAdd(&dcn_phase_cycles[k], dcn_p[k]);             \
  } while (0)
extern "C" int dcn_read_phases(unsigned long long* out) {
  const unsigned long long zero[8] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, dcn_phase_cycles,
                                         sizeof(zero));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(dcn_phase_cycles, zero, sizeof(zero));
  return (int)err;
}
#else
#define DCN_PHASES_BEGIN
#define DCN_PHASE(k)
#define DCN_PHASES_END
#endif
