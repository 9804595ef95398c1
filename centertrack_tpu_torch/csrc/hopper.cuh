// Hopper (sm_90a) building blocks shared by the DCN kernels
// (dcn_local.cu, dcn_local_bwd.cu, dcn_local_bf16.cu, dcn_local_bwd_bf16.cu):
// asynchronous global -> shared copies (cp.async, 16 bytes, zero-filled
// past the source), the shared-memory matrix descriptor of wgmma for the
// layout without swizzle, the warpgroup products m64nNk16 bf16 x bf16 ->
// float32 (N = 32, 64; either operand K-major or MN-major), and the TF32
// products m64nNk8 (N = 8, 16, 32, 64) with the
// hi/lo split by which the float32 kernels run them three times
// ("3xTF32") to keep float32 accuracy.
//
// Operand layout in shared memory ("interleaved", no swizzle): a core
// matrix is 8 rows of 16 bytes (8 bf16 or 4 tf32), stored as 128
// contiguous bytes. An operand tile is a grid of core matrices; the
// descriptor carries the byte stride between core matrices along K (LBO)
// and along M or N (SBO). A K-major operand holds, in each 16-byte row,
// consecutive K values of one M (or N) index (8 bf16, 4 tf32); an
// MN-major one (bf16 B with trans-b = 1) 8 consecutive N values of one K
// index (bf16 A with trans-a = 1 likewise: 8 consecutive M values). TF32
// operands are K-major only: wgmma has no transpose for them.

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

// Waits until at most one committed product of this warpgroup is in
// flight: the one before it is done.
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous product.
template <int NACC>
__device__ __forceinline__ void fence_acc(float (&d)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N float32, the warpgroup's fragments; N / 2 per thread) += A
// (64 x 16 bf16) * B (16 x N bf16), N = 64 or 32; A K-major when TRANS_A
// = 0, MN-major (8 consecutive M values of one K index per 16-byte row)
// when 1; B K-major when TRANS_B = 0, MN-major when 1. With accumulate =
// 0 the product overwrites d. Thread T of the warpgroup holds, for j =
// 0..N/8-1, rows 16 (T / 32) + (T % 32) / 4 (+ 8) and columns 8 j + 2 (T %
// 4) (+ 1): d[4 j + 2 h + e] is row + 8 h, column + e.
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_A), "n"(TRANS_B));
}

template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_bf16_n32(float (&d)[16], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p, 1, 1, %19, %20;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_A), "n"(TRANS_B));
}

template <int N, int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, int accumulate) {
  static_assert(N == 64 || N == 32, "wgmma_bf16: N is 64 or 32");
  if constexpr (N == 64)
    wgmma_bf16_n64<TRANS_A, TRANS_B>(d, da, db, accumulate);
  else
    wgmma_bf16_n32<TRANS_A, TRANS_B>(d, da, db, accumulate);
}

// d (64 x 64) += A (64 x 16, K-major) * B (16 x 64; K-major when TRANS_B
// = 0, MN-major when 1)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  wgmma_bf16_n64<0, TRANS_B>(d, da, db, accumulate);
}

// 4 consecutive float32 at `src` into the 16 bytes at `dst`: a cp.async
// when all 4 are live and the source is 16-byte aligned, else the first
// min(live, 4) values by plain loads and stores, zeros after them.
__device__ __forceinline__ void copy4(void* dst, const float* src, int live,
                                      bool aligned) {
  if (live >= 4 && aligned) {
    cp_async16(dst, src, 16);
  } else if (live <= 0) {
    *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = i < live ? src[i] : 0.f;
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// v rounded to nearest (ties away) to TF32, 10 mantissa bits, as a float
// whose low 13 bits are 0.
__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// v = hi + lo + e with hi, lo TF32 and |e| <= 2^-22 |v|: the operands of
// 3xTF32, a * b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi (the dropped a_lo
// b_lo and the roundings are ~2^-21 of |a b|, float32's own size).
__device__ __forceinline__ float4 tf32_hi(float4 v) {
  return make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z),
                     tf32_rna(v.w));
}
__device__ __forceinline__ float4 tf32_lo(float4 v, float4 hi) {
  return make_float4(tf32_rna(v.x - hi.x), tf32_rna(v.y - hi.y),
                     tf32_rna(v.z - hi.z), tf32_rna(v.w - hi.w));
}

// d (64 x N float32, the warpgroup's fragments; N / 2 per thread) += A
// (64 x 8 tf32, K-major) * B (8 x N tf32, K-major). Thread T of the
// warpgroup holds, for j = 0..N/8-1, rows 16 (T / 32) + (T % 32) / 4
// (+ 8) and columns 8 j + 2 (T % 4) (+ 1): d[4 j + 2 h + e] is row + 8 h,
// column + e, as in wgmma_m64n64k16. With accumulate = 0 the product
// overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[4], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A * B in 3xTF32 (d = A * B with accumulate = 0): A and B given
// as their hi and lo parts (each a K-major tile of the layout above,
// `tf32_hi` / `tf32_lo`); the two small products first.
template <int N>
__device__ __forceinline__ void wgmma_3xtf32(float (&d)[N / 2],
                                             uint64_t a_hi, uint64_t a_lo,
                                             uint64_t b_hi, uint64_t b_lo,
                                             int accumulate = 1) {
  wgmma_tf32<N>(d, a_lo, b_hi, accumulate);
  wgmma_tf32<N>(d, a_hi, b_lo, 1);
  wgmma_tf32<N>(d, a_hi, b_hi, 1);
}

}  // namespace hopper

// Phase counters of the DCN kernels, read by
// centertrack_tpu_torch/tools/dcn_phases.py. Built with -DDCN_PHASES,
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
