// nms_keep: greedy IoU suppression of score-sorted boxes for Hopper
// (sm_90a), one block per image. The counterpart of the JAX package's
// ops/nms.nms_suppress under jax.vmap (batched_nms), an XLA fori_loop of
// K steps inside the host Detector's jitted step (no pl.pallas_call);
// written as plain PyTorch that loop is about 3 K small launches a frame.
//
//   boxes (S, K, 4) float32 x1 y1 x2 y2, scores (S, K) float32, classes
//   (S, K) float32 or null, threshold t -> keep (S, K) uint8.
//
// Row i is kept iff its score is above -inf and no kept row j < i has
// IoU(i, j) > t. With classes, every box is first shifted by
// class * 1e4 (batched_nms' class-offset trick: boxes of different
// classes never overlap).
//
// Design. The block copies its image's K boxes (shifted) and their areas
// into shared memory, with the initial keep bits (score > -inf) as K / 32
// words. Then:
//   1. parallel pass: the block's 32 warps take the rows in turn and
//      each row's words w with 32 w < i; lane l computes IoU(i, 32 w + l)
//      for 32 w + l < i and a ballot writes the word of columns that
//      overlap row i past t. That is the whole K x K / 2 product, off the
//      chain, on one SM: at K = 1024 it is most of the kernel's time.
//   2. serial pass: one warp sweeps the rows in order; lane l holds keep
//      word l in a register. Row i reads its words (lane l word l), ANDs
//      them with the keep words, and one vote says whether a kept row
//      above it overlaps; if so, the lane holding row i's bit clears it.
//      One shared-memory read and one vote a row: the chain that bounds
//      the kernel at small K.
// Shared memory: 16 K (boxes) + 4 K (areas) + 4 K ceil(K / 32) (the
// words) + 4 ceil(K / 32) bytes: 3.6 KB at K = 100, 148 KB at K = 1024,
// the largest K the kernel takes (one keep word a lane).
//
// The IoU is JAX's float32 arithmetic operation by operation, each
// rounded explicitly (no FMA): area = max(x2 - x1, 0) * max(y2 - y1, 0),
// inter = max(min(x2) - max(x1), 0) * max(min(y2) - max(y1), 0),
// union = (area_i + area_j) - inter, IoU = union > 0 ?
// inter / max(union, 1e-9) : 0, with max / min NaN-propagating as
// jnp.maximum and torch.maximum are; so the keep mask is the plain
// version's bit for bit. The launcher takes device pointers, the
// threshold as its float32 bits in an int, and the stream; it allocates
// nothing, does not synchronise, and returns cudaGetLastError() as an int
// (0 = ok), cudaErrorInvalidValue for a K it does not take.

#include <cuda_runtime.h>
#include <cstdint>
#include <cstring>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 1024;
constexpr int kThreads = 1024;

// torch.maximum / jnp.maximum: NaN if either operand is NaN (PTX's
// max.NaN, sm_80 and later)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(max_nan(__fsub_rn(b.z, b.x), 0.f),
                   max_nan(__fsub_rn(b.w, b.y), 0.f));
}

// IoU(i, j) > t in JAX's order: union = (area_i + area_j) - inter
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b,
                                         float area_b, float t) {
  const float iw = max_nan(__fsub_rn(min_nan(a.z, b.z), max_nan(a.x, b.x)),
                           0.f);
  const float ih = max_nan(__fsub_rn(min_nan(a.w, b.w), max_nan(a.y, b.y)),
                           0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  const float iou = uni > 0.f ? __fdiv_rn(inter, max_nan(uni, 1e-9f)) : 0.f;
  return iou > t;
}

size_t nms_smem(int k) {
  const int words = (k + 31) / 32;
  return (size_t)k * 16 + (size_t)k * 4 + (size_t)k * words * 4 +
         (size_t)words * 4;
}

__global__ void __launch_bounds__(kThreads)
    nms_keep_kernel(const float* __restrict__ boxes,
                    const float* __restrict__ scores,
                    const float* __restrict__ classes,
                    uint8_t* __restrict__ keep, int k, float t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (k + 31) / 32;
  float4* box = reinterpret_cast<float4*>(smem);
  float* area = reinterpret_cast<float*>(box + k);
  uint32_t* over = reinterpret_cast<uint32_t*>(area + k);  // k x words
  uint32_t* kept = over + (size_t)k * words;               // words
  const int image = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  boxes += (size_t)image * k * 4;
  scores += (size_t)image * k;
  keep += (size_t)image * k;

  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    float4 b = reinterpret_cast<const float4*>(boxes)[i];
    if (classes != nullptr) {
      const float off = __fmul_rn(classes[(size_t)image * k + i], 1e4f);
      b.x = __fadd_rn(b.x, off);
      b.y = __fadd_rn(b.y, off);
      b.z = __fadd_rn(b.z, off);
      b.w = __fadd_rn(b.w, off);
    }
    box[i] = b;
    area[i] = box_area(b);
  }
  for (int w = warp; w < words; w += warps) {
    const int i = 32 * w + lane;
    const float minus_inf = -__int_as_float(0x7f800000);
    const unsigned bits = __ballot_sync(kFull, i < k && scores[i] > minus_inf);
    if (lane == 0) kept[w] = bits;
  }
  __syncthreads();

  // 1. the overlap words of every row against the rows above it: rows
  // round-robin over the warps, a row's words (32 w < i) in turn
  for (int i = warp; i < k; i += warps) {
    const float4 bi = box[i];
    const float ai = area[i];
    for (int w = 0; 32 * w < i; ++w) {
      const int j = 32 * w + lane;
      const bool hit = j < i && overlaps(bi, ai, box[j], area[j], t);
      const unsigned bits = __ballot_sync(kFull, hit);
      if (lane == 0) over[(size_t)i * words + w] = bits;
    }
  }
  __syncthreads();

  // 2. one warp sweeps the rows in order; lane l holds keep word l
  if (warp == 0) {
    unsigned mine = lane < words ? kept[lane] : 0u;
    for (int i = 1; i < k; ++i) {
      const int above = (i + 31) / 32;  // the words holding rows j < i
      const unsigned hit =
          lane < above ? over[(size_t)i * words + lane] & mine : 0u;
      if (__any_sync(kFull, hit != 0u) && lane == (i >> 5))
        mine &= ~(1u << (i & 31));
    }
    if (lane < words) kept[lane] = mine;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += blockDim.x)
    keep[i] = (uint8_t)((kept[i >> 5] >> (i & 31)) & 1u);
}

}  // namespace

// keep (S, K) uint8 of boxes (S, K, 4), scores (S, K) and optional
// classes (S, K), all contiguous float32; threshold_bits is the float32
// threshold's bit pattern.
extern "C" int nms_keep(const float* boxes, const float* scores,
                        const float* classes, uint8_t* keep, int S, int K,
                        int threshold_bits, void* stream) {
  if (S <= 0 || K <= 0) return (int)cudaSuccess;
  if (K > kMaxK) return (int)cudaErrorInvalidValue;
  const size_t smem = nms_smem(K);
  // past the default 48 KB the limit is raised on every such call: the
  // attribute is the current device's, and the call is cheap
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  float threshold;
  std::memcpy(&threshold, &threshold_bits, sizeof threshold);
  nms_keep_kernel<<<S, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      boxes, scores, classes, keep, K, threshold);
  return (int)cudaGetLastError();
}
