// Exact modulated 3x3 deformable convolution (DCNv2), forward, at float32
// (`dcn_exact_fwd`) and at bfloat16 (`dcn_exact_fwd_bf16`), for Hopper
// (sm_90a).
//
// Computes, for every output pixel p = (b, y, x) and output channel o,
//
//   out[p, o] = bias[o] + sum_t sum_c  A_t(p, c) * w[t, c, o]
//   A_t(p, c) = sum_k  cw_k(p, t) * x[b, corner_k(p, t), c]
//
// where tap t = 3*i + j sits at (i - 1, j - 1) and its offset (dy, dx) =
// offset[p, 2t], offset[p, 2t + 1] is not clamped: the sample position is
// the absolute float32 py = (y + i - 1) + dy, rounded once, clipped to
// [-1, H] (px likewise to [-1, W]); y0 = floor(py), fy = py - y0; the
// four corners (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1) carry
// the weights ((1 - fy) * (1 - fx)) * m, ((1 - fy) * fx) * m,
// (fy * (1 - fx)) * m, (fy * fx) * m with m = mask[p, t], and a corner
// outside the map reads 0. Stride 1, padding 1, dilation 1. Layouts are
// the JAX package's: x (B, H, W, Cin), offset (B, H, W, 18) interleaved
// (dy, dx) per tap with taps row-major, mask (B, H, W, 9), w (3, 3, Cin,
// Cout), out (B, H, W, Cout), all contiguous.
//
// That is the arithmetic of the JAX package's exact op in the order it
// rounds (centertrack_tpu/ops/dcn.py `_deform_conv2d_slot`, and the plain
// version ops/dcn.deform_conv2d_plain of this package): the position is
// clipped before its integer cast, so any offset (1e6, or past the map)
// is taken. The sample A_t is built term by term in the plain version's
// order without fused multiply-adds, so it matches it bit for bit and
// only the float32 summation order of the contraction differs. At
// bfloat16 every input is read as float32, A_t is rounded to bf16 before
// the contraction, which runs on the tensor cores (wmma 16x16x16 bf16,
// float32 accumulation), the bias is added in float32 and the sum is
// rounded to bf16 once: where the JAX op rounds.
//
// Replaces centertrack_tpu/ops/dcn.py:315 `deform_conv2d`, which has no
// Pallas kernel: XLA runs it as a gather (`_deform_conv2d_slot`, a
// corner-slot gather and one matmul per tap, at h*w >= 4096) or as a dense
// one-hot matmul (`_deform_conv2d_onehot`, below 4096 pixels). The port
// serves `dla_node="dcn"` (every neck node) and the coarse nodes of
// `"dcn_mix"` with these two kernels; they have no backward yet.
//
// What bounds them on the H100: the operations of the clamped forward at
// the same shapes (chip_smoke.py dcn_bound_ms_3xtf32 or dcn_bound_ms at
// float32, dcn_bound_ms_bf16 at bfloat16): the contraction, 2 * 9 * Cin *
// Cout per pixel, and the sampling, about 8 * 9 * Cin per pixel, against
// the bytes of the inputs and the output. This first design does the
// float32 contraction on the CUDA cores (dcn_bound_ms is its bound there)
// and reads every corner from global memory, whose latency, with two
// barriers per chunk, decides its time.
//
// The design (the clamped op's gather routes, dcn_local.cu and
// dcn_local_bf16.cu, with the exact op's corners). A block of 256 threads
// takes 64 consecutive output pixels by 64 output channels. The four
// corners of every (pixel, tap), their flat pixel index and their weight
// with the mask folded in (0 outside the map), are computed once per
// block into shared memory. For each tap and chunk of 32 input channels
// the block builds the sample A (64 x 32) in shared memory, reading the
// corner pixels' channels straight from x in global memory (coalesced),
// beside the tap's weight slice. float32: every thread runs 32 x 16 FMAs
// into its 4 x 4 sums in registers. bfloat16: A is rounded to bf16 and
// each of the 8 warps multiplies its 16 x 32 part with wmma fragments,
// accumulating in float32 across every tap and chunk; the accumulators go
// through shared memory once at the end to add the bias and round.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int TP = 64;   // output pixels per block
constexpr int TC = 64;   // output channels per block
constexpr int CK = 32;   // input channels per chunk
constexpr int NT = 256;  // threads

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }

// The corners of tap t at pixel n = (b, y, xx) (`base` = b * H * W) for
// its unclamped offset (dy, dx) and mask m: each corner's flat pixel
// index and weight, both 0 outside the map. Computed as the JAX op and
// the plain version compute them, without fused multiply-adds.
__device__ __forceinline__ void exact_corners(int base, int y, int xx, int t,
                                              float dy, float dx, float m,
                                              int H, int W, int (&idx)[4],
                                              float (&wt)[4]) {
  float py = __fadd_rn((float)(y + t / 3 - 1), dy);
  float px = __fadd_rn((float)(xx + t % 3 - 1), dx);
  py = fminf(fmaxf(py, -1.f), (float)H);
  px = fminf(fmaxf(px, -1.f), (float)W);
  const float y0 = floorf(py);
  const float x0 = floorf(px);
  const float fy = __fsub_rn(py, y0);
  const float fx = __fsub_rn(px, x0);
  const float gy = __fsub_rn(1.f, fy);
  const float gx = __fsub_rn(1.f, fx);
  const float cw[4] = {__fmul_rn(__fmul_rn(gy, gx), m),
                       __fmul_rn(__fmul_rn(gy, fx), m),
                       __fmul_rn(__fmul_rn(fy, gx), m),
                       __fmul_rn(__fmul_rn(fy, fx), m)};
  const int iy = (int)y0;  // in [-1, H]: clipped first
  const int ix = (int)x0;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int yy = iy + a;
      const int xc = ix + c;
      const bool inside = yy >= 0 && yy < H && xc >= 0 && xc < W;
      idx[2 * a + c] = inside ? base + yy * W + xc : 0;
      wt[2 * a + c] = inside ? cw[2 * a + c] : 0.f;
    }
  }
}

struct Corners {
  int idx[9][4][TP];  // flat pixel index of each corner, 0 outside
  float w[9][4][TP];  // corner weight times the mask, 0 outside
};

// The block's corner tables, by all its threads.
template <typename T>
__device__ __forceinline__ void fill_corners(Corners& c, const T* offset,
                                             const T* mask, int p0, int npix,
                                             int H, int W) {
  const int HW = H * W;
  for (int e = threadIdx.x; e < 9 * TP; e += NT) {
    const int t = e / TP;
    const int p = e - t * TP;
    const int n = p0 + p;
    int idx[4] = {0, 0, 0, 0};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    if (n < npix) {
      const int b = n / HW;
      const int rem = n - b * HW;
      const int y = rem / W;
      const T* o = offset + (int64_t)n * 18;
      exact_corners(b * HW, y, rem - y * W, t, f32(o[2 * t]),
                    f32(o[2 * t + 1]), f32(mask[(int64_t)n * 9 + t]), H, W,
                    idx, wt);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c.idx[t][k][p] = idx[k];
      c.w[t][k][p] = wt[k];
    }
  }
}

// ---- float32 ---------------------------------------------------------------

__global__ void __launch_bounds__(NT)
dcn_exact_fwd_kernel(const float* __restrict__ x,
                     const float* __restrict__ offset,
                     const float* __restrict__ mask,
                     const float* __restrict__ weight,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int npix, int H, int W, int Cin, int Cout) {
  __shared__ Corners corners;
  __shared__ float s_sample[CK][TP + 1];  // +1: conflict-free column writes
  __shared__ float s_weight[CK][TC];

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * TP;
  const int o0 = blockIdx.y * TC;
  fill_corners(corners, offset, mask, p0, npix, H, W);

  const int tx = tid % 16;  // output channels tx + 16 j
  const int ty = tid / 16;  // output pixels ty + 16 i
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int t = 0; t < 9; ++t) {
    const float* wtap = weight + (int64_t)t * Cin * Cout;
    for (int c0 = 0; c0 < Cin; c0 += CK) {
      __syncthreads();  // previous chunk fully consumed (and corners ready)
      for (int e = tid; e < CK * TP; e += NT) {
        const int c = e % CK;
        const int p = e / CK;
        float v = 0.f;
        if (c0 + c < Cin) {
          // each corner's product added in turn: the plain version's order
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float wk = corners.w[t][k][p];
            if (wk != 0.f)
              v = __fadd_rn(
                  v, __fmul_rn(
                         x[(int64_t)corners.idx[t][k][p] * Cin + c0 + c], wk));
          }
        }
        s_sample[c][p] = v;
      }
      for (int e = tid; e < CK * TC; e += NT) {
        const int o = e % TC;
        const int c = e / TC;
        s_weight[c][o] = (c0 + c < Cin && o0 + o < Cout)
                             ? wtap[(int64_t)(c0 + c) * Cout + o0 + o]
                             : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < CK; ++c) {
        float a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s_sample[c][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = s_weight[c][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = p0 + ty + 16 * i;
    if (n >= npix) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx + 16 * j;
      if (o < Cout)
        out[(int64_t)n * Cout + o] = acc[i][j] + (bias ? bias[o] : 0.f);
    }
  }
}

// ---- bfloat16 --------------------------------------------------------------

constexpr int LDA = CK + 8;  // bf16 pitch of the sample tile (80 B rows)
constexpr int LDB = TC + 8;  // bf16 pitch of the weight tile (144 B rows)
constexpr int LDO = TC + 4;  // float32 pitch of the output tile

// The corner tables are dead once the last chunk is built: the output
// tile reuses their memory.
union __align__(32) Smem {
  Corners c;
  float out[TP][LDO];
};

// Two consecutive channels of one pixel as float32; `n` of them (0-2)
// lie inside the row, `paired` says a 4-byte load is aligned.
__device__ __forceinline__ float2 load2(const bf16* p, int n, bool paired) {
  if (n >= 2 && paired)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  float2 v = make_float2(0.f, 0.f);
  if (n > 0) v.x = f32(p[0]);
  if (n > 1) v.y = f32(p[1]);
  return v;
}

__device__ __forceinline__ bool even(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 3) == 0;
}

__global__ void __launch_bounds__(NT)
dcn_exact_fwd_bf16_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ offset,
                          const bf16* __restrict__ mask,
                          const bf16* __restrict__ weight,
                          const bf16* __restrict__ bias,
                          bf16* __restrict__ out, int npix, int H, int W,
                          int Cin, int Cout) {
  __shared__ Smem sm;
  __shared__ __align__(32) bf16 s_a[TP][LDA];
  __shared__ __align__(32) bf16 s_b[CK][LDB];

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * TP;
  const int o0 = blockIdx.y * TC;
  // 4-byte loads and stores of channel pairs where they are aligned
  const bool x_paired = Cin % 2 == 0 && even(x);
  const bool w_paired = Cout % 2 == 0 && even(weight) && even(out) &&
                        (bias == nullptr || even(bias));
  fill_corners(sm.c, offset, mask, p0, npix, H, W);

  const int warp = tid / 32;
  const int wm = warp % 4;  // pixel rows 16 wm .. 16 wm + 15
  const int wn = warp / 4;  // channel cols 32 wn .. 32 wn + 31
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  for (int t = 0; t < 9; ++t) {
    const bf16* wtap = weight + (int64_t)t * Cin * Cout;
    for (int c0 = 0; c0 < Cin; c0 += CK) {
      __syncthreads();  // previous chunk fully consumed (and corners ready)
      for (int e = tid; e < TP * CK / 2; e += NT) {
        const int cp = e % (CK / 2);
        const int p = e / (CK / 2);
        const int c = c0 + 2 * cp;
        const int live = Cin - c;
        float s0 = 0.f, s1 = 0.f;
        if (live > 0) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float wk = sm.c.w[t][k][p];
            if (wk != 0.f) {
              const float2 v = load2(
                  x + (int64_t)sm.c.idx[t][k][p] * Cin + c, live, x_paired);
              s0 = __fadd_rn(s0, __fmul_rn(v.x, wk));
              s1 = __fadd_rn(s1, __fmul_rn(v.y, wk));
            }
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(&s_a[p][2 * cp]) =
            __floats2bfloat162_rn(s0, s1);
      }
      for (int e = tid; e < CK * TC / 2; e += NT) {
        const int op = e % (TC / 2);
        const int c = e / (TC / 2);
        const int o = o0 + 2 * op;
        float2 v = make_float2(0.f, 0.f);
        if (c0 + c < Cin)
          v = load2(wtap + (int64_t)(c0 + c) * Cout + o, Cout - o, w_paired);
        *reinterpret_cast<__nv_bfloat162*>(&s_b[c][2 * op]) =
            __floats2bfloat162_rn(v.x, v.y);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < CK; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, &s_a[16 * wm][k], LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              bfrag;
          wmma::load_matrix_sync(bfrag, &s_b[k][32 * wn + 16 * j], LDB);
          wmma::mma_sync(acc[j], a, bfrag, acc[j]);
        }
      }
    }
  }

  __syncthreads();  // every warp is done with the corner tables
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(&sm.out[16 * wm][32 * wn + 16 * j], acc[j], LDO,
                            wmma::mem_row_major);
  __syncthreads();

  for (int e = tid; e < TP * TC / 2; e += NT) {
    const int op = e % (TC / 2);
    const int p = e / (TC / 2);
    const int n = p0 + p;
    const int o = o0 + 2 * op;
    if (n >= npix || o >= Cout) continue;
    float v0 = sm.out[p][2 * op];
    float v1 = sm.out[p][2 * op + 1];
    if (bias) {
      const float2 bv = load2(bias + o, Cout - o, w_paired);
      v0 += bv.x;
      v1 += bv.y;
    }
    bf16* dst = out + (int64_t)n * Cout + o;
    if (o + 1 < Cout && w_paired) {
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
    } else {
      dst[0] = __float2bfloat16_rn(v0);
      if (o + 1 < Cout) dst[1] = __float2bfloat16_rn(v1);
    }
  }
}

// The grid of a launch, or false for sizes the kernels do not take (a map
// past 2^31 pixels; negative widths).
bool grid_of(int B, int H, int W, int Cin, int Cout, int& npix, dim3& grid) {
  const int64_t n = (int64_t)B * H * W;
  if (B < 0 || H < 0 || W < 0 || Cin < 0 || Cout < 0 || n > 0x7fffffff)
    return false;
  npix = (int)n;
  grid = dim3((unsigned)((n + TP - 1) / TP), (Cout + TC - 1) / TC);
  return true;
}

}  // namespace

// Any B, H, W, Cin, Cout and any offset; out (B, H, W, Cout) is fully
// written; `bias` may be null. Each launches on `stream`, allocates
// nothing, reads nothing back and does not synchronise (a CUDA graph
// captures it), and returns cudaGetLastError() as an int; a map past 2^31
// pixels or a negative size returns cudaErrorInvalidValue.
extern "C" int dcn_exact_fwd(const float* x, const float* offset,
                             const float* mask, const float* weight,
                             const float* bias, float* out, int B, int H,
                             int W, int Cin, int Cout, void* stream) {
  int npix;
  dim3 grid;
  if (!grid_of(B, H, W, Cin, Cout, npix, grid))
    return (int)cudaErrorInvalidValue;
  if (npix == 0 || Cout == 0) return (int)cudaSuccess;
  dcn_exact_fwd_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      x, offset, mask, weight, bias, out, npix, H, W, Cin, Cout);
  return (int)cudaGetLastError();
}

extern "C" int dcn_exact_fwd_bf16(const bf16* x, const bf16* offset,
                                  const bf16* mask, const bf16* weight,
                                  const bf16* bias, bf16* out, int B, int H,
                                  int W, int Cin, int Cout, void* stream) {
  int npix;
  dim3 grid;
  if (!grid_of(B, H, W, Cin, Cout, npix, grid))
    return (int)cudaErrorInvalidValue;
  if (npix == 0 || Cout == 0) return (int)cudaSuccess;
  dcn_exact_fwd_bf16_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      x, offset, mask, weight, bias, out, npix, H, W, Cin, Cout);
  return (int)cudaGetLastError();
}
