// Clamped-offset modulated 3x3 deformable convolution, forward, bfloat16
// inputs with the contraction on the tensor cores, for Hopper (sm_90a).
//
// Computes, for every output pixel p = (b, y, x) and output channel o,
//
//   out[p, o] = bf16( bias[o] + sum_t sum_c  A_t(p, c) * w[t, c, o] )
//   A_t(p, c) = bf16( m_t(p) * S_t(p, c) )
//
// where tap t = 3*i + j sits at (i - 1, j - 1), its offset (dy, dx) =
// offset[p, 2t], offset[p, 2t + 1] is clipped to [-R, R], m_t = mask[p, t],
// and S_t is the exact bilinear sample of x at
// (y + i - 1 + dy, x + j - 1 + dx), with zeros outside the map, taken in
// float32. Every input is bfloat16 and read as float32; bf16() rounds to
// nearest even; the sums run in float32. Layouts are the JAX package's:
// x (B, H, W, Cin), offset (B, H, W, 18) interleaved (dy, dx) per tap
// with taps row-major, mask (B, H, W, 9), w (3, 3, Cin, Cout),
// out (B, H, W, Cout), all contiguous.
//
// The rounding points are those of the Pallas kernels' body at bf16
// inputs (centertrack_tpu/ops/dcn_pallas_shift.py:45-76): a float32
// sample, masked, rounded to the weight's dtype, an MXU contraction with
// float32 accumulation, the bias added in float32, the result cast to
// x's dtype. The sample is built term by term in the order and with the
// roundings of the plain version (ops/dcn.deform_conv2d_local_plain:
// the hat weights wy*wx, each corner's product added in turn, then the
// mask), without fused multiply-adds, so A_t matches it bit for bit and
// only the float32 summation order of the contraction differs.
//
// Replaces, at bfloat16 inputs, the forward of the four Pallas TPU
// kernels that compute this function: centertrack_tpu/ops/dcn_pallas.py
// deform_conv2d_pallas, ops/dcn_pallas_grid.py deform_conv2d_pallas_grid,
// ops/dcn_pallas_shift.py deform_conv2d_local_pallas and
// ops/dcn_pallas_halo.py deform_conv2d_local_halo. Their bf16 backward
// is not ported here.
//
// What bounds it on the H100: the contraction, 2 * 9 * Cin * Cout
// operations per pixel, runs at the dense bf16 tensor-core peak
// (989 TFLOP/s); the sampling, about 8 * 9 * Cin float32 operations per
// pixel, at the float32 peak (67 TFLOP/s); together they take longer
// than the 2 * (Cin + 27 + Cout) bytes per pixel at 3.35 TB/s at every
// DLA-34 neck shape, so the bound is the operations' (chip_smoke.py
// dcn_bound_ms_bf16).
//
// What the design does about it: the tile of the float32 kernel
// (dcn_local.cu), TP consecutive output pixels by TC output channels per
// block. The four corner indices, the hat weights and the mask of every
// (pixel, tap) are computed once per block into shared memory. For each
// tap and each chunk of CK input channels the block builds the rounded
// sample A (TP x CK, bf16) in shared memory, reading two channels of a
// corner pixel per thread (coalesced), beside the tap's (CK x TC) bf16
// weight slice; then each of the 8 warps multiplies its 16 x 32 part
// with wmma 16x16x16 bf16 fragments, accumulating in float32 fragments
// across all taps and chunks. The accumulators go through shared memory
// once at the end to add the bias and write bf16 pairs. Nothing is
// pipelined: the gather and the two syncs of each chunk are exposed, and
// the small maps (s16, s32) give few blocks; wgmma, TMA and a split of
// the taps over blocks are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;
using namespace nvcuda;

constexpr int TP = 64;        // output pixels per block
constexpr int TC = 64;        // output channels per block
constexpr int CK = 32;        // input channels per chunk: two k-steps of 16
constexpr int NT = 256;       // 8 warps: 4 rows of 16 pixels x 2 cols
                              // of 32 channels
constexpr int LDA = CK + 8;   // bf16 pitch of the sample tile (80 B rows)
constexpr int LDB = TC + 8;   // bf16 pitch of the weight tile (144 B rows)
constexpr int LDO = TC + 4;   // float32 pitch of the output tile

struct Corners {
  int idx[9][4][TP];    // flat pixel index of each corner, 0 outside
  float w[9][4][TP];    // hat weight wy * wx, 0 outside the map
  float m[9][TP];       // mask
};

// The corner tables are dead once the last chunk is built: the output
// tile reuses their memory.
union __align__(32) Smem {
  Corners c;
  float out[TP][LDO];
};

// Two consecutive channels of one pixel as float32; `n` of them (0-2)
// lie inside Cin, `paired` says a 4-byte load is aligned.
__device__ __forceinline__ float2 load2(const bf16* p, int n, bool paired) {
  if (n >= 2 && paired)
    return __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
  float2 v = make_float2(0.f, 0.f);
  if (n > 0) v.x = __bfloat162float(p[0]);
  if (n > 1) v.y = __bfloat162float(p[1]);
  return v;
}

__global__ void __launch_bounds__(NT)
dcn_local_fwd_bf16_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ offset,
                          const bf16* __restrict__ mask,
                          const bf16* __restrict__ weight,
                          const bf16* __restrict__ bias,
                          bf16* __restrict__ out,
                          int npix, int H, int W, int Cin, int Cout,
                          float R) {
  __shared__ Smem sm;
  __shared__ __align__(32) bf16 s_a[TP][LDA];
  __shared__ __align__(32) bf16 s_b[CK][LDB];

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * TP;
  const int o0 = blockIdx.y * TC;
  const int HW = H * W;
  // 4-byte loads and stores of channel pairs where they are aligned
  const auto even = [](const void* q) {
    return (reinterpret_cast<uintptr_t>(q) & 3) == 0;
  };
  const bool x_paired = Cin % 2 == 0 && even(x);
  const bool w_paired = Cout % 2 == 0 && even(weight) && even(out) &&
                        (bias == nullptr || even(bias));

  for (int e = tid; e < 9 * TP; e += NT) {
    const int t = e / TP;
    const int p = e - t * TP;
    const int n = p0 + p;
    int idx[4] = {0, 0, 0, 0};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    float m = 0.f;
    if (n < npix) {
      const int b = n / HW;
      const int rem = n - b * HW;
      const int y = rem / W;
      const int xx = rem - y * W;
      const bf16* o = offset + (int64_t)n * 18;
      const float dy = fminf(fmaxf(__bfloat162float(o[2 * t]), -R), R);
      const float dx = fminf(fmaxf(__bfloat162float(o[2 * t + 1]), -R), R);
      m = __bfloat162float(mask[(int64_t)n * 9 + t]);
      // tap-relative sample position and its hat weights, computed as
      // the plain version computes max(0, 1 - |(t + d) - a|)
      const float vy = __fadd_rn((float)(t / 3 - 1), dy);
      const float vx = __fadd_rn((float)(t % 3 - 1), dx);
      const float fy = floorf(vy);
      const float fx = floorf(vx);
      const float wy[2] = {1.f - fabsf(vy - fy),
                           1.f - fabsf(vy - (fy + 1.f))};
      const float wx[2] = {1.f - fabsf(vx - fx),
                           1.f - fabsf(vx - (fx + 1.f))};
      const int y0 = y + (int)fy;
      const int x0 = xx + (int)fx;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int yy = y0 + a;
          const int xc = x0 + c;
          const bool inside = yy >= 0 && yy < H && xc >= 0 && xc < W;
          idx[2 * a + c] = inside ? b * HW + yy * W + xc : 0;
          wt[2 * a + c] = inside ? __fmul_rn(wy[a], wx[c]) : 0.f;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sm.c.idx[t][k][p] = idx[k];
      sm.c.w[t][k][p] = wt[k];
    }
    sm.c.m[t][p] = m;
  }

  const int warp = tid / 32;
  const int wm = warp % 4;   // pixel rows 16 wm .. 16 wm + 15
  const int wn = warp / 4;   // channel cols 32 wn .. 32 wn + 31
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
          const float m = sm.c.m[t][p];
          s0 = __fmul_rn(s0, m);
          s1 = __fmul_rn(s1, m);
        }
        *reinterpret_cast<bf162*>(&s_a[p][2 * cp]) =
            __floats2bfloat162_rn(s0, s1);
      }
      for (int e = tid; e < CK * TC / 2; e += NT) {
        const int op = e % (TC / 2);
        const int c = e / (TC / 2);
        const int o = o0 + 2 * op;
        float2 v = make_float2(0.f, 0.f);
        if (c0 + c < Cin)
          v = load2(wtap + (int64_t)(c0 + c) * Cout + o, Cout - o, w_paired);
        *reinterpret_cast<bf162*>(&s_b[c][2 * op]) =
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
      *reinterpret_cast<bf162*>(dst) = __floats2bfloat162_rn(v0, v1);
    } else {
      dst[0] = __float2bfloat16_rn(v0);
      if (o + 1 < Cout) dst[1] = __float2bfloat16_rn(v1);
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// `bias` may be null. Nothing is allocated and nothing synchronises.
extern "C" int dcn_local_fwd_bf16(const bf16* x, const bf16* offset,
                                  const bf16* mask, const bf16* weight,
                                  const bf16* bias, bf16* out, int B, int H,
                                  int W, int Cin, int Cout, int R,
                                  void* stream) {
  const int npix = B * H * W;
  if (npix <= 0 || Cout <= 0) return (int)cudaSuccess;
  const dim3 grid((npix + TP - 1) / TP, (Cout + TC - 1) / TC);
  dcn_local_fwd_bf16_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      x, offset, mask, weight, bias, out, npix, H, W, Cin, Cout, (float)R);
  return (int)cudaGetLastError();
}
