// Clamped-offset modulated 3x3 deformable convolution, forward, fp32,
// for Hopper (sm_90a).
//
// Computes, for every output pixel p = (b, y, x) and output channel o,
//
//   out[p, o] = bias[o] + sum_t sum_c  m_t(p) * S_t(p, c) * w[t, c, o]
//
// where tap t = 3*i + j sits at (i - 1, j - 1), its offset (dy, dx) =
// offset[p, 2t], offset[p, 2t + 1] is clipped to [-R, R], m_t = mask[p, t],
// and S_t is the exact bilinear sample of x at
// (y + i - 1 + dy, x + j - 1 + dx), with zeros outside the map. Stride 1,
// dilation 1. Layouts are the JAX package's: x (B, H, W, Cin),
// offset (B, H, W, 18) interleaved (dy, dx) per tap with taps row-major,
// mask (B, H, W, 9), w (3, 3, Cin, Cout), out (B, H, W, Cout), all
// contiguous float32.
//
// Replaces the forward of the four Pallas TPU kernels that compute this
// function: centertrack_tpu/ops/dcn_pallas.py deform_conv2d_pallas,
// ops/dcn_pallas_grid.py deform_conv2d_pallas_grid,
// ops/dcn_pallas_shift.py deform_conv2d_local_pallas and
// ops/dcn_pallas_halo.py deform_conv2d_local_halo. Their backward
// passes are not ported here.
//
// What bounds it on the H100: at the DLA-34 neck shapes the contraction
// is 2 * 9 * Cin * Cout operations per pixel against about
// 4 * (Cin + Cout + 27) bytes of input and output per pixel: some 120
// (64 -> 64) to 740 (512 -> 256) operations per byte, far above the 20 at
// which fp32 work on the CUDA cores (67 TFLOP/s over 3.35 TB/s) stops
// being memory bound. So the op is bound by fp32 operations.
//
// What the design does about it: one block owns a tile of TP
// consecutive output pixels by TC output channels and keeps the sum in
// registers (4 x 4 per thread). The four corner indices and the
// bilinear x mask weights of every (pixel, tap) are computed once per
// block into shared memory. For each tap and each chunk of CK input
// channels, the block builds the modulated bilinear sample of its
// pixels in shared memory (the gather reads CK consecutive channels of
// a corner pixel, so it is coalesced) beside the tap's (CK, TC) weight
// slice, and every thread runs CK x 16 FMAs from shared memory. No
// im2col or sampled column goes to device memory, and the contraction
// stays in this kernel. Tensor cores (wgmma on TF32 or bf16 tiles fed
// by TMA) are the next step, in a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TP = 64;    // output pixels per block
constexpr int TC = 64;    // output channels per block
constexpr int CK = 32;    // input channels per shared-memory chunk
constexpr int NT = 256;   // threads per block: 16 pixel rows x 16 channel cols

__global__ void __launch_bounds__(NT)
dcn_local_fwd_kernel(const float* __restrict__ x,
                     const float* __restrict__ offset,
                     const float* __restrict__ mask,
                     const float* __restrict__ weight,
                     const float* __restrict__ bias,
                     float* __restrict__ out,
                     int npix, int H, int W, int Cin, int Cout, float R) {
  __shared__ int corner_idx[9][4][TP];   // flat pixel index of each corner
  __shared__ float corner_w[9][4][TP];   // bilinear weight x mask, 0 outside
  __shared__ float s_sample[CK][TP + 1]; // +1: conflict-free column writes
  __shared__ float s_weight[CK][TC];

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * TP;
  const int o0 = blockIdx.y * TC;
  const int HW = H * W;

  for (int e = tid; e < 9 * TP; e += NT) {
    const int t = e / TP;
    const int p = e - t * TP;
    const int n = p0 + p;
    int idx[4] = {0, 0, 0, 0};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    if (n < npix) {
      const int b = n / HW;
      const int rem = n - b * HW;
      const int y = rem / W;
      const int xx = rem - y * W;
      const float* o = offset + (int64_t)n * 18;
      const float dy = fminf(fmaxf(o[2 * t], -R), R);
      const float dx = fminf(fmaxf(o[2 * t + 1], -R), R);
      const float m = mask[(int64_t)n * 9 + t];
      const float py = (float)(y + t / 3 - 1) + dy;
      const float px = (float)(xx + t % 3 - 1) + dx;
      const float fy = floorf(py);
      const float fx = floorf(px);
      const int y0 = (int)fy;
      const int x0 = (int)fx;
      const float ly = py - fy;
      const float lx = px - fx;
      const float wy[2] = {1.f - ly, ly};
      const float wx[2] = {1.f - lx, lx};
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int yy = y0 + a;
          const int xc = x0 + c;
          const bool inside = yy >= 0 && yy < H && xc >= 0 && xc < W;
          idx[2 * a + c] = inside ? b * HW + yy * W + xc : 0;
          wt[2 * a + c] = inside ? wy[a] * wx[c] * m : 0.f;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      corner_idx[t][k][p] = idx[k];
      corner_w[t][k][p] = wt[k];
    }
  }

  const int tx = tid % 16;   // output channels tx + 16 j
  const int ty = tid / 16;   // output pixels ty + 16 i
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] = 0.f;
    }
  }

  for (int t = 0; t < 9; ++t) {
    const float* wtap = weight + (int64_t)t * Cin * Cout;
    for (int c0 = 0; c0 < Cin; c0 += CK) {
      __syncthreads();  // previous chunk fully consumed
      for (int e = tid; e < CK * TP; e += NT) {
        const int c = e % CK;
        const int p = e / CK;
        float v = 0.f;
        if (c0 + c < Cin) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float wk = corner_w[t][k][p];
            if (wk != 0.f)
              v = fmaf(wk, x[(int64_t)corner_idx[t][k][p] * Cin + c0 + c], v);
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
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
          }
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

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
// `bias` may be null. Nothing is allocated and nothing synchronises.
extern "C" int dcn_local_fwd(const float* x, const float* offset,
                             const float* mask, const float* weight,
                             const float* bias, float* out, int B, int H,
                             int W, int Cin, int Cout, int R, void* stream) {
  const int npix = B * H * W;
  if (npix <= 0 || Cout <= 0) return (int)cudaSuccess;
  const dim3 grid((npix + TP - 1) / TP, (Cout + TC - 1) / TC);
  dcn_local_fwd_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      x, offset, mask, weight, bias, out, npix, H, W, Cin, Cout, (float)R);
  return (int)cudaGetLastError();
}
