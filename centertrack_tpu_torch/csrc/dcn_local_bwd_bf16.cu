// Clamped-offset modulated 3x3 deformable convolution, backward, bfloat16
// inputs, for Hopper (sm_90a). The forward is csrc/dcn_local_bf16.cu:
//
//   out[p, o] = bf16( bias[o] + sum_t sum_c  A_t(p, c) * w[t, c, o] )
//   A_t(p, c) = bf16( m_t(p) * S_t(p, c) )
//
// with S_t the float32 bilinear sample of the bf16 x at the tap's clipped
// offset; the float32 kernel's backward (csrc/dcn_local_bwd.cu) states
// the hat formulation and JAX's derivative rules at the kinks (hat' and
// clip' = 1/2 at +/-R), which this file takes unchanged.
//
// Replaces, at bfloat16 inputs, the backward of the two Pallas TPU
// kernels that have one: the custom_vjp `_bwd` of
// centertrack_tpu/ops/dcn_pallas_shift.py (deform_conv2d_local_pallas)
// and of ops/dcn_pallas_halo.py (deform_conv2d_local_halo), each jax.vjp
// of ops/dcn.deform_conv2d_local at the inputs' dtype.
//
// Rounding. Every input is bf16 and read as float32; everything inside
// runs in float32, and each output is rounded to bf16 once. That is the
// float32 vjp of the forward above on the bf16 values, with the two
// roundings of the forward (A_t and out) passed through as the identity,
// as a cast's transpose passes a cotangent; it is what the plain version
// (ops/dcn.deform_conv2d_local_plain at bf16) computes. JAX's own bf16
// vjp rounds at every bf16 op instead, so it lies further from the
// float32 vjp than this does.
//
//   dcn_local_bwd_data_bf16: grad x, grad offset, grad mask. One block
//   per tile of DP pixels and one tap, as in the float32 kernel. Per
//   chunk of 32 input channels the block forms G_t(p, c) = sum_o g(p, o)
//   w[t, c, o] on the tensor cores (wmma 16x16x16, bf16 in, float32
//   accumulators; the products of two bf16 values are exact in float32),
//   parks G in shared memory, and then, one warp per pixel and one lane
//   per channel, walks the tap's (up to 3 x 3) support to accumulate
//   grad mask, grad dy and grad dx (reduced by warp shuffles in a fixed
//   order, rounded once) and scatters m hat hat G into a float32 copy of
//   grad x with atomicAdd. A second kernel rounds that copy to bf16 in
//   one pass: a bf16 atomicAdd would round at every add.
//
//   dcn_local_bwd_weight_bf16: grad w[t] = sum_p A_t(p)^T g(p), with A_t
//   rebuilt exactly as the forward built it (the same corner order, the
//   same float32 roundings, no fused multiply-adds), so the contraction
//   sees the bf16 values the forward contracted. The pixels are split
//   over `splits` blocks per (64 x 64) tile and tap; each block
//   contracts its chunks of 32 pixels on the tensor cores and writes a
//   float32 partial tile; a second kernel sums the partials in split
//   order (deterministic) and rounds once.
//
// What bounds them on the H100: the two contractions (2 * 9 * Cin * Cout
// operations per pixel each) at the dense bf16 tensor-core peak
// (989 TFLOP/s), the bilinear work (38 * 9 * Cin float32 operations per
// pixel for the data kernel, 8 * 9 * Cin for the weight kernel) at the
// float32 peak (67 TFLOP/s), against the bf16 bytes each must move at
// 3.35 TB/s; at the DLA-34 neck shapes the float32 bilinear work is the
// larger (chip_smoke.py dcn_bwd_bound_ms_bf16). Nothing of size pixels x
// channels x taps goes to device memory. What the design leaves exposed:
// the gathers of x and the g/w staging are not pipelined, grad x goes
// through float32 atomics, and the small maps give few blocks; cp.async
// or TMA staging and wgmma are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;
using namespace nvcuda;

constexpr int DP = 64;    // bwd_data: pixels per block
constexpr int DK = 32;    // bwd_data: input channels per chunk (one warp)
constexpr int DO = 32;    // bwd_data: output channels per staged chunk
constexpr int DNT = 256;  // bwd_data: threads (8 warps)
constexpr int DPW = DP / (DNT / 32);  // pixels per warp
constexpr int LDG = DO + 8;  // bf16 pitch of the g and w chunks (80 B)
constexpr int LDC = DK + 4;  // float32 pitch of the G tile

constexpr int WC = 64;    // bwd_weight: input channels per block
constexpr int WO = 64;    // bwd_weight: output channels per block
constexpr int WP = 32;    // bwd_weight: pixels per chunk (two k-steps)
constexpr int WNT = 256;  // bwd_weight: 8 warps, 4 rows of 16 input
                          // channels x 2 cols of 32 output channels
constexpr int LDS = WC + 8;  // bf16 pitch of the sample chunk (144 B)
constexpr int LDW = WO + 8;  // bf16 pitch of the g chunk (144 B)
constexpr int LDT = WO + 4;  // float32 pitch of the result tile

__device__ __forceinline__ float hat(float u) {
  return fmaxf(0.f, 1.f - fabsf(u));
}

__device__ __forceinline__ float hat_grad(float u) {
  const float a = fabsf(u);
  if (a < 1.f) return u >= 0.f ? -1.f : 1.f;
  if (a == 1.f) return u > 0.f ? -0.5f : 0.5f;
  return 0.f;
}

__device__ __forceinline__ float clip_grad(float d, float R) {
  if (d > -R && d < R) return 1.f;
  if (d == -R || d == R) return 0.5f;
  return 0.f;
}

__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }

// Two consecutive bf16 values as float32; `n` of them (0-2) are live,
// `paired` says a 4-byte load is aligned.
__device__ __forceinline__ float2 load2(const bf16* p, int n, bool paired) {
  if (n >= 2 && paired)
    return __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
  float2 v = make_float2(0.f, 0.f);
  if (n > 0) v.x = f32(p[0]);
  if (n > 1) v.y = f32(p[1]);
  return v;
}

__device__ __forceinline__ bool aligned4(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 3) == 0;
}

__global__ void __launch_bounds__(DNT)
dcn_local_bwd_data_bf16_kernel(const bf16* __restrict__ x,
                               const bf16* __restrict__ offset,
                               const bf16* __restrict__ mask,
                               const bf16* __restrict__ weight,
                               const bf16* __restrict__ grad_out,
                               float* __restrict__ grad_x_acc,
                               bf16* __restrict__ grad_offset,
                               bf16* __restrict__ grad_mask,
                               int npix, int H, int W, int Cin, int Cout,
                               int Ri) {
  // per pixel: the 3 candidate rows / cols of the support (-1 where the
  // shift is outside [-R, R] or the map), their hat and hat' weights,
  // the mask and the two clip' factors (as in dcn_local_bwd.cu)
  __shared__ int s_row[DP][3];
  __shared__ int s_col[DP][3];
  __shared__ float s_wy[DP][3], s_gy[DP][3], s_wx[DP][3], s_gx[DP][3];
  __shared__ float s_m[DP], s_cy[DP], s_cx[DP];
  __shared__ __align__(32) bf16 s_g[DP][LDG];
  __shared__ __align__(32) bf16 s_w[DK][LDG];
  __shared__ __align__(32) float s_G[DP][LDC];

  const float R = (float)Ri;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % 4;   // G rows (pixels) 16 wm .. 16 wm + 15
  const int wn = warp / 4;   // G cols (channels) 16 wn .. 16 wn + 15
  const int p0 = blockIdx.x * DP;
  const int t = blockIdx.y;
  const int ty = t / 3 - 1;
  const int tx = t % 3 - 1;
  const int HW = H * W;
  const bool g_paired = Cout % 2 == 0 && aligned4(grad_out);

  if (tid < DP) {
    const int p = tid;
    const int n = p0 + p;
    float m = 0.f, cy = 0.f, cx = 0.f;
    float dyc = 0.f, dxc = 0.f;
    int b = 0, y = 0, xx = 0;
    if (n < npix) {
      b = n / HW;
      const int rem = n - b * HW;
      y = rem / W;
      xx = rem - y * W;
      const float dy = f32(offset[(int64_t)n * 18 + 2 * t]);
      const float dx = f32(offset[(int64_t)n * 18 + 2 * t + 1]);
      dyc = fminf(fmaxf(dy, -R), R);
      dxc = fminf(fmaxf(dx, -R), R);
      cy = clip_grad(dy, R);
      cx = clip_grad(dx, R);
      m = f32(mask[(int64_t)n * 9 + t]);
    }
    const float tyd = (float)ty + dyc;
    const float txd = (float)tx + dxc;
    const int fy = (int)rintf(tyd) - ty;
    const int fx = (int)rintf(txd) - tx;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int ky = fy - 1 + q;
      const int kx = fx - 1 + q;
      const float uy = tyd - (float)(ty + ky);
      const float ux = txd - (float)(tx + kx);
      const int yy = y + ty + ky;
      const int xc = xx + tx + kx;
      const bool oky = n < npix && ky >= -Ri && ky <= Ri && yy >= 0 &&
                       yy < H;
      const bool okx = n < npix && kx >= -Ri && kx <= Ri && xc >= 0 &&
                       xc < W;
      s_row[p][q] = oky ? b * HW + yy * W : -1;
      s_col[p][q] = okx ? xc : -1;
      s_wy[p][q] = oky ? hat(uy) : 0.f;
      s_gy[p][q] = oky ? hat_grad(uy) : 0.f;
      s_wx[p][q] = okx ? hat(ux) : 0.f;
      s_gx[p][q] = okx ? hat_grad(ux) : 0.f;
    }
    s_m[p] = m;
    s_cy[p] = cy;
    s_cx[p] = cx;
  }

  float acc_m[DPW], acc_y[DPW], acc_x[DPW];
#pragma unroll
  for (int i = 0; i < DPW; ++i) {
    acc_m[i] = 0.f;
    acc_y[i] = 0.f;
    acc_x[i] = 0.f;
  }
  const bf16* wtap = weight + (int64_t)t * Cin * Cout;

  for (int c0 = 0; c0 < Cin; c0 += DK) {
    // G_t(p, c0 + k) = sum_o g(p, o) w[t, c0 + k, o] on the tensor cores
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> accG;
    wmma::fill_fragment(accG, 0.f);
    for (int o0 = 0; o0 < Cout; o0 += DO) {
      __syncthreads();  // previous chunk consumed (and the setup done)
      for (int e = tid; e < DP * DO / 2; e += DNT) {
        const int op = e % (DO / 2);
        const int p = e / (DO / 2);
        const int n = p0 + p;
        const int o = o0 + 2 * op;
        float2 v = make_float2(0.f, 0.f);
        if (n < npix)
          v = load2(grad_out + (int64_t)n * Cout + o, Cout - o, g_paired);
        *reinterpret_cast<bf162*>(&s_g[p][2 * op]) =
            __floats2bfloat162_rn(v.x, v.y);
      }
      for (int e = tid; e < DK * DO / 2; e += DNT) {
        const int op = e % (DO / 2);
        const int k = e / (DO / 2);
        const int o = o0 + 2 * op;
        float2 v = make_float2(0.f, 0.f);
        if (c0 + k < Cin)
          v = load2(wtap + (int64_t)(c0 + k) * Cout + o, Cout - o, g_paired &&
                    aligned4(weight));
        *reinterpret_cast<bf162*>(&s_w[k][2 * op]) =
            __floats2bfloat162_rn(v.x, v.y);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < DO; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bw;
        wmma::load_matrix_sync(a, &s_g[16 * wm][k], LDG);
        // B(o, c) = w[t, c, o] = s_w[c][o]: column-major with pitch LDG
        wmma::load_matrix_sync(bw, &s_w[16 * wn][k], LDG);
        wmma::mma_sync(accG, a, bw, accG);
      }
    }
    wmma::store_matrix_sync(&s_G[16 * wm][16 * wn], accG, LDC,
                            wmma::mem_row_major);
    __syncthreads();
    const int c = c0 + lane;
    if (c >= Cin) continue;  // lanes past Cin: G = 0, nothing to add
#pragma unroll
    for (int i = 0; i < DPW; ++i) {
      const int p = warp + 8 * i;
      const float G = s_G[p][lane];
      const float mG = s_m[p] * G;
      float S = 0.f, Sy = 0.f, Sx = 0.f;
#pragma unroll
      for (int qy = 0; qy < 3; ++qy) {
        const int row = s_row[p][qy];
        const float wy = s_wy[p][qy];
        const float gy = s_gy[p][qy];
        if (row < 0 || (wy == 0.f && gy == 0.f)) continue;
#pragma unroll
        for (int qx = 0; qx < 3; ++qx) {
          const int col = s_col[p][qx];
          const float wx = s_wx[p][qx];
          const float gx = s_gx[p][qx];
          if (col < 0 || (wx == 0.f && gx == 0.f)) continue;
          const int64_t at = (int64_t)(row + col) * Cin + c;
          const float v = f32(x[at]);
          S = fmaf(wy * wx, v, S);
          Sy = fmaf(gy * wx, v, Sy);
          Sx = fmaf(wy * gx, v, Sx);
          const float wk = wy * wx;
          if (wk != 0.f) atomicAdd(grad_x_acc + at, wk * mG);
        }
      }
      acc_m[i] = fmaf(G, S, acc_m[i]);
      acc_y[i] = fmaf(G, Sy, acc_y[i]);
      acc_x[i] = fmaf(G, Sx, acc_x[i]);
    }
  }

#pragma unroll
  for (int i = 0; i < DPW; ++i) {
    float a = acc_m[i], ay = acc_y[i], ax = acc_x[i];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, s);
      ay += __shfl_xor_sync(0xffffffffu, ay, s);
      ax += __shfl_xor_sync(0xffffffffu, ax, s);
    }
    const int p = warp + 8 * i;
    const int n = p0 + p;
    if (lane == 0 && n < npix) {
      const float m = s_m[p];
      grad_mask[(int64_t)n * 9 + t] = __float2bfloat16_rn(a);
      grad_offset[(int64_t)n * 18 + 2 * t] =
          __float2bfloat16_rn(m * s_cy[p] * ay);
      grad_offset[(int64_t)n * 18 + 2 * t + 1] =
          __float2bfloat16_rn(m * s_cx[p] * ax);
    }
  }
}

// grad_x[e] = bf16(grad_x_acc[e]), two elements per thread
__global__ void round_to_bf16_kernel(const float* __restrict__ src,
                                     bf16* __restrict__ dst, int64_t count) {
  const int64_t e = 2 * ((int64_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (e + 1 < count && aligned4(dst + e)) {
    *reinterpret_cast<bf162*>(dst + e) =
        __floats2bfloat162_rn(src[e], src[e + 1]);
  } else {
    if (e < count) dst[e] = __float2bfloat16_rn(src[e]);
    if (e + 1 < count) dst[e + 1] = __float2bfloat16_rn(src[e + 1]);
  }
}

__global__ void __launch_bounds__(WNT)
dcn_local_bwd_weight_bf16_kernel(const bf16* __restrict__ x,
                                 const bf16* __restrict__ offset,
                                 const bf16* __restrict__ mask,
                                 const bf16* __restrict__ grad_out,
                                 float* __restrict__ partial,
                                 int npix, int H, int W, int Cin, int Cout,
                                 float R, int per_split) {
  __shared__ int s_idx[4][WP];     // flat pixel index of each corner
  __shared__ float s_wt[4][WP];    // hat weight wy * wx, 0 outside
  __shared__ float s_m[WP];
  __shared__ __align__(32) bf16 s_S[WP][LDS];   // A_t chunk, bf16
  __shared__ __align__(32) bf16 s_g[WP][LDW];
  __shared__ __align__(32) float s_out[WC][LDT];

  const int tid = threadIdx.x;
  const int tiles_o = (Cout + WO - 1) / WO;
  const int c0 = (blockIdx.x / tiles_o) * WC;
  const int o0 = (blockIdx.x % tiles_o) * WO;
  const int t = blockIdx.y;
  const int split = blockIdx.z;
  const int pbeg = split * per_split;
  const int pend = min(npix, pbeg + per_split);
  const int HW = H * W;
  const bool x_paired = Cin % 2 == 0 && aligned4(x);
  const bool g_paired = Cout % 2 == 0 && aligned4(grad_out);
  const int warp = tid / 32;
  const int wm = warp % 4;   // input channels 16 wm .. 16 wm + 15
  const int wn = warp / 4;   // output channels 32 wn .. 32 wn + 31

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  for (int q0 = pbeg; q0 < pend; q0 += WP) {
    __syncthreads();  // previous chunk consumed
    if (tid < WP) {
      // the corners, hat weights and mask of dcn_local_fwd_bf16, computed
      // the same way
      const int n = q0 + tid;
      int idx[4] = {0, 0, 0, 0};
      float wt[4] = {0.f, 0.f, 0.f, 0.f};
      float m = 0.f;
      if (n < pend) {
        const int b = n / HW;
        const int rem = n - b * HW;
        const int y = rem / W;
        const int xx = rem - y * W;
        const bf16* o = offset + (int64_t)n * 18;
        const float dy = fminf(fmaxf(f32(o[2 * t]), -R), R);
        const float dx = fminf(fmaxf(f32(o[2 * t + 1]), -R), R);
        m = f32(mask[(int64_t)n * 9 + t]);
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
        s_idx[k][tid] = idx[k];
        s_wt[k][tid] = wt[k];
      }
      s_m[tid] = m;
    }
    __syncthreads();
    // A_t = bf16(m * S_t), term by term as the forward builds it
    for (int e = tid; e < WP * WC / 2; e += WNT) {
      const int cp = e % (WC / 2);
      const int p = e / (WC / 2);
      const int c = c0 + 2 * cp;
      const int live = Cin - c;
      float s0 = 0.f, s1 = 0.f;
      if (live > 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float wk = s_wt[k][p];
          if (wk != 0.f) {
            const float2 v =
                load2(x + (int64_t)s_idx[k][p] * Cin + c, live, x_paired);
            s0 = __fadd_rn(s0, __fmul_rn(v.x, wk));
            s1 = __fadd_rn(s1, __fmul_rn(v.y, wk));
          }
        }
        const float m = s_m[p];
        s0 = __fmul_rn(s0, m);
        s1 = __fmul_rn(s1, m);
      }
      *reinterpret_cast<bf162*>(&s_S[p][2 * cp]) =
          __floats2bfloat162_rn(s0, s1);
    }
    for (int e = tid; e < WP * WO / 2; e += WNT) {
      const int op = e % (WO / 2);
      const int p = e / (WO / 2);
      const int n = q0 + p;
      const int o = o0 + 2 * op;
      float2 v = make_float2(0.f, 0.f);
      if (n < pend)
        v = load2(grad_out + (int64_t)n * Cout + o, Cout - o, g_paired);
      *reinterpret_cast<bf162*>(&s_g[p][2 * op]) =
          __floats2bfloat162_rn(v.x, v.y);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < WP; k += 16) {
      // A(c, p) = s_S[p][c]: column-major with pitch LDS
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::load_matrix_sync(a, &s_S[k][16 * wm], LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
            bg;
        wmma::load_matrix_sync(bg, &s_g[k][32 * wn + 16 * j], LDW);
        wmma::mma_sync(acc[j], a, bg, acc[j]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(&s_out[16 * wm][32 * wn + 16 * j], acc[j], LDT,
                            wmma::mem_row_major);
  __syncthreads();
  float* out = partial + ((int64_t)split * 9 + t) * Cin * Cout;
  for (int e = tid; e < WC * WO; e += WNT) {
    const int o = e % WO;
    const int c = e / WO;
    if (c0 + c < Cin && o0 + o < Cout)
      out[(int64_t)(c0 + c) * Cout + o0 + o] = s_out[c][o];
  }
}

// grad_w[e] = bf16(sum over the splits of partial[s, e]), in split order
__global__ void dcn_local_bwd_weight_bf16_reduce_kernel(
    const float* __restrict__ partial, bf16* __restrict__ grad_w,
    int64_t count, int splits) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[(int64_t)k * count + e];
  grad_w[e] = __float2bfloat16_rn(s);
}

}  // namespace

// Both launchers run on `stream`, allocate nothing, do not synchronise,
// and return cudaGetLastError() as an int (0 = ok). All tensors are
// contiguous, in the forward's layouts; grad_out is (B, H, W, Cout) bf16.

// grad_x_acc is B * H * W * Cin floats of scratch (zeroed here);
// grad_x (B, H, W, Cin), grad_offset (B, H, W, 18) and grad_mask
// (B, H, W, 9) are bf16 and fully written.
extern "C" int dcn_local_bwd_data_bf16(const bf16* x, const bf16* offset,
                                       const bf16* mask, const bf16* weight,
                                       const bf16* grad_out,
                                       float* grad_x_acc, bf16* grad_x,
                                       bf16* grad_offset, bf16* grad_mask,
                                       int B, int H, int W, int Cin,
                                       int Cout, int R, void* stream) {
  const int npix = B * H * W;
  if (npix <= 0 || Cin <= 0) return (int)cudaSuccess;
  if (Cout <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t count = (int64_t)npix * Cin;
  cudaError_t err = cudaMemsetAsync(grad_x_acc, 0, count * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((npix + DP - 1) / DP, 9);
  dcn_local_bwd_data_bf16_kernel<<<grid, DNT, 0, s>>>(
      x, offset, mask, weight, grad_out, grad_x_acc, grad_offset, grad_mask,
      npix, H, W, Cin, Cout, R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const int64_t pairs = (count + 1) / 2;
  round_to_bf16_kernel<<<(unsigned)((pairs + threads - 1) / threads),
                         threads, 0, s>>>(grad_x_acc, grad_x, count);
  return (int)cudaGetLastError();
}

// grad_w (3, 3, Cin, Cout) bf16 is fully written; `partial` holds
// splits * 9 * Cin * Cout floats of scratch.
extern "C" int dcn_local_bwd_weight_bf16(const bf16* x, const bf16* offset,
                                         const bf16* mask,
                                         const bf16* grad_out, bf16* grad_w,
                                         float* partial, int B, int H,
                                         int W, int Cin, int Cout, int R,
                                         int splits, void* stream) {
  const int npix = B * H * W;
  if (Cin <= 0 || Cout <= 0 || splits < 1 || partial == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int per_split = (((npix + splits - 1) / splits + WP - 1) / WP) * WP;
  const int tiles = ((Cin + WC - 1) / WC) * ((Cout + WO - 1) / WO);
  const dim3 grid(tiles, 9, splits);
  dcn_local_bwd_weight_bf16_kernel<<<grid, WNT, 0, s>>>(
      x, offset, mask, grad_out, partial, npix, H, W, Cin, Cout, (float)R,
      per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t count = (int64_t)9 * Cin * Cout;
  const int threads = 256;
  dcn_local_bwd_weight_bf16_reduce_kernel<<<(unsigned)((count + threads -
                                                        1) / threads),
                                            threads, 0, s>>>(
      partial, grad_w, count, splits);
  return (int)cudaGetLastError();
}
