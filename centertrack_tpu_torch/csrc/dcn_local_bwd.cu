// Clamped-offset modulated 3x3 deformable convolution, backward, fp32,
// for Hopper (sm_90a). The forward is csrc/dcn_local.cu; the layouts and
// the function are the same:
//
//   out[p, o] = bias[o] + sum_t sum_c  m_t(p) * S_t(p, c) * w[t, c, o]
//
// with tap t = 3*i + j at (ty, tx) = (i - 1, j - 1), its offset clipped,
// dy_c = clip(dy, -R, R), and the exact bilinear sample written as the
// JAX package writes it (ops/dcn.py deform_conv2d_local): a sum over the
// 2R+1 integer shifts k per axis of the clamped support,
//
//   S_t(p, c) = sum_{ky, kx in [-R, R]} hat(ty + dy_c - (ty + ky))
//               * hat(tx + dx_c - (tx + kx)) * x[y + ty + ky, x + tx + kx, c]
//
// hat(u) = max(0, 1 - |u|), zeros outside the map.
//
// Replaces the backward of the two Pallas TPU kernels that have one: the
// custom_vjp `_bwd` of centertrack_tpu/ops/dcn_pallas_shift.py
// (deform_conv2d_local_pallas) and of ops/dcn_pallas_halo.py
// (deform_conv2d_local_halo). Both are jax.vjp of the formulation above,
// so this file takes JAX's derivative rules where that function has
// kinks, and not the floor-based derivative of DCNv2's CUDA:
//
//   hat'(u) = -1 for 0 <= u < 1 (jnp.abs'(0) = +1), +1 for -1 < u < 0,
//             -1/2 at u = +1 and +1/2 at u = -1 (jnp.maximum splits a
//             tie), 0 for |u| > 1;
//   clip'(d) = 1 inside (-R, R), 1/2 at exactly +/-R, 0 outside.
//
// At an integer dy_c three shifts per axis have a non-zero hat' (k =
// dy_c - 1, dy_c, dy_c + 1), at a non-integer one two; shifts outside
// [-R, R] are not in the sum (their hat is 0 inside the clamp, and the
// JAX formulation leaves them out, so their hat' does not count either).
// u is formed as (ty + dy_c) - (ty + k), in the same order as JAX, so
// both see a kink at the same inputs.
//
// Two entry points:
//
//   dcn_local_bwd_data: grad x, grad offset, grad mask. One block per
//   tile of DP pixels and one tap. Per chunk of 32 input channels it
//   forms G_t(p, c) = sum_o g(p, o) w[t, c, o] in registers (the
//   forward's contraction turned around; g and the weight slice are
//   staged in shared memory), then, one warp per pixel and one lane per
//   channel, reads the (up to 3 x 3) shifted x values of the tap's
//   support and accumulates
//     grad mask_t(p)  = sum_c G S_t,
//     grad dy_t(p)    = m clip'(dy) sum_c G sum_k hat'(.) hat(.) x,
//     grad dx_t(p)    likewise,
//   and adds m hat hat G into grad x at the (<= 4) bilinear corners with
//   fp32 atomicAdd. grad x therefore sums in an order that changes from
//   run to run (rounding-level differences only); grad offset and grad
//   mask are owned by one block each and are reduced in a fixed order
//   (warp shuffles).
//
//   dcn_local_bwd_weight: grad w[t] = sum_p (m_t S_t(p))^T g(p), with
//   S_t rebuilt from x as the forward builds it. A reduction over all
//   B*H*W pixels: the pixels are split over `splits` blocks, each writes
//   its (64 x 64) partial tile to a scratch slice, and a second kernel
//   sums the slices in a fixed order (deterministic). splits = 1 writes
//   the result directly.
//
// What bounds them on the H100: together about twice the forward's fp32
// operations (the G contraction and the grad w contraction are each as
// large as the forward's), plus the bilinear work of the support; the
// bytes are larger than the forward's (g read twice, x read up to 9
// times per tap through L2, grad x written by atomics), but at the
// DLA-34 neck shapes the ratio of operations to bytes stays well above
// the fp32 ridge of about 20, so they are bound by fp32 operations on
// the CUDA cores, as the forward is. The design keeps every
// intermediate (G, the samples, the hat weights) in registers and
// shared memory: nothing of size pixels x channels x taps goes to
// device memory. Tensor cores (TF32/bf16 wgmma) are for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DP = 64;    // bwd_data: pixels per block
constexpr int DK = 32;    // bwd_data: input channels per chunk (one warp)
constexpr int DO = 32;    // bwd_data: output channels per staged chunk
constexpr int DNT = 256;  // bwd_data: threads (8 warps)
constexpr int DPW = DP / (DNT / 32);  // pixels per warp

constexpr int WC = 64;    // bwd_weight: input channels per block
constexpr int WO = 64;    // bwd_weight: output channels per block
constexpr int WP = 32;    // bwd_weight: pixels per shared-memory chunk
constexpr int WNT = 256;  // bwd_weight: threads, 16 x 16, 4 x 4 each

// hat(u) and its derivative with JAX's rules at the kinks (see above)
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

__global__ void __launch_bounds__(DNT)
dcn_local_bwd_data_kernel(const float* __restrict__ x,
                          const float* __restrict__ offset,
                          const float* __restrict__ mask,
                          const float* __restrict__ weight,
                          const float* __restrict__ grad_out,
                          float* __restrict__ grad_x,
                          float* __restrict__ grad_offset,
                          float* __restrict__ grad_mask,
                          int npix, int H, int W, int Cin, int Cout,
                          int Ri) {
  // per pixel of the tile: the 3 candidate rows / cols of the support
  // (flat pixel index of the row start b*H*W + yy*W, and the column xx;
  // -1 where the shift is outside [-R, R] or outside the map), their hat
  // and hat' weights, the mask and the two clip' factors
  __shared__ int s_row[DP][3];
  __shared__ int s_col[DP][3];
  __shared__ float s_wy[DP][3], s_gy[DP][3], s_wx[DP][3], s_gx[DP][3];
  __shared__ float s_m[DP], s_cy[DP], s_cx[DP];
  __shared__ float s_g[DP][DO + 1];
  __shared__ float s_w[DK][DO + 1];

  const float R = (float)Ri;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int p0 = blockIdx.x * DP;
  const int t = blockIdx.y;
  const int ty = t / 3 - 1;
  const int tx = t % 3 - 1;
  const int HW = H * W;

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
      const float dy = offset[(int64_t)n * 18 + 2 * t];
      const float dx = offset[(int64_t)n * 18 + 2 * t + 1];
      dyc = fminf(fmaxf(dy, -R), R);
      dxc = fminf(fmaxf(dx, -R), R);
      cy = clip_grad(dy, R);
      cx = clip_grad(dx, R);
      m = mask[(int64_t)n * 9 + t];
    }
    const float tyd = (float)ty + dyc;
    const float txd = (float)tx + dxc;
    // candidate shifts: every k with |u| <= 1 is in {f - 1, f, f + 1}
    // for f the nearest integer to ty + dy_c - ty (as rounded in u, the
    // others are at least 1.5 away)
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

  // this thread's pixels are warp + 8 i, its channel c0 + lane
  float acc_m[DPW], acc_y[DPW], acc_x[DPW];
#pragma unroll
  for (int i = 0; i < DPW; ++i) {
    acc_m[i] = 0.f;
    acc_y[i] = 0.f;
    acc_x[i] = 0.f;
  }
  const float* wtap = weight + (int64_t)t * Cin * Cout;

  for (int c0 = 0; c0 < Cin; c0 += DK) {
    const int c = c0 + lane;
    // G_t(p, c) = sum_o g(p, o) w[t, c, o]
    float G[DPW];
#pragma unroll
    for (int i = 0; i < DPW; ++i) G[i] = 0.f;
    for (int o0 = 0; o0 < Cout; o0 += DO) {
      __syncthreads();  // previous chunk consumed (and the setup done)
      for (int e = tid; e < DP * DO; e += DNT) {
        const int o = e % DO;
        const int p = e / DO;
        const int n = p0 + p;
        s_g[p][o] = (n < npix && o0 + o < Cout)
                        ? grad_out[(int64_t)n * Cout + o0 + o]
                        : 0.f;
      }
      for (int e = tid; e < DK * DO; e += DNT) {
        const int o = e % DO;
        const int k = e / DO;
        s_w[k][o] = (c0 + k < Cin && o0 + o < Cout)
                        ? wtap[(int64_t)(c0 + k) * Cout + o0 + o]
                        : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int o = 0; o < DO; ++o) {
        const float wv = s_w[lane][o];
#pragma unroll
        for (int i = 0; i < DPW; ++i) {
          G[i] = fmaf(s_g[warp + 8 * i][o], wv, G[i]);
        }
      }
    }
    if (c >= Cin) continue;  // lanes past Cin: G = 0, nothing to add
#pragma unroll
    for (int i = 0; i < DPW; ++i) {
      const int p = warp + 8 * i;
      const float mG = s_m[p] * G[i];
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
          const float v = x[at];
          S = fmaf(wy * wx, v, S);
          Sy = fmaf(gy * wx, v, Sy);
          Sx = fmaf(wy * gx, v, Sx);
          const float wk = wy * wx;
          if (wk != 0.f) atomicAdd(grad_x + at, wk * mG);
        }
      }
      acc_m[i] = fmaf(G[i], S, acc_m[i]);
      acc_y[i] = fmaf(G[i], Sy, acc_y[i]);
      acc_x[i] = fmaf(G[i], Sx, acc_x[i]);
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
      grad_mask[(int64_t)n * 9 + t] = a;
      grad_offset[(int64_t)n * 18 + 2 * t] = m * s_cy[p] * ay;
      grad_offset[(int64_t)n * 18 + 2 * t + 1] = m * s_cx[p] * ax;
    }
  }
}

__global__ void __launch_bounds__(WNT)
dcn_local_bwd_weight_kernel(const float* __restrict__ x,
                            const float* __restrict__ offset,
                            const float* __restrict__ mask,
                            const float* __restrict__ grad_out,
                            float* __restrict__ partial,
                            int npix, int H, int W, int Cin, int Cout,
                            float R, int per_split) {
  __shared__ int s_idx[WP][4];         // flat pixel index of each corner
  __shared__ float s_wt[WP][4];        // bilinear weight x mask, 0 outside
  __shared__ float s_S[WP][WC];
  __shared__ float s_g[WP][WO];

  const int tid = threadIdx.x;
  const int tiles_o = (Cout + WO - 1) / WO;
  const int c0 = (blockIdx.x / tiles_o) * WC;
  const int o0 = (blockIdx.x % tiles_o) * WO;
  const int t = blockIdx.y;
  const int split = blockIdx.z;
  const int pbeg = split * per_split;
  const int pend = min(npix, pbeg + per_split);
  const int HW = H * W;
  const int tx = tid % 16;   // output channels o0 + tx + 16 j
  const int ty = tid / 16;   // input channels c0 + ty + 16 i

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int q0 = pbeg; q0 < pend; q0 += WP) {
    __syncthreads();  // previous chunk consumed
    if (tid < WP) {
      const int n = q0 + tid;
      int idx[4] = {0, 0, 0, 0};
      float wt[4] = {0.f, 0.f, 0.f, 0.f};
      if (n < pend) {
        const int b = n / HW;
        const int rem = n - b * HW;
        const int y = rem / W;
        const int xx = rem - y * W;
        const float dy = fminf(fmaxf(offset[(int64_t)n * 18 + 2 * t], -R), R);
        const float dx =
            fminf(fmaxf(offset[(int64_t)n * 18 + 2 * t + 1], -R), R);
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
        s_idx[tid][k] = idx[k];
        s_wt[tid][k] = wt[k];
      }
    }
    __syncthreads();
    for (int e = tid; e < WP * WC; e += WNT) {
      const int c = e % WC;
      const int p = e / WC;
      float v = 0.f;
      if (c0 + c < Cin) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float wk = s_wt[p][k];
          if (wk != 0.f)
            v = fmaf(wk, x[(int64_t)s_idx[p][k] * Cin + c0 + c], v);
        }
      }
      s_S[p][c] = v;
    }
    for (int e = tid; e < WP * WO; e += WNT) {
      const int o = e % WO;
      const int p = e / WO;
      const int n = q0 + p;
      s_g[p][o] = (n < pend && o0 + o < Cout)
                      ? grad_out[(int64_t)n * Cout + o0 + o]
                      : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int p = 0; p < WP; ++p) {
      float a[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_S[p][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) g[j] = s_g[p][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], g[j], acc[i][j]);
      }
    }
  }

  float* out = partial + ((int64_t)split * 9 + t) * Cin * Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty + 16 * i;
    if (c >= Cin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx + 16 * j;
      if (o < Cout) out[(int64_t)c * Cout + o] = acc[i][j];
    }
  }
}

// grad_w[e] = sum over the splits of partial[s, e], in split order
__global__ void dcn_local_bwd_weight_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ grad_w,
    int64_t count, int splits) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[(int64_t)k * count + e];
  grad_w[e] = s;
}

}  // namespace

// Both launchers run on `stream`, allocate nothing, do not synchronise,
// and return cudaGetLastError() as an int (0 = ok).

// grad_x must be zero-filled by the caller (it is accumulated with
// atomics); grad_offset (B, H, W, 18) and grad_mask (B, H, W, 9) are
// fully written.
extern "C" int dcn_local_bwd_data(const float* x, const float* offset,
                                  const float* mask, const float* weight,
                                  const float* grad_out, float* grad_x,
                                  float* grad_offset, float* grad_mask,
                                  int B, int H, int W, int Cin, int Cout,
                                  int R, void* stream) {
  const int npix = B * H * W;
  if (npix <= 0) return (int)cudaSuccess;
  const dim3 grid((npix + DP - 1) / DP, 9);
  dcn_local_bwd_data_kernel<<<grid, DNT, 0, (cudaStream_t)stream>>>(
      x, offset, mask, weight, grad_out, grad_x, grad_offset, grad_mask,
      npix, H, W, Cin, Cout, R);
  return (int)cudaGetLastError();
}

// grad_w (3, 3, Cin, Cout) is fully written. With splits > 1, `partial`
// holds splits * 9 * Cin * Cout floats of scratch; with splits == 1 it
// may be null.
extern "C" int dcn_local_bwd_weight(const float* x, const float* offset,
                                    const float* mask, const float* grad_out,
                                    float* grad_w, float* partial, int B,
                                    int H, int W, int Cin, int Cout, int R,
                                    int splits, void* stream) {
  const int npix = B * H * W;
  if (Cin <= 0 || Cout <= 0 || splits < 1) return (int)cudaErrorInvalidValue;
  if (splits > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  const int per_split = (((npix + splits - 1) / splits + WP - 1) / WP) * WP;
  const int tiles = ((Cin + WC - 1) / WC) * ((Cout + WO - 1) / WO);
  const dim3 grid(tiles, 9, splits);
  float* dst = splits > 1 ? partial : grad_w;
  dcn_local_bwd_weight_kernel<<<grid, WNT, 0, (cudaStream_t)stream>>>(
      x, offset, mask, grad_out, dst, npix, H, W, Cin, Cout, (float)R,
      per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int64_t count = (int64_t)9 * Cin * Cout;
  const int threads = 256;
  dcn_local_bwd_weight_reduce_kernel<<<(unsigned)((count + threads - 1) /
                                                  threads),
                                       threads, 0, (cudaStream_t)stream>>>(
      partial, grad_w, count, splits);
  return (int)cudaGetLastError();
}
