// The bf16 DCN kernels' sample A_t(p, c) = bf16(m_t(p) * S_t(p, c)), shared
// by dcn_local_fwd_bf16 (dcn_local_bf16.cu), which contracts it with the
// weight, and dcn_local_bwd_weight_bf16 (dcn_local_bwd_bf16.cu), which
// contracts it with the output gradient: one copy of the arithmetic, so
// the weight gradient sees the bf16 values the forward contracted, bit
// for bit (the weight gradient's gather route takes its hat weights from
// here too).
//
// S_t is built term by term in the order and with the roundings of the
// plain version (ops/dcn.deform_conv2d_local_plain: the hat weights
// wy*wx, each corner's product added in turn, then the mask), without
// fused multiply-adds, from a haloed window of x in shared memory: the
// tile's pixels with R + 1 more rows and columns on every side, each
// window position PIX_B = 128 bytes (64 bf16 channels, 8 pieces of 16
// bytes), piece q of position pos at slot q ^ (pos & 7).

#pragma once

#include <cuda_bf16.h>

namespace dcn_bf16 {

constexpr int PIX_B = 128;  // bytes of one window position: 64 bf16

// The hat weights wy*wx of tap t's four corners (row-major: (0, 0), (0,
// 1), (1, 0), (1, 1) from the top-left corner) at its clamped offset
// (dy, dx) in [-R, R], computed as the plain version computes max(0, 1 -
// |(t + d) - a|), and the top-left corner's row and column relative to
// the pixel.
__device__ __forceinline__ void hats(float dy, float dx, int t, int& fy,
                                     int& fx, float (&wt)[4]) {
  const float vy = __fadd_rn((float)(t / 3 - 1), dy);
  const float vx = __fadd_rn((float)(t % 3 - 1), dx);
  const float ffy = floorf(vy);
  const float ffx = floorf(vx);
  const float wy[2] = {1.f - fabsf(vy - ffy), 1.f - fabsf(vy - (ffy + 1.f))};
  const float wx[2] = {1.f - fabsf(vx - ffx), 1.f - fabsf(vx - (ffx + 1.f))};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wt[2 * i + j] = __fmul_rn(wy[i], wx[j]);
  }
  fy = (int)ffy;
  fx = (int)ffx;
}

// The corner entry of tap t at the tile's pixel (py, px), its clamped
// offset (dy, dx), in a window of halo h and width WW, WH rows: the
// window index of each corner (clamped into the window; a corner past it
// has weight 0) and its hat weight.
__device__ __forceinline__ void corners(float dy, float dx, int t, int py,
                                        int px, int h, int WH, int WW,
                                        int (&idx)[4], float (&wt)[4]) {
  int fy, fx;
  hats(dy, dx, t, fy, fx, wt);
  const int r0 = py + h + fy;  // >= 0: fy >= -1 - R
  const int c0 = px + h + fx;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      idx[2 * i + j] = min(r0 + i, WH - 1) * WW + min(c0 + j, WW - 1);
  }
}

// A_t of channel octet q (channels 8 q .. 8 q + 7 of the window) at one
// pixel whose corners lie at window positions pos with hat weights wk,
// masked by m: 8 bf16 packed in 16 bytes.
__device__ __forceinline__ uint4 sample8(const unsigned char* win,
                                         const int (&pos)[4],
                                         const float (&wk)[4], float m,
                                         int q) {
  uint4 raw[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    raw[k] = *reinterpret_cast<const uint4*>(win + pos[k] * PIX_B +
                                             ((q ^ (pos[k] & 7)) << 4));
  float s8[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) s8[c] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw[k]);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float2 f = __bfloat1622float2(v[c]);
      s8[2 * c] = __fadd_rn(s8[2 * c], __fmul_rn(f.x, wk[k]));
      s8[2 * c + 1] = __fadd_rn(s8[2 * c + 1], __fmul_rn(f.y, wk[k]));
    }
  }
  uint4 packed;
  __nv_bfloat162* pk = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
  for (int c = 0; c < 4; ++c)
    pk[c] = __floats2bfloat162_rn(__fmul_rn(s8[2 * c], m),
                                  __fmul_rn(s8[2 * c + 1], m));
  return packed;
}

}  // namespace dcn_bf16
