// Device code of the exact modulated 3x3 deformable convolution (DCNv2)
// shared by its kernels (the forward, dcn_exact.cu, and the backward,
// dcn_exact_bwd.cu): the corners of a tap at the absolute, clipped,
// floor-based sample position, and for the backward their derivative
// weights; a tile's bounding box of the corners it reads; and the copy of
// one Cin chunk of that box global -> shared by cp.async.
//
// A block takes a TH x TW tile of output pixels of one image. Every
// corner it reads lies inside the map: the exact op's positions are
// clipped to [-1, H] x [-1, W] and a corner outside the map reads 0, so
// its box lies within the map too. The box holds only the "live" corners,
// those inside the map whose bilinear (hat) weight is not 0: a position
// clipped to exactly -1 or H has fy = 0, so its corner on row H + 1 (or
// past column W) needs no slot. A window pixel is PIX_B = 128 bytes (32
// float32 or 64 bf16 channels, 8 pieces of 16 bytes), piece q of box
// position pos at slot q ^ (pos & 7), so that the eight pixels a
// quarter-warp samples read eight bank groups where their positions
// differ in their low bits.

#pragma once

#include <climits>

#include "hopper.cuh"

namespace dcn_exact {

constexpr int TH = 4;        // tile rows
constexpr int TW = 16;       // tile columns
constexpr int TP = TH * TW;  // pixels per tile: one wgmma M tile
constexpr int PIX_B = 128;   // bytes of one window pixel

// Tap t at pixel (y, xx), its unclamped offset (dy, dx) and mask m, on a
// map of H x W: the top-left corner (iy, ix), in [-1, H] x [-1, W]; the
// weights ((1 - fy) * (1 - fx)) * m, ((1 - fy) * fx) * m, (fy * (1 - fx))
// * m, (fy * fx) * m of the corners (iy, ix), (iy, ix + 1), (iy + 1, ix),
// (iy + 1, ix + 1), 0 outside the map; and `live`, bit k set where corner
// k lies inside the map with a hat weight that is not 0. Computed as the
// JAX op and the plain version compute them (the position rounded once,
// clipped before the integer cast), without fused multiply-adds.
__device__ __forceinline__ void corners(int y, int xx, int t, float dy,
                                        float dx, float m, int H, int W,
                                        int& iy, int& ix, float (&wt)[4],
                                        int& live) {
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
  const float hat[4] = {__fmul_rn(gy, gx), __fmul_rn(gy, fx),
                        __fmul_rn(fy, gx), __fmul_rn(fy, fx)};
  iy = (int)y0;
  ix = (int)x0;
  live = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int yy = iy + (k >> 1);
    const int xc = ix + (k & 1);
    const bool inside = yy >= 0 && yy < H && xc >= 0 && xc < W;
    wt[k] = inside ? __fmul_rn(hat[k], m) : 0.f;
    if (inside && hat[k] != 0.f) live |= 1 << k;
  }
}

// The rows and columns of a corner set (`live` of `corners`, or `needed`
// of `grad_needed`) folded into a running minimum and maximum.
__device__ __forceinline__ void fold_box(int iy, int ix, int live, int& rmin,
                                         int& rmax, int& cmin, int& cmax) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (live >> k & 1) {
      rmin = min(rmin, iy + (k >> 1));
      rmax = max(rmax, iy + (k >> 1));
      cmin = min(cmin, ix + (k & 1));
      cmax = max(cmax, ix + (k & 1));
    }
  }
}

// clip'(u) of the position clip to [-1, size], JAX's rule (jnp.clip), as
// a code: 2 inside (slope 1), 1 at exactly -1 or size (1/2), 0 outside
// (0); clip_slope gives the slope of a code
__device__ __forceinline__ int clip_code(float u, int size) {
  if (u > -1.f && u < (float)size) return 2;
  return u == -1.f || u == (float)size ? 1 : 0;
}
__device__ __forceinline__ float clip_slope(int code) {
  return code == 2 ? 1.f : code == 1 ? 0.5f : 0.f;
}

// The backward's view of tap t at pixel (y, xx) and its offset (dy, dx)
// on a map of H x W, as the plain version's autograd takes it (floor' =
// 0, clip' by clip_code): the top-left corner (iy, ix), the fractions
// (fy, fx) of the clipped position, and the clip's slope codes (sy, sx).
// The position rounds as in `corners`.
__device__ __forceinline__ void grad_position(int y, int xx, int t, float dy,
                                              float dx, int H, int W,
                                              int& iy, int& ix, float& fy,
                                              float& fx, int& sy, int& sx) {
  const float uy = __fadd_rn((float)(y + t / 3 - 1), dy);
  const float ux = __fadd_rn((float)(xx + t % 3 - 1), dx);
  const float py = fminf(fmaxf(uy, -1.f), (float)H);
  const float px = fminf(fmaxf(ux, -1.f), (float)W);
  const float y0 = floorf(py);
  const float x0 = floorf(px);
  fy = __fsub_rn(py, y0);
  fx = __fsub_rn(px, x0);
  sy = clip_code(uy, H);
  sx = clip_code(ux, W);
  iy = (int)y0;
  ix = (int)x0;
}

// The weights of a position's corners from (fy, fx), the mask m and the
// slope codes: the hats of `corners`, unmasked ((1 - fy) * (1 - fx), ...),
// which weigh grad mask; the derivative weights gy[k] = clip'(py) m
// d(hat_k)/dfy and gx[k] = clip'(px) m d(hat_k)/dfx, which weigh grad dy
// and grad dx. The same arithmetic wherever they are computed, so a
// kernel that stores (fy, fx, m, sy, sx) rebuilds them bit for bit.
__device__ __forceinline__ void grad_weights(float fy, float fx, float m,
                                             int sy, int sx, float (&hat)[4],
                                             float (&gy)[4], float (&gx)[4]) {
  const float ry = __fsub_rn(1.f, fy);
  const float rx = __fsub_rn(1.f, fx);
  hat[0] = __fmul_rn(ry, rx);
  hat[1] = __fmul_rn(ry, fx);
  hat[2] = __fmul_rn(fy, rx);
  hat[3] = __fmul_rn(fy, fx);
  const float cy = __fmul_rn(clip_slope(sy), m);
  const float cx = __fmul_rn(clip_slope(sx), m);
  gy[0] = -__fmul_rn(rx, cy);
  gy[1] = -__fmul_rn(fx, cy);
  gy[2] = __fmul_rn(rx, cy);
  gy[3] = __fmul_rn(fx, cy);
  gx[0] = -__fmul_rn(ry, cx);
  gx[1] = __fmul_rn(ry, cx);
  gx[2] = -__fmul_rn(fy, cx);
  gx[3] = __fmul_rn(fy, cx);
}

// `needed` of a corner set: bit k set where corner k lies inside the map
// and one of its three weights is not 0, the corners whose x the three
// sums read (a corner outside the map reads 0; one of weights all 0 adds
// 0). At an integer position fy = 0, so the corners of row iy + 1 have
// hat 0 but a derivative weight that is not: they are needed though no
// forward reads them.
__device__ __forceinline__ int grad_needed(int iy, int ix, int H, int W,
                                           const float (&hat)[4],
                                           const float (&gy)[4],
                                           const float (&gx)[4]) {
  int needed = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int yy = iy + (k >> 1);
    const int xc = ix + (k & 1);
    const bool inside = yy >= 0 && yy < H && xc >= 0 && xc < W;
    if (inside && (hat[k] != 0.f || gy[k] != 0.f || gx[k] != 0.f))
      needed |= 1 << k;
  }
  return needed;
}

// rows r0 .. r0 + bh - 1, columns c0 .. c0 + bw - 1 of one image
struct Box {
  int r0, c0, bh, bw;
};

// The block's box: the smallest rectangle that holds the corners of
// every thread (each passes its own running minimum and maximum, INT_MAX /
// INT_MIN when it has none); 1 x 1 at (0, 0) when no corner is live.
// Every thread of the block calls it; `s` is 4 ints of shared memory. Its
// barriers also publish what the block wrote to shared memory before it.
__device__ __forceinline__ Box block_box(int rmin, int rmax, int cmin,
                                         int cmax, int* s) {
  if (threadIdx.x == 0) {
    s[0] = INT_MAX;
    s[1] = INT_MIN;
    s[2] = INT_MAX;
    s[3] = INT_MIN;
  }
  __syncthreads();
  rmin = __reduce_min_sync(0xffffffffu, rmin);
  rmax = __reduce_max_sync(0xffffffffu, rmax);
  cmin = __reduce_min_sync(0xffffffffu, cmin);
  cmax = __reduce_max_sync(0xffffffffu, cmax);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&s[0], rmin);
    atomicMax(&s[1], rmax);
    atomicMin(&s[2], cmin);
    atomicMax(&s[3], cmax);
  }
  __syncthreads();
  Box box{0, 0, 1, 1};
  if (s[0] <= s[1]) box = Box{s[0], s[2], s[1] - s[0] + 1, s[3] - s[2] + 1};
  return box;
}

// One 16-byte piece (4 float32 or 8 bf16 channels) at `src` into `dst`:
// cp.async when every value is live and the source aligned, else by hand
// with zeros past `live`.
__device__ __forceinline__ void copy_piece(void* dst, const float* src,
                                           int live, bool aligned) {
  hopper::copy4(dst, src, live, aligned);
}
__device__ __forceinline__ void copy_piece(void* dst,
                                           const __nv_bfloat16* src, int live,
                                           bool aligned) {
  hopper::copy8(dst, src, live, aligned);
}

// Channels ch0 .. ch0 + PIX_B / sizeof(T) - 1 of every pixel of `box` in
// image b of x (B, H, W, Cin) into the window at `dst`, box position pos =
// row * bw + column, by the block's `nt` threads; zero outside the map and
// past Cin. `aligned`: Cin is a multiple of a piece and x 16-byte aligned.
template <typename T>
__device__ __forceinline__ void copy_box(unsigned char* dst, const T* x,
                                         int b, int H, int W, int Cin,
                                         int ch0, const Box& box,
                                         bool aligned, int tid, int nt) {
  constexpr int EP = 16 / (int)sizeof(T);  // channels per piece
  const int n = box.bh * box.bw * 8;
  for (int e = tid; e < n; e += nt) {
    const int pos = e >> 3;
    const int q = e & 7;
    const int wr = pos / box.bw;
    const int yy = box.r0 + wr;
    const int xc = box.c0 + (pos - wr * box.bw);
    const int ch = ch0 + EP * q;
    const bool in = yy >= 0 && yy < H && xc >= 0 && xc < W;
    const T* src = in ? x + (((int64_t)b * H + yy) * W + xc) * Cin + ch : x;
    copy_piece(dst + pos * PIX_B + ((q ^ (pos & 7)) << 4), src,
               in ? Cin - ch : 0, aligned);
  }
}

}  // namespace dcn_exact
