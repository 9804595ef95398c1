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
// What bounds them on the H100: the two contractions (2 * 9 * Cin * Cout
// operations per pixel each) at the dense bf16 tensor-core peak
// (989 TFLOP/s), the bilinear work (38 * 9 * Cin float32 operations per
// pixel for the data kernel, 8 * 9 * Cin for the weight kernel) at the
// float32 peak (67 TFLOP/s), against the bf16 bytes each must move at
// 3.35 TB/s; at the DLA-34 neck shapes the float32 bilinear work is the
// larger (chip_smoke.py dcn_bwd_bound_ms_bf16). Nothing of size pixels x
// channels x taps goes to device memory.
//
//   dcn_local_bwd_data_bf16: grad x, grad offset, grad mask. A block (one
//   warpgroup, 128 threads) takes a 4 x 16 tile of pixels of one image.
//   It copies the tile's output grad g (64 x Cout) global -> shared by
//   cp.async once and keeps it, with the tile's offsets and mask. Its K
//   loop runs over steps (Cin chunk of 64, tap), chunk-major; per chunk
//   the tile's x window with a halo of R + 1 (every position a clamped
//   offset's support reaches) is copied by cp.async, zero-filled outside
//   the map and past Cin, and the taps' weight slices stream through two
//   slots, step s + 1's copy in flight while step s works. Per step:
//     - G_t = g w[t]^T (64 pixels x 64 channels) on the tensor cores, a
//       wgmma m64n64k16 per 16 output channels, float32 accumulators in
//       registers (the products of two bf16 values are exact in float32);
//     - each thread walks the support of its two pixels for its 16
//       channels, straight from its accumulator fragment (the weight
//       slice's columns are permuted so that the fragment holds runs of
//       4 consecutive channels): it reads x from the window, sums G x
//       against hat hat, hat' hat and hat hat' for grad mask, grad dy and
//       grad dx (over its channels, then its quad by shuffles, then over
//       chunks in a fixed order), and adds m hat hat G into a float32
//       grad-x tile of the window's extent in shared memory. One integer
//       shift moves the tile's pixels to distinct positions, so the
//       shifts are walked in 2R + 1 rounds in which the four warps write
//       four distinct window rows: plain read-modify-writes, in a fixed
//       order, no atomics.
//   At the end of each chunk the grad-x tile goes to a float32 scratch by
//   global atomicAdd (neighbouring tiles' halos overlap), once per block
//   and chunk, not once per support corner, and a second kernel rounds
//   the scratch to bf16 once. Small maps split the K loop over blocks
//   (`splits`, ops/dcn.bwd_data_bf16_plan, for the fewest waves of
//   resident blocks): grad x needs nothing more (it is summed by
//   atomics), grad offset and grad mask go to float32 partials per split
//   that a third kernel sums in split order and rounds once; without a
//   split the block rounds and writes them itself. The window's and the
//   grad-x tile's pixel pitches are padded so that the pixels of a
//   warp's accesses start in distinct bank groups.
//
//   dcn_local_bwd_weight_bf16: grad w[t] = sum_p A_t(p)^T g(p), with A_t
//   the bf16 sample the forward contracted, built by the forward's own
//   device code (dcn_sample_bf16.cuh: the same corner order, the same
//   float32 roundings, no fused multiply-adds). The design of the float32
//   weight kernel (dcn_local_bwd.cu), in bf16 wgmma m64nNk16: M = 64
//   input channels, N = Cout up to 256 (half per warpgroup), K = pixels;
//   blocks of (chunk, 3 taps or 1 at N 256, split of the pixel tiles),
//   each tile's x window and output grad copied by cp.async a tile
//   ahead, A_t built once per (tap, channel, pixel) per launch. A_t is
//   written as the forward writes its A (8 channels of one pixel per 16
//   bytes) and read MN-major (trans-a: M = channel, K = pixel); g is
//   copied in its own layout (8 output channels of one pixel per 16
//   bytes) and read MN-major (trans-b). The splits' float32 partials are
//   summed in split order and rounded once by a second kernel (one split:
//   the block rounds), so grad w is bit-identical on every launch. Past
//   any tile that fits in shared memory (a max_offset past about 13),
//   the gather route `dcn_local_bwd_weight_gather_bf16`: the first
//   design, corners gathered from global memory, wmma 16x16x16.

#include <mma.h>

#include "dcn_sample_bf16.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;
using namespace nvcuda;

constexpr int DTH = 4;         // bwd_data: tile rows
constexpr int DTW = 16;        // bwd_data: tile columns
constexpr int DTP = DTH * DTW; // bwd_data: pixels per block (wgmma M)
constexpr int DCK = 64;        // bwd_data: input channels per chunk (N)
constexpr int DNT = 128;       // bwd_data: threads, one warpgroup
// bytes of a window pixel (64 bf16 and 16 of padding) and of a grad-x
// tile pixel (64 float32 and 16 of padding): with these pitches the
// pixels of a quarter- or half-warp's loads and stores start in distinct
// bank groups
constexpr int XPIX_B = DCK * 2 + 32;
constexpr int GXPIX_B = DCK * 4 + 64;
constexpr int OM_B = DTP * 27 * 4;       // the tile's offsets and mask
constexpr int SUMS_B = 3 * 9 * DTP * 4;  // grad mask, dy, dx sums

constexpr int WNT = 256;  // bwd_weight: threads, two warpgroups
constexpr int WCK = 64;   // bwd_weight: input channels per block (wgmma M)
constexpr int WTW = 16;   // bwd_weight: tile columns
constexpr int A_LBO = (WCK / 8) * 128;  // bwd_weight A: bytes between
                                        // 8-pixel groups

// the gather route of bwd_weight (max offsets whose window does not fit)
constexpr int GC = 64;    // input channels per block
constexpr int GO = 64;    // output channels per block
constexpr int GP = 32;    // pixels per chunk (two k-steps)
constexpr int GNT = 256;  // 8 warps, 4 rows of 16 input channels x 2
                          // cols of 32 output channels
constexpr int LDS = GC + 8;  // bf16 pitch of the sample chunk (144 B)
constexpr int LDW = GO + 8;  // bf16 pitch of the g chunk (144 B)
constexpr int LDT = GO + 4;  // float32 pitch of the result tile

// Cout padded to the wgmma K step
__host__ __device__ constexpr int kpad(int cout) {
  return (cout + 15) / 16 * 16;
}

__host__ __device__ constexpr int window_pixels(int R) {
  return (DTH + 2 * (R + 1)) * (DTW + 2 * (R + 1));
}

// g tile, two weight slots, x window, grad-x tile, offsets and mask,
// sums
__host__ __device__ constexpr int data_smem_bytes(int cout, int R) {
  return DTP * kpad(cout) * 2 + 2 * DCK * kpad(cout) * 2 +
         window_pixels(R) * (XPIX_B + GXPIX_B) + OM_B + SUMS_B;
}

// bwd_weight: taps per block by N tile (64 nb output channels): its
// accumulators, nb 16 float32 a thread and tap, in registers
__host__ __device__ constexpr int weight_taps(int nb) {
  return nb == 4 ? 1 : 3;
}

__host__ __device__ constexpr int weight_window_bytes(int R, int th) {
  return (th + 2 * (R + 1)) * (WTW + 2 * (R + 1)) * dcn_bf16::PIX_B;
}

// bwd_weight: two A slots, two g slots, the window slots, two corner
// tables (per tap and pixel 4 int16 indices, 4 weights and the mask)
__host__ __device__ constexpr int weight_smem_bytes(int nb, int taps, int R,
                                                    int th, int ws) {
  return 2 * th * WTW * WCK * 2 + 2 * th * WTW * 64 * nb * 2 +
         ws * weight_window_bytes(R, th) + 2 * taps * th * WTW * 28;
}

// The wgmma N column that holds input channel c (0..63) of a chunk: the
// accumulator fragment's columns 8 j + 2 (lane % 4) + e, j = 2 m + jl,
// hold channels 16 m + 4 (lane % 4) + 2 jl + e, four consecutive
// channels per pair of 8-column groups.
__device__ __forceinline__ int fragment_column(int c) {
  const int m = c >> 4;
  const int l4 = (c >> 2) & 3;
  const int jl = (c >> 1) & 1;
  return 8 * (2 * m + jl) + 2 * l4 + (c & 1);
}

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

struct DataArgs {
  const bf16* x;
  const bf16* offset;
  const bf16* mask;
  const bf16* weight;
  const bf16* grad_out;
  float* grad_x_acc;
  bf16* grad_offset;
  bf16* grad_mask;
  float* partial;
  int64_t npix;
  int H, W, Cin, Cout, R;
  int tiles_x, tiles_y, nsteps, splits;
};

// The data kernel, for max offsets R up to RM: the support walk's shift
// loops are unrolled over [-RM, RM], shifts past R skipped.
template <int RM>
__global__ void __launch_bounds__(DNT)
dcn_local_bwd_data_bf16_kernel(const DataArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout, Ri = a.R;
  const float R = (float)Ri;
  const int KP = kpad(Cout);
  const int SBO = KP * 16;  // g tile and weight slots: bytes between
                            // 8-row groups
  const int h = Ri + 1;
  const int WH = DTH + 2 * h;
  const int WW = DTW + 2 * h;
  const int WPIX = WH * WW;
  unsigned char* s_g = smem;                         // DTP x KP, K-major
  unsigned char* s_w = s_g + DTP * KP * 2;           // 2 x (DCK x KP)
  unsigned char* s_win = s_w + 2 * DCK * KP * 2;     // WPIX x XPIX_B
  float* s_gx = reinterpret_cast<float*>(s_win + WPIX * XPIX_B);
  float* s_om = s_gx + WPIX * (GXPIX_B / 4);  // [DTP][27]: dy, dx, mask
  float* sums = s_om + DTP * 27;    // [3][9][DTP]: grad mask, dy, dx

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int txi = tile % a.tiles_x;
  const int tyi = (tile / a.tiles_x) % a.tiles_y;
  const int b = tile / (a.tiles_x * a.tiles_y);
  const int y0 = tyi * DTH;
  const int x0 = txi * DTW;
  const int split = blockIdx.z;
  const int s_begin = (int)((int64_t)split * a.nsteps / a.splits);
  const int s_end = (int)((int64_t)(split + 1) * a.nsteps / a.splits);
  const bool x_al = Cin % 8 == 0 && hopper::aligned16(a.x);
  const bool w_al = Cout % 8 == 0 && hopper::aligned16(a.weight);
  const bool g_al = Cout % 8 == 0 && hopper::aligned16(a.grad_out);
  const bool acc_al = Cin % 4 == 0 && hopper::aligned16(a.grad_x_acc);

  for (int e = tid; e < WPIX * GXPIX_B / 16; e += DNT)
    reinterpret_cast<float4*>(s_gx)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = tid; e < 27 * DTP; e += DNT) {
    sums[e] = 0.f;
    // the tile's offsets and mask, once; 0 past the map
    const int p = e / 27;
    const int k = e - 27 * p;
    const int y = y0 + p / DTW;
    const int xx = x0 + p % DTW;
    float v = 0.f;
    if (y < H && xx < W) {
      const int64_t n = ((int64_t)b * H + y) * W + xx;
      v = f32(k < 18 ? a.offset[n * 18 + k] : a.mask[n * 9 + k - 18]);
    }
    s_om[e] = v;
  }
  // the tile's output grad, once: (pixel, 8 channels) pieces
  for (int e = tid; e < DTP * (KP / 8); e += DNT) {
    const int p = e / (KP / 8);
    const int q = e - p * (KP / 8);
    const int y = y0 + p / DTW;
    const int xx = x0 + p % DTW;
    const bool in = y < H && xx < W;
    const int64_t n = ((int64_t)b * H + y) * W + xx;
    hopper::copy8(s_g + (p >> 3) * SBO + q * 128 + (p & 7) * 16,
                  in ? a.grad_out + n * Cout + 8 * q : a.grad_out,
                  in ? Cout - 8 * q : 0, g_al);
  }

  const auto load_window = [&](int chunk) {
    const int c0 = chunk * DCK;
    for (int e = tid; e < WPIX * 8; e += DNT) {
      const int pos = e >> 3;
      const int q = e & 7;
      const int wr = pos / WW;
      const int yy = y0 - h + wr;
      const int xc = x0 - h + (pos - wr * WW);
      const int ch = c0 + 8 * q;
      const bool in = yy >= 0 && yy < H && xc >= 0 && xc < W;
      hopper::copy8(s_win + pos * XPIX_B + 16 * q,
                    in ? a.x + (((int64_t)b * H + yy) * W + xc) * Cin + ch
                       : a.x,
                    in ? Cin - ch : 0, x_al);
    }
  };
  // step s's B = w[t]^T (K = output channel, N = input channel of the
  // chunk), K-major: (input channel, 8 output channels) pieces; input
  // channel c goes to B column fragment_column(c), so that each thread's
  // accumulator fragment holds 4 consecutive channels per pair of
  // 8-column groups
  const auto load_weights = [&](int s, int slot) {
    const int chunk = s / 9;
    const int t = s - 9 * chunk;
    unsigned char* dst = s_w + slot * DCK * KP * 2;
    const bf16* wtap = a.weight + (int64_t)t * Cin * Cout;
    for (int e = tid; e < DCK * (KP / 8); e += DNT) {
      const int c = e / (KP / 8);
      const int q = e - c * (KP / 8);
      const int ch = chunk * DCK + c;
      const bool in = ch < Cin;
      const int n = fragment_column(c);
      hopper::copy8(dst + (n >> 3) * SBO + q * 128 + (n & 7) * 16,
                    in ? wtap + (int64_t)ch * Cout + 8 * q : a.weight,
                    in ? Cout - 8 * q : 0, w_al);
    }
  };
  // grad-x tile -> grad_x_acc (global atomics), zeroing the tile
  const auto flush = [&](int chunk) {
    const int c0 = chunk * DCK;
    for (int e = tid; e < WPIX * (DCK / 4); e += DNT) {
      const int pos = e >> 4;
      const int q = e & 15;
      float4* src = reinterpret_cast<float4*>(
          reinterpret_cast<unsigned char*>(s_gx) + pos * GXPIX_B + 16 * q);
      const float4 v = *src;
      *src = make_float4(0.f, 0.f, 0.f, 0.f);
      const int wr = pos / WW;
      const int yy = y0 - h + wr;
      const int xc = x0 - h + (pos - wr * WW);
      if (yy < 0 || yy >= H || xc < 0 || xc >= W) continue;
      const int ch = c0 + 4 * q;
      if (ch >= Cin || (v.x == 0.f && v.y == 0.f && v.z == 0.f && v.w == 0.f))
        continue;
      float* dst = a.grad_x_acc + (((int64_t)b * H + yy) * W + xc) * Cin + ch;
      if (acc_al && ch + 4 <= Cin) {
        atomicAdd(reinterpret_cast<float4*>(dst), v);
      } else {
        const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (ch + i < Cin) atomicAdd(dst + i, vs[i]);
      }
    }
  };

  DCN_PHASES_BEGIN;  // phase 0: the tile's staging and each step's tail
  load_window(s_begin / 9);
  load_weights(s_begin, 0);
  hopper::cp_async_commit();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int l4 = lane & 3;
  float G[32];
  for (int s = s_begin; s < s_end; ++s) {
    const int i = s - s_begin;
    const int chunk = s / 9;
    const int t = s - 9 * chunk;
    const int ty = t / 3 - 1;
    const int tx = t % 3 - 1;
    const bool chunk_ends = s + 1 == s_end || (s + 1) / 9 != chunk;
    DCN_PHASE(0);
    hopper::cp_async_wait_all();
    hopper::fence_async_shared();
    __syncthreads();  // step s's copies visible; step s - 1's walk and
                      // product done, so its weight slot is free
    DCN_PHASE(1);     // phase 1: copy wait and barrier
    if (!chunk_ends) {
      load_weights(s + 1, (i + 1) & 1);
      hopper::cp_async_commit();
    }

    // G_t = g w[t]^T on the tensor cores
#pragma unroll
    for (int k = 0; k < 32; ++k) G[k] = 0.f;
    hopper::fence_acc(G);
    hopper::wgmma_fence();
    const unsigned char* slot = s_w + (i & 1) * DCK * KP * 2;
    for (int ks = 0; ks < KP / 16; ++ks)
      hopper::wgmma_m64n64k16<0>(G, hopper::desc(s_g + ks * 256, 128, SBO),
                                 hopper::desc(slot + ks * 256, 128, SBO), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_acc(G);
    DCN_PHASE(2);  // phase 2: G on the tensor cores

    // The support walk. This thread holds G for two pixels (tile row
    // `warp`, columns lane / 4 and lane / 4 + 8) and, per pixel, the 16
    // channels 16 m + 4 (lane % 4) + (0..3), m = 0..3: G[4 j + 2 hh + e]
    // with j = 2 m + (0, 1). Per pixel: the tap's clamped offset, the
    // hat and hat' weights of each shift in [-R, R] on each axis (0 for
    // a shift outside the 3 candidates around the offset), and the mask,
    // as in dcn_local_bwd.cu.
    float wya[2][2 * RM + 1], gya[2][2 * RM + 1];
    float wxa[2][2 * RM + 1], gxa[2][2 * RM + 1], m2[2];
    float am[2] = {0.f, 0.f}, ay[2] = {0.f, 0.f}, ax[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float* om = s_om + (16 * warp + (lane >> 2) + 8 * hh) * 27;
      const float dyc = fminf(fmaxf(om[2 * t], -R), R);
      const float dxc = fminf(fmaxf(om[2 * t + 1], -R), R);
      m2[hh] = om[18 + t];
      const float tyd = (float)ty + dyc;
      const float txd = (float)tx + dxc;
      const int fy = (int)rintf(tyd) - ty;
      const int fx = (int)rintf(txd) - tx;
#pragma unroll
      for (int k = -RM; k <= RM; ++k) {
        // shift k is candidate k - f + 1 of 0..2 when |k - f| <= 1
        const bool cy = k >= fy - 1 && k <= fy + 1 && k >= -Ri && k <= Ri;
        const bool cx = k >= fx - 1 && k <= fx + 1 && k >= -Ri && k <= Ri;
        const float uy = tyd - (float)(ty + k);
        const float ux = txd - (float)(tx + k);
        wya[hh][k + RM] = cy ? hat(uy) : 0.f;
        gya[hh][k + RM] = cy ? hat_grad(uy) : 0.f;
        wxa[hh][k + RM] = cx ? hat(ux) : 0.f;
        gxa[hh][k + RM] = cx ? hat_grad(ux) : 0.f;
      }
    }
    // Every integer shift (ky, kx) moves the tile's pixels to distinct
    // window positions, so one shift's grad-x updates never collide.
    // Round k gives warp w (tile row w) the shift row
    // ky = (k + w) mod (2R + 1) - R: within a round the warps write
    // distinct window rows (2R + 1 is odd), a barrier separates the
    // rounds, and within a warp a __syncwarp separates the kx iterations
    // (a lane reads next the positions its neighbour wrote), so grad x is
    // summed in shared memory by plain read-modify-writes, in a fixed
    // order, without atomics. A shift no
    // pixel of the warp needs is skipped; otherwise every lane runs it,
    // a pixel that does not need it with weights that are 0.
    const int nshift = 2 * Ri + 1;
    for (int k = 0; k < nshift; ++k) {
      if (k > 0) __syncthreads();  // the previous round's writes are done
      const int ky = (k + warp) % nshift - Ri;
      const int row = warp + h + ty + ky;
      float wyk[2], gyk[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        wyk[hh] = 0.f;
        gyk[hh] = 0.f;
#pragma unroll
        for (int q = 0; q <= 2 * RM; ++q) {
          wyk[hh] = q == ky + RM ? wya[hh][q] : wyk[hh];
          gyk[hh] = q == ky + RM ? gya[hh][q] : gyk[hh];
        }
      }
#pragma unroll
      for (int kx = -RM; kx <= RM; ++kx) {
        if (kx < -Ri || kx > Ri) continue;
        float wkm[2], gyx[2], wgx[2], wk[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          wk[hh] = wyk[hh] * wxa[hh][kx + RM];
          wkm[hh] = wk[hh] * m2[hh];
          gyx[hh] = gyk[hh] * wxa[hh][kx + RM];
          wgx[hh] = wyk[hh] * gxa[hh][kx + RM];
        }
        if (!__any_sync(0xffffffffu, wk[0] != 0.f || gyx[0] != 0.f ||
                                         wgx[0] != 0.f || wk[1] != 0.f ||
                                         gyx[1] != 0.f || wgx[1] != 0.f))
          continue;
        // both pixels at once: their positions lie 8 columns apart
        const int pos0 = row * WW + (lane >> 2) + h + tx + kx;
        uint2 xv[2][4];
        float4 acc[2][4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int pos = pos0 + 8 * hh;
          const unsigned char* xp = s_win + pos * XPIX_B + 8 * l4;
          const unsigned char* gp = reinterpret_cast<const unsigned char*>(
              s_gx) + pos * GXPIX_B + 16 * l4;
#pragma unroll
          for (int mm = 0; mm < 4; ++mm) {
            xv[hh][mm] = *reinterpret_cast<const uint2*>(xp + 32 * mm);
            acc[hh][mm] = *reinterpret_cast<const float4*>(gp + 64 * mm);
          }
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int pos = pos0 + 8 * hh;
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int mm = 0; mm < 4; ++mm) {
            const float2 v0 = __bfloat1622float2(
                *reinterpret_cast<const bf162*>(&xv[hh][mm].x));
            const float2 v1 = __bfloat1622float2(
                *reinterpret_cast<const bf162*>(&xv[hh][mm].y));
            const float g0 = G[8 * mm + 2 * hh];
            const float g1 = G[8 * mm + 2 * hh + 1];
            const float g2 = G[8 * mm + 4 + 2 * hh];
            const float g3 = G[8 * mm + 4 + 2 * hh + 1];
            d[mm] = fmaf(g0, v0.x, d[mm]);
            d[mm] = fmaf(g1, v0.y, d[mm]);
            d[mm] = fmaf(g2, v1.x, d[mm]);
            d[mm] = fmaf(g3, v1.y, d[mm]);
            acc[hh][mm].x = fmaf(wkm[hh], g0, acc[hh][mm].x);
            acc[hh][mm].y = fmaf(wkm[hh], g1, acc[hh][mm].y);
            acc[hh][mm].z = fmaf(wkm[hh], g2, acc[hh][mm].z);
            acc[hh][mm].w = fmaf(wkm[hh], g3, acc[hh][mm].w);
            *reinterpret_cast<float4*>(
                reinterpret_cast<unsigned char*>(s_gx) + pos * GXPIX_B +
                16 * l4 + 64 * mm) = acc[hh][mm];
          }
          const float dot = (d[0] + d[1]) + (d[2] + d[3]);
          am[hh] = fmaf(wk[hh], dot, am[hh]);
          ay[hh] = fmaf(gyx[hh], dot, ay[hh]);
          ax[hh] = fmaf(wgx[hh], dot, ax[hh]);
        }
        // the next shift's loads read what the neighbouring lanes just
        // stored
        __syncwarp();
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float vm = am[hh], vy = ay[hh], vx = ax[hh];
#pragma unroll
      for (int k = 1; k < 4; k <<= 1) {
        vm += __shfl_xor_sync(0xffffffffu, vm, k);
        vy += __shfl_xor_sync(0xffffffffu, vy, k);
        vx += __shfl_xor_sync(0xffffffffu, vx, k);
      }
      if (l4 == 0) {
        const int p = 16 * warp + (lane >> 2) + 8 * hh;
        sums[t * DTP + p] += vm;
        sums[(9 + t) * DTP + p] += vy;
        sums[(18 + t) * DTP + p] += vx;
      }
    }

    DCN_PHASE(3);  // phase 3: the support walk and its sums
    if (chunk_ends) {
      __syncthreads();  // the chunk's walks are done
      DCN_PHASE(4);     // phase 4: barrier before the flush
      flush(chunk);
      DCN_PHASE(5);     // phase 5: the flush
      if (s + 1 < s_end) {
        load_window(chunk + 1);
        load_weights(s + 1, (i + 1) & 1);
        hopper::cp_async_commit();
      }
    }
  }

  DCN_PHASE(0);
  DCN_PHASES_END;
  __syncthreads();
  // grad mask = sum G S, grad dy = m clip'(dy) sum G S_y, grad dx alike
  for (int e = tid; e < 9 * DTP; e += DNT) {
    const int t = e / DTP;
    const int p = e - t * DTP;
    const int y = y0 + p / DTW;
    const int xx = x0 + p % DTW;
    if (y >= H || xx >= W) continue;
    const int64_t n = ((int64_t)b * H + y) * W + xx;
    const float* om = s_om + p * 27;
    const float m = om[18 + t];
    const float gm = sums[t * DTP + p];
    const float gdy = m * clip_grad(om[2 * t], R) * sums[(9 + t) * DTP + p];
    const float gdx =
        m * clip_grad(om[2 * t + 1], R) * sums[(18 + t) * DTP + p];
    if (a.splits > 1) {
      float* dst = a.partial + ((int64_t)split * a.npix + n) * 27 + 3 * t;
      dst[0] = gdy;
      dst[1] = gdx;
      dst[2] = gm;
    } else {
      a.grad_offset[n * 18 + 2 * t] = __float2bfloat16_rn(gdy);
      a.grad_offset[n * 18 + 2 * t + 1] = __float2bfloat16_rn(gdx);
      a.grad_mask[n * 9 + t] = __float2bfloat16_rn(gm);
    }
  }
}

// grad offset and grad mask = bf16(sum over the splits of the partials,
// in split order); one thread per (pixel, tap)
__global__ void dcn_local_bwd_data_bf16_reduce_kernel(
    const float* __restrict__ partial, bf16* __restrict__ grad_offset,
    bf16* __restrict__ grad_mask, int64_t npix, int splits) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= npix * 9) return;
  const int64_t n = e / 9;
  const int t = (int)(e - n * 9);
  float gdy = 0.f, gdx = 0.f, gm = 0.f;
  for (int k = 0; k < splits; ++k) {
    const float* src = partial + ((int64_t)k * npix + n) * 27 + 3 * t;
    gdy += src[0];
    gdx += src[1];
    gm += src[2];
  }
  grad_offset[n * 18 + 2 * t] = __float2bfloat16_rn(gdy);
  grad_offset[n * 18 + 2 * t + 1] = __float2bfloat16_rn(gdx);
  grad_mask[e] = __float2bfloat16_rn(gm);
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

// The gather route of bwd_weight, for the max offsets whose window does
// not fit in shared memory (ops/dcn.bwd_weight_bf16_plan): per (64 x 64)
// tile, tap and pixel split, the corners of each chunk of 32 pixels
// gathered straight from global memory, A_t built as the forward builds
// it (its hat weights by dcn_sample_bf16.cuh), the contraction on wmma
// 16x16x16, a float32 partial tile per split.
__global__ void __launch_bounds__(GNT)
dcn_local_bwd_weight_gather_bf16_kernel(const bf16* __restrict__ x,
                                 const bf16* __restrict__ offset,
                                 const bf16* __restrict__ mask,
                                 const bf16* __restrict__ grad_out,
                                 float* __restrict__ partial,
                                 int npix, int H, int W, int Cin, int Cout,
                                 float R, int per_split) {
  __shared__ int s_idx[4][GP];     // flat pixel index of each corner
  __shared__ float s_wt[4][GP];    // hat weight wy * wx, 0 outside
  __shared__ float s_m[GP];
  __shared__ __align__(32) bf16 s_S[GP][LDS];   // A_t chunk, bf16
  __shared__ __align__(32) bf16 s_g[GP][LDW];
  __shared__ __align__(32) float s_out[GC][LDT];

  const int tid = threadIdx.x;
  const int tiles_o = (Cout + GO - 1) / GO;
  const int c0 = (blockIdx.x / tiles_o) * GC;
  const int o0 = (blockIdx.x % tiles_o) * GO;
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

  for (int q0 = pbeg; q0 < pend; q0 += GP) {
    __syncthreads();  // previous chunk consumed
    if (tid < GP) {
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
        int fy, fx;
        float hw[4];
        dcn_bf16::hats(dy, dx, t, fy, fx, hw);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int yy = y + fy + a;
            const int xc = xx + fx + c;
            const bool inside = yy >= 0 && yy < H && xc >= 0 && xc < W;
            idx[2 * a + c] = inside ? b * HW + yy * W + xc : 0;
            wt[2 * a + c] = inside ? hw[2 * a + c] : 0.f;
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
    for (int e = tid; e < GP * GC / 2; e += GNT) {
      const int cp = e % (GC / 2);
      const int p = e / (GC / 2);
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
    for (int e = tid; e < GP * GO / 2; e += GNT) {
      const int op = e % (GO / 2);
      const int p = e / (GO / 2);
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
    for (int k = 0; k < GP; k += 16) {
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
  for (int e = tid; e < GC * GO; e += GNT) {
    const int o = e % GO;
    const int c = e / GO;
    if (c0 + c < Cin && o0 + o < Cout)
      out[(int64_t)(c0 + c) * Cout + o0 + o] = s_out[c][o];
  }
}

struct WeightArgs {
  const bf16* x;
  const bf16* offset;
  const bf16* mask;
  const bf16* grad_out;
  bf16* grad_w;
  float* partial;
  int H, W, Cin, Cout, R, th, ws;
  int tiles_x, tiles_y, tiles, groups, col_tiles, splits;
};

// The weight-gradient kernel, window route, for N tiles of 64 NB output
// channels. Block (chunk of 64 input channels, group of TPB taps, N tile,
// pixel split): it walks its split's pixel tiles (th x 16 pixels each) in
// order; per tile it builds each tap's A_t (64 channels x th 16 pixels,
// bf16) from the tile's x window and adds A_t^T g into that tap's
// accumulators, half of the N tile per warpgroup. A_t is laid MN-major
// (8 channels of one pixel per 16 bytes: the forward's own A layout) and
// read with trans-a; g, the tile's output gradient, in its own layout,
// read with trans-b.
template <int NB>  // two blocks to an SM at N 64 (3 taps: 48 accumulators)
__global__ void __launch_bounds__(WNT, NB == 1 ? 2 : 1)
dcn_local_bwd_weight_bf16_kernel(const WeightArgs a) {
  constexpr int TPB = weight_taps(NB);  // taps of a block at most
  constexpr int NP = 64 * NB;           // output channels of a block
  constexpr int NH = NP / 2;            // of each warpgroup
  constexpr int TWID = NH < 64 ? NH : 64;  // its wgmma N
  constexpr int NTW = NH / TWID;           // its wgmma N tiles
  constexpr int G_LBO = NP * 16;  // g: bytes between 8-pixel groups
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout;
  const float R = (float)a.R;
  const int th = a.th;
  const int TP = th * WTW;  // pixels of a tile: the K of one tile
  const int h = a.R + 1;
  const int WH = th + 2 * h;
  const int WW = WTW + 2 * h;
  const int win_b = WH * WW * dcn_bf16::PIX_B;
  const int a_bytes = TP * WCK * 2;
  const int g_bytes = TP * NP * 2;
  const int tab_b = TPB * TP * 28;
  unsigned char* s_a = smem;                    // 2 slots
  unsigned char* s_g = s_a + 2 * a_bytes;       // 2 slots
  unsigned char* s_win = s_g + 2 * g_bytes;     // 1 or 2 slots
  unsigned char* s_tab = s_win + a.ws * win_b;  // 2 slots

  const int tid = threadIdx.x;
  int bx = blockIdx.x;
  const int col = bx % a.col_tiles;
  bx /= a.col_tiles;
  const int group = bx % a.groups;
  const int c0 = (bx / a.groups) * WCK;
  const int n0 = col * NP;
  const int t0 = group * TPB;
  const int ntaps = min(TPB, 9 - t0);
  const int split = blockIdx.y;
  const int tbeg = (int)((int64_t)split * a.tiles / a.splits);
  const int tend = (int)((int64_t)(split + 1) * a.tiles / a.splits);
  const bool x_al = Cin % 8 == 0 && hopper::aligned16(a.x);
  const bool g_al = Cout % 8 == 0 && hopper::aligned16(a.grad_out);

  // image and top-left pixel of a tile (order: image, tile row, column)
  const auto origin = [&](int tile, int& b, int& y0, int& x0) {
    const int r = tile / a.tiles_x;
    x0 = (tile - r * a.tiles_x) * WTW;
    b = r / a.tiles_y;
    y0 = (r - b * a.tiles_y) * th;
  };
  // corner table slot: [TPB][4][TP] window indices, [TPB][4][TP] hat
  // weights, [TPB][TP] masks (the forward's layout)
  const auto tab_idx = [&](int slot) {
    return reinterpret_cast<int16_t*>(s_tab + slot * tab_b);
  };
  const auto tab_w = [&](int slot) {
    return reinterpret_cast<float*>(s_tab + slot * tab_b + TPB * 4 * TP * 2);
  };
  const auto tab_m = [&](int slot) { return tab_w(slot) + TPB * 4 * TP; };

  // a tile's x window of this block's channels into window slot `slot`
  const auto load_window = [&](int tile, int slot) {
    int b, y0, x0;
    origin(tile, b, y0, x0);
    unsigned char* dst = s_win + slot * win_b;
    for (int e = tid; e < WH * WW * 8; e += WNT) {
      const int pos = e >> 3;
      const int q = e & 7;
      const int wr = pos / WW;
      const int yy = y0 - h + wr;
      const int xc = x0 - h + (pos - wr * WW);
      const int ch = c0 + 8 * q;
      const bool in = yy >= 0 && yy < H && xc >= 0 && xc < W;
      hopper::copy8(dst + pos * dcn_bf16::PIX_B + ((q ^ (pos & 7)) << 4),
                    in ? a.x + (((int64_t)b * H + yy) * W + xc) * Cin + ch
                       : a.x,
                    in ? Cin - ch : 0, x_al);
    }
  };
  // a tile's output grad, MN-major (8 output channels of one pixel per 16
  // bytes, K = pixel), into g slot `slot`; 0 past the map and past Cout
  const auto load_g = [&](int tile, int slot) {
    int b, y0, x0;
    origin(tile, b, y0, x0);
    unsigned char* dst = s_g + slot * g_bytes;
    for (int e = tid; e < TP * (NP / 8); e += WNT) {
      const int p = e / (NP / 8);
      const int q = e - p * (NP / 8);
      const int y = y0 + p / WTW;
      const int xx = x0 + p % WTW;
      const int o = n0 + 8 * q;
      const bool in = y < H && xx < W;
      hopper::copy8(
          dst + (p >> 3) * G_LBO + q * 128 + (p & 7) * 16,
          in ? a.grad_out + (((int64_t)b * H + y) * W + xx) * Cout + o
             : a.grad_out,
          in ? Cout - o : 0, g_al);
    }
  };
  // This thread's corner-table entry, tap t0 + ej at pixel ep: its
  // offsets and mask are read from global memory at the start of the tile
  // before, and the entry written at that tile's end.
  static_assert(TPB * 64 <= WNT, "one corner-table entry per thread");
  const int ej = tid / TP;
  const int ep = tid - ej * TP;
  float e_dy = 0.f, e_dx = 0.f, e_m = 0.f;
  bool e_in = false;
  const auto fetch_entries = [&](int tile) {
    int b, y0, x0;
    origin(tile, b, y0, x0);
    const int y = y0 + ep / WTW;
    const int xx = x0 + ep % WTW;
    e_in = ej < ntaps && y < H && xx < W;
    if (!e_in) return;
    const int64_t n = ((int64_t)b * H + y) * W + xx;
    const int t = t0 + ej;
    e_dy = f32(a.offset[n * 18 + 2 * t]);
    e_dx = f32(a.offset[n * 18 + 2 * t + 1]);
    e_m = f32(a.mask[n * 9 + t]);
  };
  const auto write_entries = [&](int slot) {
    if (ej >= ntaps) return;
    int idx[4] = {0, 0, 0, 0};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    if (e_in)
      dcn_bf16::corners(fminf(fmaxf(e_dy, -R), R), fminf(fmaxf(e_dx, -R), R),
                        t0 + ej, ep / WTW, ep % WTW, h, WH, WW, idx, wt);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      tab_idx(slot)[(ej * 4 + k) * TP + ep] = (int16_t)idx[k];
      tab_w(slot)[(ej * 4 + k) * TP + ep] = wt[k];
    }
    tab_m(slot)[ej * TP + ep] = e_in ? e_m : 0.f;
  };
  // A_t of tap t0 + j, bf16(m * S_t), 8 channels of one pixel per item, by
  // the forward's code, MN-major into A slot s_ai
  const auto build = [&](int j, int tslot, const unsigned char* win,
                         unsigned char* s_ai) {
    const int p = tid & (TP - 1);
    int pos[4];
    float wk[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      pos[k] = tab_idx(tslot)[(j * 4 + k) * TP + p];
      wk[k] = tab_w(tslot)[(j * 4 + k) * TP + p];
    }
    const float m = tab_m(tslot)[j * TP + p];
    for (int q = tid / TP; q < 8; q += WNT / TP)
      *reinterpret_cast<uint4*>(s_ai + (p >> 3) * A_LBO + q * 128 +
                                (p & 7) * 16) =
          dcn_bf16::sample8(win, pos, wk, m, q);
  };

  const int wg = tid >> 7;  // warpgroup: output channels n0 + NH wg ..
  float acc[TPB][NTW][TWID / 2];
#pragma unroll
  for (int j = 0; j < TPB; ++j)
#pragma unroll
    for (int nb = 0; nb < NTW; ++nb)
#pragma unroll
      for (int i = 0; i < TWID / 2; ++i) acc[j][nb][i] = 0.f;
#pragma unroll
  for (int j = 0; j < TPB; ++j)
#pragma unroll
    for (int nb = 0; nb < NTW; ++nb) hopper::fence_acc(acc[j][nb]);

  // The tile loop, software-pipelined: each tap's A is built while the
  // product of the tap before it (of this tile or the last) runs; the
  // next tile's window flies during this tile (two slots; with one, from
  // the last tap's build on), its g from this tile's first product on,
  // and its offsets and mask during the builds.
  DCN_PHASES_BEGIN;  // phase 0 (with the first tile's staging): copy wait
  if (tbeg < tend) {
    load_window(tbeg, 0);
    load_g(tbeg, 0);
    hopper::cp_async_commit();
    fetch_entries(tbeg);
    write_entries(0);
  }
  int step = 0;  // products issued: A slot step & 1
  for (int tile = tbeg; tile < tend; ++tile) {
    const int slot = (tile - tbeg) & 1;
    const bool next = tile + 1 < tend;
    const unsigned char* win = s_win + (a.ws == 2 ? slot * win_b : 0);
    hopper::cp_async_wait_all();
    DCN_PHASE(0);     // phase 0: the wait for the tile's copies
    hopper::fence_async_shared();
    __syncthreads();  // the tile's window, g and table visible; the last
                      // tile's builds done
    DCN_PHASE(5);     // phase 5: the barrier after it
    if (next) {
      if (a.ws == 2) {
        load_window(tile + 1, slot ^ 1);
        hopper::cp_async_commit();
      }
      DCN_PHASE(6);  // phase 6: the next tile's window copy issued
      fetch_entries(tile + 1);
    }
    DCN_PHASE(7);  // phase 7: its offsets and mask loaded
#pragma unroll
    for (int j = 0; j < TPB; ++j) {
      if (j >= ntaps) break;
      unsigned char* s_ai = s_a + (step & 1) * a_bytes;
      build(j, slot, win, s_ai);
      hopper::fence_async_shared();
      __syncthreads();  // A_t visible to both warpgroups
      DCN_PHASE(1);     // phase 1: building A_t
      if (next && a.ws == 1 && j == ntaps - 1) {
        load_window(tile + 1, 0);  // the window's last build is done
        hopper::cp_async_commit();
      }
      const unsigned char* gs = s_g + slot * g_bytes + wg * (NH / 8) * 128;
      hopper::wgmma_fence();
      for (int ks = 0; ks < TP / 16; ++ks) {
        const uint64_t da =
            hopper::desc(s_ai + 2 * ks * A_LBO, A_LBO, 128);
#pragma unroll
        for (int nb = 0; nb < NTW; ++nb)
          hopper::wgmma_bf16<TWID, 1, 1>(
              acc[j][nb], da,
              hopper::desc(gs + nb * (TWID / 8) * 128 + 2 * ks * G_LBO,
                           G_LBO, 128),
              1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_one();  // this warpgroup's product before is done
      __syncthreads();  // every product before is done: its A slot, and at
                        // the tile's first tap the last tile's g slot, free
      if (next && j == 0) {
        load_g(tile + 1, slot ^ 1);
        hopper::cp_async_commit();
      }
      ++step;
      DCN_PHASE(2);  // phase 2: the product issued, the one before waited
    }
    if (next) write_entries(slot ^ 1);
    DCN_PHASE(4);  // phase 4: the next tile's corner table
  }
  hopper::wgmma_wait_all();
#pragma unroll
  for (int j = 0; j < TPB; ++j)
#pragma unroll
    for (int nb = 0; nb < NTW; ++nb) hopper::fence_acc(acc[j][nb]);

  // epilogue from the fragments: rows (input channels) 16 warp + lane / 4
  // (+ 8), columns (output channels) 8 jj + 2 (lane % 4) (+ 1) of each N
  // tile; bf16 grad w when the pixels are not split, else this split's
  // float32 partial
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const bool pairs = Cout % 2 == 0;
#pragma unroll
  for (int j = 0; j < TPB; ++j) {
    if (j >= ntaps) break;
    const int t = t0 + j;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = c0 + 16 * warp + lane / 4 + 8 * hh;
      if (c >= Cin) continue;
      const int64_t row = ((int64_t)t * Cin + c) * Cout;
#pragma unroll
      for (int nb = 0; nb < NTW; ++nb) {
#pragma unroll
        for (int jj = 0; jj < TWID / 8; ++jj) {
          const int o = n0 + NH * wg + TWID * nb + 8 * jj + 2 * (lane & 3);
          if (o >= Cout) continue;
          const float v0 = acc[j][nb][4 * jj + 2 * hh];
          const float v1 = acc[j][nb][4 * jj + 2 * hh + 1];
          const bool two = o + 1 < Cout;
          if (a.splits > 1) {
            float* dst =
                a.partial + (int64_t)split * 9 * Cin * Cout + row + o;
            if (two && pairs) {
              *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
            } else {
              dst[0] = v0;
              if (two) dst[1] = v1;
            }
          } else {
            bf16* dst = a.grad_w + row + o;
            if (two && pairs) {
              *reinterpret_cast<bf162*>(dst) = __floats2bfloat162_rn(v0, v1);
            } else {
              dst[0] = __float2bfloat16_rn(v0);
              if (two) dst[1] = __float2bfloat16_rn(v1);
            }
          }
        }
      }
    }
  }
  DCN_PHASE(3);  // phase 3: the flush of the accumulators
  DCN_PHASES_END;
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

template <int NB>
int launch_weight(const WeightArgs& a, int chunks, int smem,
                  cudaStream_t s) {
  static int smem_set = 0;  // the dynamic shared memory allowed so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dcn_local_bwd_weight_bf16_kernel<NB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const dim3 grid(chunks * a.groups * a.col_tiles, a.splits);
  dcn_local_bwd_weight_bf16_kernel<NB><<<grid, WNT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int RM>
int launch_data(const DataArgs& a, dim3 grid, int smem, cudaStream_t s) {
  static int smem_set = 0;  // the dynamic shared memory allowed so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dcn_local_bwd_data_bf16_kernel<RM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  dcn_local_bwd_data_bf16_kernel<RM><<<grid, DNT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Both launchers run on `stream`, allocate nothing, do not synchronise,
// and return cudaGetLastError() as an int (0 = ok). All tensors are
// contiguous, in the forward's layouts; grad_out is (B, H, W, Cout) bf16.

// The plan (ops/dcn.bwd_data_bf16_plan) comes in as tile_h, tile_w,
// chunk, splits and the dynamic shared memory in bytes; each is checked
// against this file's constants and the shapes, and a mismatch returns
// cudaErrorInvalidValue before any launch; so does R past 4, the widest
// walk instantiated (ops/dcn.BF16_DATA_MAX_OFFSET). grad_x_acc is
// B * H * W * Cin floats of scratch (zeroed here); `partial` holds
// splits * B * H * W * 27 floats when splits > 1 and may be null
// otherwise; grad_x
// (B, H, W, Cin), grad_offset (B, H, W, 18) and grad_mask (B, H, W, 9)
// are bf16 and fully written.
extern "C" int dcn_local_bwd_data_bf16(
    const bf16* x, const bf16* offset, const bf16* mask, const bf16* weight,
    const bf16* grad_out, float* grad_x_acc, bf16* grad_x, bf16* grad_offset,
    bf16* grad_mask, float* partial, int B, int H, int W, int Cin, int Cout,
    int R, int tile_h, int tile_w, int chunk, int splits, int smem,
    void* stream) {
  const int npix = B * H * W;
  if (npix <= 0 || Cin <= 0) return (int)cudaSuccess;
  const int nsteps = 9 * ((Cin + DCK - 1) / DCK);
  if (Cout <= 0 || tile_h != DTH || tile_w != DTW || chunk != DCK || R < 1 ||
      R > 4 || splits < 1 || splits > nsteps ||
      smem != data_smem_bytes(Cout, R) || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t count = (int64_t)npix * Cin;
  cudaError_t err = cudaMemsetAsync(grad_x_acc, 0, count * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const DataArgs a{x, offset, mask, weight, grad_out, grad_x_acc,
                   grad_offset, grad_mask, partial, npix, H, W, Cin, Cout,
                   R, (W + DTW - 1) / DTW, (H + DTH - 1) / DTH, nsteps,
                   splits};
  const dim3 grid(B * a.tiles_y * a.tiles_x, 1, splits);
  err = (cudaError_t)(R == 1   ? launch_data<1>(a, grid, smem, s)
                      : R == 2 ? launch_data<2>(a, grid, smem, s)
                               : launch_data<4>(a, grid, smem, s));
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  if (splits > 1) {
    const int64_t items = (int64_t)npix * 9;
    dcn_local_bwd_data_bf16_reduce_kernel<<<(unsigned)((items + threads - 1)
                                                       / threads),
                                            threads, 0, s>>>(
        partial, grad_offset, grad_mask, npix, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t pairs = (count + 1) / 2;
  round_to_bf16_kernel<<<(unsigned)((pairs + threads - 1) / threads),
                         threads, 0, s>>>(grad_x_acc, grad_x, count);
  return (int)cudaGetLastError();
}

// The plan (ops/dcn.bwd_weight_bf16_plan) comes in as tile_h (4, 2 or 1),
// tile_w, chunk, n_tile (output channels per block: 64, 128 or 256),
// taps (per block), window_slots (1 or 2), splits (of the pixel tiles)
// and the dynamic shared memory in bytes; each is checked against this
// file's constants and the shapes, and a mismatch returns
// cudaErrorInvalidValue before any launch. grad_w (3, 3, Cin, Cout) bf16
// is fully written; `partial` holds splits * 9 * Cin * Cout floats of
// scratch when splits > 1 and may be null otherwise.
extern "C" int dcn_local_bwd_weight_bf16(
    const bf16* x, const bf16* offset, const bf16* mask,
    const bf16* grad_out, bf16* grad_w, float* partial, int B, int H, int W,
    int Cin, int Cout, int R, int tile_h, int tile_w, int chunk, int n_tile,
    int taps, int window_slots, int splits, int smem, void* stream) {
  const int nb = n_tile / 64;
  const int tiles_x = (W + WTW - 1) / WTW;
  const int tiles_y = tile_h > 0 ? (H + tile_h - 1) / tile_h : 0;
  const int tiles = B * tiles_y * tiles_x;
  if (Cin <= 0 || Cout <= 0 || tiles <= 0 || tile_w != WTW ||
      (tile_h != 4 && tile_h != 2 && tile_h != 1) || chunk != WCK ||
      (nb != 1 && nb != 2 && nb != 4) || n_tile != 64 * nb ||
      (n_tile < Cout && n_tile != 256) || taps != weight_taps(nb) ||
      (window_slots != 1 && window_slots != 2) || R < 1 || splits < 1 ||
      splits > tiles ||
      smem != weight_smem_bytes(nb, taps, R, tile_h, window_slots)
      || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const WeightArgs a{x, offset, mask, grad_out, grad_w, partial, H, W, Cin,
                     Cout, R, tile_h, window_slots, tiles_x, tiles_y, tiles,
                     (9 + taps - 1) / taps, (Cout + n_tile - 1) / n_tile,
                     splits};
  const int chunks = (Cin + WCK - 1) / WCK;
  int err = nb == 1   ? launch_weight<1>(a, chunks, smem, s)
        : nb == 2 ? launch_weight<2>(a, chunks, smem, s)
                  : launch_weight<4>(a, chunks, smem, s);
  if (err != 0 || splits == 1) return err;
  const int64_t count = (int64_t)9 * Cin * Cout;
  const int threads = 256;
  dcn_local_bwd_weight_bf16_reduce_kernel<<<(unsigned)((count + threads -
                                                        1) / threads),
                                            threads, 0, s>>>(
      partial, grad_w, count, splits);
  return (int)cudaGetLastError();
}

// The gather route (ops/dcn.bwd_weight_bf16_plan's route "gather"): grad_w
// (3, 3, Cin, Cout) bf16 is fully written; `partial` holds splits * 9 *
// Cin * Cout floats of scratch.
extern "C" int dcn_local_bwd_weight_gather_bf16(
    const bf16* x, const bf16* offset, const bf16* mask,
    const bf16* grad_out, bf16* grad_w, float* partial, int B, int H, int W,
    int Cin, int Cout, int R, int splits, void* stream) {
  const int npix = B * H * W;
  if (Cin <= 0 || Cout <= 0 || splits < 1 || partial == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int per_split = (((npix + splits - 1) / splits + GP - 1) / GP) * GP;
  const int tiles = ((Cin + GC - 1) / GC) * ((Cout + GO - 1) / GO);
  const dim3 grid(tiles, 9, splits);
  dcn_local_bwd_weight_gather_bf16_kernel<<<grid, GNT, 0, s>>>(
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

// The gather route of bwd_data, `dcn_local_bwd_data_gather_bf16`: the
// planner's choice (ops/dcn.bwd_data_bf16_plan route "gather") where the
// window design does not take the call, for max_offset past 4 (the widest
// support walk instantiated) or a window past 227 KB. It is the first
// design of this kernel, from before the window design, and takes every
// R and every width. One block per tile of 64 pixels and one tap, as in
// the float32 gather route (dcn_local_bwd.cu). Per chunk of 32 input
// channels the block forms G_t(p, c) = sum_o g(p, o) w[t, c, o] on the
// tensor cores (wmma 16x16x16, bf16 in, float32 accumulators; the
// products of two bf16 values are exact in float32), parks G in shared
// memory, and then, one warp per pixel and one lane per channel, walks
// the tap's (up to 3 x 3) support straight from x in global memory to
// accumulate grad mask, grad dy and grad dx (reduced by warp shuffles in
// a fixed order, rounded once) and scatters m hat hat G into the float32
// grad-x scratch with atomicAdd; round_to_bf16_kernel rounds it once.
// What bounds it is what bounds the window design (the float32 bilinear
// work: chip_smoke.py dcn_bwd_bound_ms_bf16); in practice the exposed
// gathers, the g / w staging and the scattered atomics decide its time
// (4.47-4.78 ms per 544 x 960 image at R=1 on an H100 when it was the
// path's kernel). No path launches it.
namespace {
namespace data_gather {

using namespace nvcuda;

constexpr int DP = 64;    // pixels per block
constexpr int DK = 32;    // input channels per chunk (one warp)
constexpr int DO = 32;    // output channels per staged chunk
constexpr int DNT = 256;  // threads (8 warps)
constexpr int DPW = DP / (DNT / 32);  // pixels per warp
constexpr int LDG = DO + 8;  // bf16 pitch of the g and w chunks (80 B)
constexpr int LDC = DK + 4;  // float32 pitch of the G tile

__global__ void __launch_bounds__(DNT)
dcn_local_bwd_data_gather_bf16_kernel(const bf16* __restrict__ x,
                                      const bf16* __restrict__ offset,
                                      const bf16* __restrict__ mask,
                                      const bf16* __restrict__ weight,
                                      const bf16* __restrict__ grad_out,
                                      float* __restrict__ grad_x_acc,
                                      bf16* __restrict__ grad_offset,
                                      bf16* __restrict__ grad_mask, int npix,
                                      int H, int W, int Cin, int Cout,
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
  const int wm = warp % 4;  // G rows (pixels) 16 wm .. 16 wm + 15
  const int wn = warp / 4;  // G cols (channels) 16 wn .. 16 wn + 15
  const int p0 = blockIdx.x * DP;
  const int t = blockIdx.y;
  const int ty = t / 3 - 1;
  const int tx = t % 3 - 1;
  const int HW = H * W;
  const bool g_paired = Cout % 2 == 0 && aligned4(grad_out);
  const bool w_paired = Cout % 2 == 0 && aligned4(weight);

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
          v = load2(wtap + (int64_t)(c0 + k) * Cout + o, Cout - o, w_paired);
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
    if (c >= Cin) continue;  // lanes past Cin (last chunk): nothing to add
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
          const float wk = wy * wx;
          S = fmaf(wk, v, S);
          Sy = fmaf(gy * wx, v, Sy);
          Sx = fmaf(wy * gx, v, Sx);
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

}  // namespace data_gather
}  // namespace

// The gather route of bwd_data: any R >= 1 and any Cin, Cout. grad_x_acc
// is B * H * W * Cin floats of scratch (zeroed here); grad_x (B, H, W,
// Cin), grad_offset (B, H, W, 18) and grad_mask (B, H, W, 9) are bf16 and
// fully written. Launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() as an int; R < 1 or a map
// past 2^31 pixels returns cudaErrorInvalidValue.
extern "C" int dcn_local_bwd_data_gather_bf16(
    const bf16* x, const bf16* offset, const bf16* mask, const bf16* weight,
    const bf16* grad_out, float* grad_x_acc, bf16* grad_x, bf16* grad_offset,
    bf16* grad_mask, int B, int H, int W, int Cin, int Cout, int R,
    void* stream) {
  const int64_t npix = (int64_t)B * H * W;
  if (npix <= 0) return (int)cudaSuccess;
  if (R < 1 || Cin < 0 || Cout < 0 || npix > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t count = npix * Cin;
  cudaError_t err = cudaMemsetAsync(grad_x_acc, 0, count * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((npix + data_gather::DP - 1) / data_gather::DP),
                  9);
  data_gather::dcn_local_bwd_data_gather_bf16_kernel<<<grid,
                                                       data_gather::DNT, 0,
                                                       s>>>(
      x, offset, mask, weight, grad_out, grad_x_acc, grad_offset, grad_mask,
      (int)npix, H, W, Cin, Cout, R);
  err = cudaGetLastError();
  if (err != cudaSuccess || count == 0) return (int)err;
  const int threads = 256;
  const int64_t pairs = (count + 1) / 2;
  round_to_bf16_kernel<<<(unsigned)((pairs + threads - 1) / threads),
                         threads, 0, s>>>(grad_x_acc, grad_x, count);
  return (int)cudaGetLastError();
}
