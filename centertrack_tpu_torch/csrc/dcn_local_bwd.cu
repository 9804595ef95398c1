// Clamped-offset modulated 3x3 deformable convolution, backward, float32,
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
//   dcn_local_bwd_data: grad x, grad offset, grad mask, with the
//   contraction on the tensor cores in 3xTF32 (hopper.cuh: each operand
//   split into TF32 hi and lo parts, hi*hi + hi*lo + lo*hi summed in
//   float32, float32's accuracy). A block takes a 4 x 16 tile of pixels
//   of one image, with one warpgroup, or two that split each chunk's
//   channels where a block has an SM to itself (by shared memory): the
//   walk below is bound by the latency of its chains of shared-memory
//   read-modify-writes, and the second warpgroup doubles the warps that
//   hide it, on the same shared memory. It copies the tile's
//   output grad g (64 x Cout) global -> shared by cp.async once, splits
//   it into hi and lo in place, and keeps it, with the tile's offsets and
//   mask. Its K loop runs over steps (Cin chunk of CK = 32, 16 or 8
//   channels, by ops/dcn.bwd_data_fp32_plan so that shared memory fits;
//   tap), chunk-major; per chunk the tile's x window with a halo of R + 1
//   (every position a clamped offset's support reaches) is copied by
//   cp.async, zero-filled outside the map and past Cin, and each tap's
//   weight slice, hi and lo, is copied into a weight slot once the
//   previous step's product is done, so it flies during that step's
//   walk. The weight is split into TF32 hi and lo once per call by a
//   small kernel into a scratch (`wsplit`, (2, 9, Cin, Cout padded to
//   8)); w[t]^T is K-major in w's own layout. Per step:
//     - G_t = g w[t]^T (64 pixels x CK channels), three wgmma m64nNWk8
//       per 8 output channels and warpgroup (NW = its CK / 2 channels),
//       float32 accumulators in registers;
//     - each thread walks the support of its two pixels for its NW / 4
//       channels, straight from its accumulator fragment (the weight
//       slice's columns are permuted so that the fragment holds NW / 4
//       consecutive channels): it reads x from the window, sums G x
//       against hat hat, hat' hat and hat hat' for grad mask, grad dy and
//       grad dx (over its channels, then its quad by shuffles, then over
//       chunks in a fixed order), and adds m hat hat G into a float32
//       grad-x tile of the window's extent in shared memory. One integer
//       shift moves the tile's pixels to distinct positions, so the
//       shifts are walked in 2R + 1 rounds in which the four warps write
//       four distinct window rows, with a __syncwarp between shifts:
//       plain read-modify-writes, in a fixed order, no atomics. At
//       max_offset 1 the walk is built with its 9 shifts unrolled.
//   At the end of each chunk the grad-x tile is added into grad x by
//   global atomicAdd (neighbouring tiles' halos overlap), once per block
//   and chunk, not once per support corner, so grad x sums in an order
//   that changes from run to run (rounding-level differences only).
//   Small maps split the K loop over blocks (`splits`, for the fewest
//   waves of blocks at two or more blocks per SM): grad offset and grad
//   mask go
//   to float32 partials per split that a second kernel sums in split
//   order; without a split the block writes them itself. The window's and
//   the grad-x tile's pixel pitches are padded so that the pixels of a
//   warp's accesses start in distinct bank groups.
//
//   dcn_local_bwd_weight: grad w[t] = sum_p A_t(p)^T g(p), A_t = m_t S_t
//   the forward's masked sample, a contraction over all B*H*W pixels on
//   the tensor cores in 3xTF32: D = A_t^T g with M = a chunk of 64 input
//   channels, N = Cout (the whole of it up to 256, half per warpgroup)
//   and K = pixels, so D is grad w[t] in its own (Cin, Cout) layout. A
//   block (two warpgroups) takes a chunk, a group of taps (3, or 1 at N
//   256: each tap's accumulators are N / 4 float32 a thread) and walks
//   its split's pixel tiles (th x 16, th 4, 2 or 1 by
//   ops/dcn.bwd_weight_fp32_plan, so that shared memory fits) in order.
//   Per tile the x window (the tile and a halo of R + 1, 16 pieces of 4
//   channels per position, swizzled) and g^T come in by cp.async a tile
//   ahead (window: two slots, or one from the tile's last build on; g:
//   two slots, from the tile's first product on), and each tap's A_t is
//   built from the window by the forward's corner table and sums, once
//   per (tap, channel, pixel) per launch whatever Cout is; an item is 4
//   pixels x 4 channels, transposed in registers to 4 pixels of one
//   channel per 16 bytes (TF32 operands are K-major only) and split into
//   hi and lo; its product runs while the next tap's A is built (two A
//   slots). g^T, K-major by 4 pixels, is the output grad split into
//   TF32 hi and lo and laid out per tile by a small kernel into a scratch
//   (`gsplit`), so the block copies its image as it is: the split and
//   transposition run once per tile, not once for each of the chunks x
//   tap groups blocks that read the tile (staged through registers by
//   each of them it ran slower, and through shared memory it would need a
//   third of shared memory more).
//   The pixel tiles are split over blocks by the wave rule; the splits'
//   float32 partials are summed in split order by a second kernel, so
//   grad w is the same, bit for bit, on every launch. Past any tile that
//   fits (a max_offset past about 7 at Cout 256), the gather route
//   `dcn_local_bwd_weight_gather`: the first design, corners gathered
//   from global memory per 64 x 64 tile of (Cin, Cout), on the CUDA
//   cores.
//
// What bounds them on the H100. bwd_data: the G contraction (2 * 9 * Cin
// * Cout operations per pixel, three times at the dense TF32 peak,
// 494.7 TFLOP/s) and the bilinear work (38 * 9 * Cin float32 operations
// per pixel at the float32 peak, 67 TFLOP/s), against the float32 bytes
// it must move at 3.35 TB/s; at the DLA-34 neck shapes the operations
// take longer (chip_smoke.py dcn_bwd_bound_ms_3xtf32). In practice the
// support walk's chains of shared-memory read-modify-writes decide its
// time. bwd_weight: the same contraction three times at the TF32 peak
// and the sampling (8 * 9 * Cin per pixel) at the float32 peak
// (chip_smoke.py dcn_bwd_weight_bound_ms_3xtf32); in practice the
// latency of each tile's copies and builds. Nothing of size pixels x
// channels x taps goes to device memory.

#include "hopper.cuh"

namespace {

constexpr int DTH = 4;          // bwd_data: tile rows
constexpr int DTW = 16;         // bwd_data: tile columns
constexpr int DTP = DTH * DTW;  // bwd_data: pixels per block (wgmma M)
constexpr int MAX_R = 8;        // bwd_data: the largest max_offset planned
constexpr int OM_B = DTP * 27 * 4;       // the tile's offsets and mask
constexpr int SUMS_B = 3 * 9 * DTP * 4;  // grad mask, dy, dx sums

constexpr int WNT = 256;         // bwd_weight: threads, two warpgroups
constexpr int WCK = 64;          // bwd_weight: input channels per block
                                 // (wgmma M)
constexpr int WTW = 16;          // bwd_weight: tile columns
constexpr int WPIX_B = WCK * 4;  // bwd_weight: bytes of a window position

// the gather route of bwd_weight (max offsets whose window does not fit)
constexpr int GC = 64;    // input channels per block
constexpr int GO = 64;    // output channels per block
constexpr int GP = 32;    // pixels per shared-memory chunk
constexpr int GNT = 256;  // threads, 16 x 16, 4 x 4 each

// Cout padded to the wgmma K step of 8
__host__ __device__ constexpr int kpad(int cout) { return (cout + 7) / 8 * 8; }

__host__ __device__ constexpr int window_pixels(int R) {
  return (DTH + 2 * (R + 1)) * (DTW + 2 * (R + 1));
}

// bytes of a window or grad-x pixel of a ck-channel chunk: padded by 16
// at ck >= 16, so that the pixels of a quarter- or half-warp's accesses
// start in distinct bank groups (at 8 they already do)
__host__ __device__ constexpr int pitch(int ck) {
  return ck * 4 + (ck >= 16 ? 16 : 0);
}

// g hi and lo, one weight slot of hi and lo, x window, grad-x tile,
// offsets and mask, sums
__host__ __device__ constexpr int data_smem_bytes(int cout, int R, int ck) {
  return 2 * DTP * kpad(cout) * 4 + 2 * ck * kpad(cout) * 4 +
         2 * window_pixels(R) * pitch(ck) + OM_B + SUMS_B;
}

// bwd_weight: taps per block by N tile (64 nb output channels): its
// accumulators, nb 16 float32 a thread and tap, in registers
__host__ __device__ constexpr int weight_taps(int nb) {
  return nb == 4 ? 1 : 3;
}

// bwd_weight's A (64 channels x th 16 pixels, K-major): bytes between
// 8-channel groups, padded by 16 so that the 8 channels a quarter-warp
// stores at once fall in 8 bank groups
__host__ __device__ constexpr int weight_asbo(int th) {
  return th * WTW * 32 + 16;
}

__host__ __device__ constexpr int weight_window_bytes(int R, int th) {
  return (th + 2 * (R + 1)) * (WTW + 2 * (R + 1)) * WPIX_B;
}

// bwd_weight: two A slots and two g slots of hi and lo, the window
// slots, two corner tables (per tap and pixel 4 int16 indices and 4
// weights)
__host__ __device__ constexpr int weight_smem_bytes(int nb, int taps, int R,
                                                    int th, int ws) {
  return 4 * 8 * weight_asbo(th) + 4 * 64 * nb * th * WTW * 4 +
         ws * weight_window_bytes(R, th) + 2 * taps * th * WTW * 24;
}

// hat(u) and its derivative with JAX's rules at the kinks (see above)
__device__ __forceinline__ float hat(float u) {
  return fmaxf(0.f, 1.f - fabsf(u));
}

__device__ __forceinline__ float hat_grad(float u) {
  const float a = fabsf(u);
  const float s = u >= 0.f ? -1.f : 1.f;
  return a < 1.f ? s : (a == 1.f ? 0.5f * s : 0.f);
}

__device__ __forceinline__ float clip_grad(float d, float R) {
  if (d > -R && d < R) return 1.f;
  if (d == -R || d == R) return 0.5f;
  return 0.f;
}

// The wgmma N column that holds input channel c (0..N-1) of a
// warpgroup's N channels: thread quad lane q (lane % 4) holds columns
// 8 j + 2 q + e of its accumulator fragment, j < N / 8, e < 2; channel
// CPT q + 2 j + e goes there, so that each thread holds CPT = N / 4
// consecutive channels.
template <int N>
__device__ __forceinline__ int fragment_column(int c) {
  constexpr int CPT = N / 4;
  const int q = c / CPT;
  const int r = c - q * CPT;
  return 8 * (r >> 1) + 2 * q + (r & 1);
}

// n consecutive float32 of shared memory at p (16-byte aligned when n is
// a multiple of 4, else 8-byte aligned) into v, and back
template <int n>
__device__ __forceinline__ void load_run(const unsigned char* p,
                                         float (&v)[n]) {
  if constexpr (n % 4 == 0) {
#pragma unroll
    for (int u = 0; u < n; u += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + 4 * u);
      v[u] = q.x;
      v[u + 1] = q.y;
      v[u + 2] = q.z;
      v[u + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < n; u += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + 4 * u);
      v[u] = q.x;
      v[u + 1] = q.y;
    }
  }
}

template <int n>
__device__ __forceinline__ void store_run(unsigned char* p,
                                          const float (&v)[n]) {
  if constexpr (n % 4 == 0) {
#pragma unroll
    for (int u = 0; u < n; u += 4)
      *reinterpret_cast<float4*>(p + 4 * u) =
          make_float4(v[u], v[u + 1], v[u + 2], v[u + 3]);
  } else {
#pragma unroll
    for (int u = 0; u < n; u += 2)
      *reinterpret_cast<float2*>(p + 4 * u) = make_float2(v[u], v[u + 1]);
  }
}

struct DataArgs {
  const float* x;
  const float* offset;
  const float* mask;
  const float* wsplit;
  const float* grad_out;
  float* grad_x;
  float* grad_offset;
  float* grad_mask;
  float* partial;
  int64_t npix;
  int H, W, Cin, Cout, R;
  int tiles_x, tiles_y, nsteps, splits;
};

// The data kernel for chunks of CK input channels. Each of its NWG
// warpgroups (1 or 2) takes NW = CK / NWG of them (its wgmma N, at least
// 8) for every pixel of the tile: the warpgroups share the tile's shared
// memory and touch distinct channels of it, so they need a common barrier
// only around the product's weight slot and the chunk's flush. R1 = 1
// builds the walk for max_offset 1 (the DLA-34 dcn_local1 neck), its
// shifts unrolled; R1 = 0 for any max_offset.
template <int CK, int NWG, int R1>
__global__ void __launch_bounds__(128 * NWG)
dcn_local_bwd_data_kernel(const DataArgs a) {
  constexpr int DNT = 128 * NWG;  // threads
  constexpr int NW = CK / NWG;    // channels of a warpgroup
  constexpr int CPT = NW / 4;     // channels per thread and pixel in the walk
  constexpr int P = pitch(CK);
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout, Ri = a.R;
  const float R = (float)Ri;
  const int KP = kpad(Cout);
  const int SBO = KP * 32;  // g tile and weight slot: bytes between
                            // 8-row groups
  const int h = Ri + 1;
  const int WH = DTH + 2 * h;
  const int WW = DTW + 2 * h;
  const int WPIX = WH * WW;
  unsigned char* s_g = smem;                   // DTP x KP, hi then lo
  unsigned char* s_w = s_g + 2 * DTP * KP * 4; // CK x KP, hi then lo
  unsigned char* s_win = s_w + 2 * CK * KP * 4;  // WPIX x P
  unsigned char* s_gx = s_win + WPIX * P;        // WPIX x P, float32
  float* s_om = reinterpret_cast<float*>(s_gx + WPIX * P);  // [DTP][27]
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
  const bool x_al = Cin % 4 == 0 && hopper::aligned16(a.x);
  const bool g_al = Cout % 4 == 0 && hopper::aligned16(a.grad_out);
  const bool acc_al = Cin % 4 == 0 && hopper::aligned16(a.grad_x);

  for (int e = tid; e < WPIX * P / 16; e += DNT)
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
      v = k < 18 ? a.offset[n * 18 + k] : a.mask[n * 9 + k - 18];
    }
    s_om[e] = v;
  }
  // the tile's output grad, once: (pixel, 4 channels) pieces, K-major
  for (int e = tid; e < DTP * (KP / 4); e += DNT) {
    const int p = e / (KP / 4);
    const int q = e - p * (KP / 4);
    const int y = y0 + p / DTW;
    const int xx = x0 + p % DTW;
    const bool in = y < H && xx < W;
    const int64_t n = ((int64_t)b * H + y) * W + xx;
    hopper::copy4(s_g + (p >> 3) * SBO + q * 128 + (p & 7) * 16,
                  in ? a.grad_out + n * Cout + 4 * q : a.grad_out,
                  in ? Cout - 4 * q : 0, g_al);
  }

  const auto load_window = [&](int chunk) {
    const int c0 = chunk * CK;
    for (int e = tid; e < WPIX * (CK / 4); e += DNT) {
      const int pos = e / (CK / 4);
      const int q = e - pos * (CK / 4);
      const int wr = pos / WW;
      const int yy = y0 - h + wr;
      const int xc = x0 - h + (pos - wr * WW);
      const int ch = c0 + 4 * q;
      const bool in = yy >= 0 && yy < H && xc >= 0 && xc < W;
      hopper::copy4(s_win + pos * P + 16 * q,
                    in ? a.x + (((int64_t)b * H + yy) * W + xc) * Cin + ch
                       : a.x,
                    in ? Cin - ch : 0, x_al);
    }
  };
  // step s's B = w[t]^T (K = output channel, N = input channel of the
  // chunk), hi and lo, K-major: (input channel, 4 output channels)
  // pieces of the split weight; input channel c, channel c % NW of
  // warpgroup c / NW, goes to B column NW (c / NW) + fragment_column(c % NW)
  // piece e = (hl CK + c) QP + q of a slice: hl, c and q are stepped
  // from this thread's first piece, without a division per piece
  const int QP = KP / 4;  // pieces of a weight row
  const int row0 = tid / QP, q0 = tid - row0 * QP;
  const int drow = DNT / QP, dq = DNT - drow * QP;
  const auto load_weights = [&](int s) {
    const int chunk = s / 9;
    const int t = s - 9 * chunk;
    int row = row0, q = q0;  // row = hl CK + c
    while (row < 2 * CK) {
      const int hl = row >= CK;
      const int c = row - hl * CK;
      const int ch = chunk * CK + c;
      const bool in = ch < Cin;
      const int n = c / NW * NW + fragment_column<NW>(c % NW);
      hopper::cp_async16(
          s_w + hl * CK * KP * 4 + (n >> 3) * SBO + q * 128 + (n & 7) * 16,
          in ? a.wsplit + (((int64_t)hl * 9 + t) * Cin + ch) * KP + 4 * q
             : a.wsplit,
          in ? 16 : 0);
      row += drow;
      q += dq;
      if (q >= QP) {
        q -= QP;
        ++row;
      }
    }
  };
  // grad-x tile -> grad_x (global atomics), zeroing the tile
  const auto flush = [&](int chunk) {
    const int c0 = chunk * CK;
    for (int e = tid; e < WPIX * (CK / 4); e += DNT) {
      const int pos = e / (CK / 4);
      const int q = e - pos * (CK / 4);
      float4* src = reinterpret_cast<float4*>(s_gx + pos * P + 16 * q);
      const float4 v = *src;
      *src = make_float4(0.f, 0.f, 0.f, 0.f);
      const int wr = pos / WW;
      const int yy = y0 - h + wr;
      const int xc = x0 - h + (pos - wr * WW);
      if (yy < 0 || yy >= H || xc < 0 || xc >= W) continue;
      const int ch = c0 + 4 * q;
      if (ch >= Cin || (v.x == 0.f && v.y == 0.f && v.z == 0.f && v.w == 0.f))
        continue;
      float* dst = a.grad_x + (((int64_t)b * H + yy) * W + xc) * Cin + ch;
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
  load_weights(s_begin);
  hopper::cp_async_commit();
  hopper::cp_async_wait_all();
  __syncthreads();
  // g -> its TF32 hi part in place and its lo part beside it
  for (int e = tid; e < DTP * KP / 4; e += DNT) {
    float4* gp = reinterpret_cast<float4*>(s_g) + e;
    const float4 v = *gp;
    const float4 hi = hopper::tf32_hi(v);
    *gp = hi;
    reinterpret_cast<float4*>(s_g + DTP * KP * 4)[e] = hopper::tf32_lo(v, hi);
  }

  const int wg = tid >> 7;           // warpgroup: channels NW wg ..
  const int warp = (tid >> 5) & 3;   // tile row
  const int lane = tid & 31;
  const int l4 = lane & 3;
  float G[NW / 2];
#pragma unroll
  for (int k = 0; k < NW / 2; ++k) G[k] = 0.f;
  // The sums of grad mask, dy and dx of this thread's two pixels (its
  // quad's lane 0) at a step: warpgroup 0 adds them at the end of its
  // walk, warpgroup 1 after the next block-wide barrier, so they are
  // summed in a fixed order: by step, then by warpgroup.
  float pend[2][3];
  int pend_t = -1;
  const auto add_sums = [&](int tap, const float (&v)[2][3]) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = 16 * warp + (lane >> 2) + 8 * hh;
#pragma unroll
      for (int k = 0; k < 3; ++k) sums[(9 * k + tap) * DTP + p] += v[hh][k];
    }
  };
  for (int s = s_begin; s < s_end; ++s) {
    const int chunk = s / 9;
    const int t = s - 9 * chunk;
    const int ty = t / 3 - 1;
    const int tx = t % 3 - 1;
    const bool chunk_ends = s + 1 == s_end || (s + 1) / 9 != chunk;
    DCN_PHASE(0);
    hopper::cp_async_wait_all();
    hopper::fence_async_shared();
    __syncthreads();  // step s's copies (and g's split) visible; step
                      // s - 1's walk done
    DCN_PHASE(1);     // phase 1: copy wait and barrier
    if (pend_t >= 0) {
      add_sums(pend_t, pend);
      pend_t = -1;
    }

    // G_t = g w[t]^T on the tensor cores, 3xTF32: this warpgroup's NW
    // columns. The first K step overwrites G; each next one moves the
    // four descriptors 256 bytes on (16 in their address field).
    hopper::fence_acc(G);
    hopper::wgmma_fence();
    {
      const unsigned char* s_wg = s_w + wg * (NW / 8) * SBO;
      uint64_t d_ghi = hopper::desc(s_g, 128, SBO);
      uint64_t d_glo = hopper::desc(s_g + DTP * KP * 4, 128, SBO);
      uint64_t d_whi = hopper::desc(s_wg, 128, SBO);
      uint64_t d_wlo = hopper::desc(s_wg + CK * KP * 4, 128, SBO);
      for (int ks = 0; ks < KP / 8; ++ks) {
        hopper::wgmma_3xtf32<NW>(G, d_ghi, d_glo, d_whi, d_wlo, ks > 0);
        d_ghi += 16;
        d_glo += 16;
        d_whi += 16;
        d_wlo += 16;
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_acc(G);
    __syncthreads();  // the whole product is done: the weight slot is free
    DCN_PHASE(2);     // phase 2: G on the tensor cores
    if (!chunk_ends) {
      load_weights(s + 1);  // flies during the walk
      hopper::cp_async_commit();
    }

    // The support walk. This thread holds G for two pixels (tile row
    // `warp`, columns lane / 4 and lane / 4 + 8) and, per pixel, the CPT
    // channels NW wg + CPT l4 + i: G[4 (i / 2) + 2 hh + i % 2]. Per pixel: the
    // tap's clamped offset and the mask, and per shift the hat and hat'
    // weights on each axis (0 away from the offset).
    float tyd[2], txd[2], m2[2];
    float am[2] = {0.f, 0.f}, ay[2] = {0.f, 0.f}, ax[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float* om = s_om + (16 * warp + (lane >> 2) + 8 * hh) * 27;
      tyd[hh] = (float)ty + fminf(fmaxf(om[2 * t], -R), R);
      txd[hh] = (float)tx + fminf(fmaxf(om[2 * t + 1], -R), R);
      m2[hh] = om[18 + t];
    }
    // Every integer shift (ky, kx) moves the tile's pixels to distinct
    // window positions, so one shift's grad-x updates never collide.
    // Round k gives warp w (tile row w) the shift row
    // ky = (k + w) mod (2R + 1) - R: within a round the warps write
    // distinct window rows (2R + 1 is odd), a barrier separates the
    // rounds, and within a warp a __syncwarp separates the kx iterations
    // (a lane reads next the positions its neighbour wrote), so grad x is
    // summed in shared memory by plain read-modify-writes, in a fixed
    // order, without atomics. Every lane runs every shift, a pixel that
    // does not need it with weights that are 0 (skipping the shifts no
    // pixel of a warp needs costs more than it saves). The warpgroups
    // write distinct channels, so each synchronises its rounds on its own
    // barrier.
    const int RW = R1 ? 1 : Ri;  // the walk's max_offset
    const int nshift = 2 * RW + 1;
#pragma unroll
    for (int k = 0; k < nshift; ++k) {
      if (k > 0)  // the previous round's writes are done
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      const int ky = (k + warp) % nshift - RW;
      const int row = warp + h + ty + ky;
      float wyk[2], gyk[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float uy = tyd[hh] - (float)(ty + ky);
        wyk[hh] = hat(uy);
        gyk[hh] = hat_grad(uy);
      }
#pragma unroll
      for (int kx = -RW; kx <= RW; ++kx) {
        float wkm[2], gyx[2], wgx[2], wk[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float ux = txd[hh] - (float)(tx + kx);
          const float wx = hat(ux);
          wk[hh] = wyk[hh] * wx;
          wkm[hh] = wk[hh] * m2[hh];
          gyx[hh] = gyk[hh] * wx;
          wgx[hh] = wyk[hh] * hat_grad(ux);
        }
        // both pixels at once (their positions lie 8 columns apart): all
        // loads, then the sums, then the stores
        const int pos0 = row * WW + (lane >> 2) + h + tx + kx;
        const int off0 = pos0 * P + 4 * (NW * wg + CPT * l4);
        float xv[2][CPT], acc[2][CPT];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          load_run<CPT>(s_win + off0 + 8 * hh * P, xv[hh]);
          load_run<CPT>(s_gx + off0 + 8 * hh * P, acc[hh]);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float d0 = 0.f, d1 = 0.f;
#pragma unroll
          for (int u = 0; u < CPT; u += 2) {
            const float g0 = G[4 * (u >> 1) + 2 * hh];
            const float g1 = G[4 * (u >> 1) + 2 * hh + 1];
            d0 = fmaf(g0, xv[hh][u], d0);
            d1 = fmaf(g1, xv[hh][u + 1], d1);
            acc[hh][u] = fmaf(wkm[hh], g0, acc[hh][u]);
            acc[hh][u + 1] = fmaf(wkm[hh], g1, acc[hh][u + 1]);
          }
          const float d = d0 + d1;
          am[hh] = fmaf(wk[hh], d, am[hh]);
          ay[hh] = fmaf(gyx[hh], d, ay[hh]);
          ax[hh] = fmaf(wgx[hh], d, ax[hh]);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          store_run<CPT>(s_gx + off0 + 8 * hh * P, acc[hh]);
        // the next shift's loads read what the neighbouring lanes just
        // stored
        __syncwarp();
      }
    }
    float v[2][3];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      v[hh][0] = am[hh];
      v[hh][1] = ay[hh];
      v[hh][2] = ax[hh];
#pragma unroll
      for (int k = 1; k < 4; k <<= 1)
#pragma unroll
        for (int q = 0; q < 3; ++q)
          v[hh][q] += __shfl_xor_sync(0xffffffffu, v[hh][q], k);
    }
    if (l4 == 0) {
      if (wg == 0) {
        add_sums(t, v);
      } else {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int q = 0; q < 3; ++q) pend[hh][q] = v[hh][q];
        pend_t = t;
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
        load_weights(s + 1);
        hopper::cp_async_commit();
      }
    }
  }

  DCN_PHASE(0);
  DCN_PHASES_END;
  __syncthreads();
  if (pend_t >= 0) add_sums(pend_t, pend);
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
      a.grad_offset[n * 18 + 2 * t] = gdy;
      a.grad_offset[n * 18 + 2 * t + 1] = gdx;
      a.grad_mask[n * 9 + t] = gm;
    }
  }
}

// grad offset and grad mask = sum over the splits of the partials, in
// split order; one thread per (pixel, tap)
__global__ void dcn_local_bwd_data_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ grad_offset,
    float* __restrict__ grad_mask, int64_t npix, int splits) {
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
  grad_offset[n * 18 + 2 * t] = gdy;
  grad_offset[n * 18 + 2 * t + 1] = gdx;
  grad_mask[e] = gm;
}

// wsplit[hl][t][c][o] = the hi (hl = 0) or lo (1) TF32 part of w[t][c][o],
// o padded to KP with zeros
__global__ void dcn_local_bwd_split_weight_kernel(const float* __restrict__ w,
                                                  float* __restrict__ wsplit,
                                                  int64_t rows, int Cout,
                                                  int KP) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * KP) return;
  const int64_t row = e / KP;
  const int o = (int)(e - row * KP);
  const float v = o < Cout ? w[row * Cout + o] : 0.f;
  const float hi = hopper::tf32_rna(v);
  wsplit[e] = hi;
  wsplit[rows * KP + e] = hopper::tf32_rna(v - hi);
}

template <int CK, int NWG, int R1>
int launch_data_r(const DataArgs& a, dim3 grid, int smem, cudaStream_t s) {
  static int smem_set = 0;  // the dynamic shared memory allowed so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dcn_local_bwd_data_kernel<CK, NWG, R1>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  dcn_local_bwd_data_kernel<CK, NWG, R1><<<grid, 128 * NWG, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int CK, int NWG>
int launch_data(const DataArgs& a, dim3 grid, int smem, cudaStream_t s) {
  return a.R == 1 ? launch_data_r<CK, NWG, 1>(a, grid, smem, s)
                  : launch_data_r<CK, NWG, 0>(a, grid, smem, s);
}

// The gather route of bwd_weight, for the max offsets whose window does
// not fit in shared memory (ops/dcn.bwd_weight_fp32_plan): per (64 x 64)
// tile, tap and pixel split, the corners of each chunk of 32 pixels
// gathered straight from global memory, a 4 x 4 outer product per thread
// on the CUDA cores, a partial tile per split.
__global__ void __launch_bounds__(GNT)
dcn_local_bwd_weight_gather_kernel(const float* __restrict__ x,
                            const float* __restrict__ offset,
                            const float* __restrict__ mask,
                            const float* __restrict__ grad_out,
                            float* __restrict__ partial,
                            int npix, int H, int W, int Cin, int Cout,
                            float R, int per_split) {
  __shared__ int s_idx[GP][4];         // flat pixel index of each corner
  __shared__ float s_wt[GP][4];        // bilinear weight x mask, 0 outside
  __shared__ float s_S[GP][GC];
  __shared__ float s_g[GP][GO];

  const int tid = threadIdx.x;
  const int tiles_o = (Cout + GO - 1) / GO;
  const int c0 = (blockIdx.x / tiles_o) * GC;
  const int o0 = (blockIdx.x % tiles_o) * GO;
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

  for (int q0 = pbeg; q0 < pend; q0 += GP) {
    __syncthreads();  // previous chunk consumed
    if (tid < GP) {
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
    for (int e = tid; e < GP * GC; e += GNT) {
      const int c = e % GC;
      const int p = e / GC;
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
    for (int e = tid; e < GP * GO; e += GNT) {
      const int o = e % GO;
      const int p = e / GO;
      const int n = q0 + p;
      s_g[p][o] = (n < pend && o0 + o < Cout)
                      ? grad_out[(int64_t)n * Cout + o0 + o]
                      : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int p = 0; p < GP; ++p) {
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

// ---- bwd_weight, the window route -------------------------------------

struct WeightArgs {
  const float* x;
  const float* offset;
  const float* mask;
  const float* gsplit;
  float* grad_w;
  float* partial;
  int H, W, Cin, Cout, R, th, ws;
  int tiles_x, tiles_y, tiles, groups, col_tiles, splits;
};

// image and top-left pixel of a tile of th x WTW pixels (order: image,
// tile row, tile column)
__device__ __forceinline__ void tile_origin(int tile, int tiles_x,
                                            int tiles_y, int th, int& b,
                                            int& y0, int& x0) {
  const int r = tile / tiles_x;
  x0 = (tile - r * tiles_x) * WTW;
  b = r / tiles_y;
  y0 = (r - b * tiles_y) * th;
}

// gsplit[tile][col][hl][o / 8][p / 4][o % 8][p % 4] = the TF32 hi (hl =
// 0) or lo (1) part of the output grad at the tile's pixel p and output
// channel 64 NB col + o (0 past the map and past Cout): each tile's g^T,
// K-major by 4 pixels, in the shared-memory image the weight kernel
// copies as it is. One thread per (tile, col, 4 pixels, channel).
__global__ void dcn_local_bwd_split_grad_kernel(
    const float* __restrict__ g, float* __restrict__ gsplit, int H, int W,
    int Cout, int th, int tiles_x, int tiles_y, int np, int col_tiles,
    int64_t items) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= items) return;
  const int TP = th * WTW;
  const int o = (int)(e % np);
  int64_t r = e / np;
  const int pq = (int)(r % (TP / 4));
  r /= TP / 4;
  const int col = (int)(r % col_tiles);
  const int tile = (int)(r / col_tiles);
  int b, y0, x0;
  tile_origin(tile, tiles_x, tiles_y, th, b, y0, x0);
  const int y = y0 + (4 * pq) / WTW;
  const int xs = x0 + (4 * pq) % WTW;
  const int oc = col * np + o;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (y < H && oc < Cout) {
    const float* src = g + ((int64_t)b * H + y) * W * Cout + oc;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (xs + i < W) v[i] = src[(int64_t)(xs + i) * Cout];
  }
  const float4 val = make_float4(v[0], v[1], v[2], v[3]);
  const float4 hi = hopper::tf32_hi(val);
  float* dst = gsplit + ((int64_t)tile * col_tiles + col) * 2 * np * TP +
               (o >> 3) * (TP * 8) + pq * 32 + (o & 7) * 4;
  *reinterpret_cast<float4*>(dst) = hi;
  *reinterpret_cast<float4*>(dst + np * TP) = hopper::tf32_lo(val, hi);
}

// The weight-gradient kernel, window route, for N tiles of 64 NB output
// channels. Block (chunk of 64 input channels, group of TPB taps, N tile,
// pixel split): it walks its split's pixel tiles (th x 16 pixels each) in
// order; per tile it builds each tap's A_t (64 channels x th 16 pixels,
// TF32 hi and lo, K-major: 4 pixels of one channel per 16 bytes) from
// the tile's x window and adds A_t^T g into that tap's accumulators in
// 3xTF32, half of the N tile per warpgroup; g^T comes split and laid out
// by dcn_local_bwd_split_grad_kernel.
template <int NB>
__global__ void __launch_bounds__(WNT, 1)
dcn_local_bwd_weight_kernel(const WeightArgs a) {
  constexpr int TPB = weight_taps(NB);  // taps of a block at most
  constexpr int NP = 64 * NB;           // output channels of a block
  constexpr int NH = NP / 2;            // of each warpgroup
  constexpr int TWID = NH < 64 ? NH : 64;  // its wgmma N
  constexpr int NTW = NH / TWID;           // its wgmma N tiles
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H, W = a.W, Cin = a.Cin;
  const float R = (float)a.R;
  const int th = a.th;
  const int TP = th * WTW;  // pixels of a tile: the K of one tile
  const int ASBO = weight_asbo(th);  // A: bytes between 8-channel groups
  const int GSBO = TP * 32;          // g: bytes between 8-channel groups
  const int h = a.R + 1;
  const int WH = th + 2 * h;
  const int WW = WTW + 2 * h;
  const int win_b = WH * WW * WPIX_B;
  const int a_bytes = 8 * ASBO;    // A hi or lo
  const int g_bytes = NP * TP * 4;  // g hi or lo
  const int tab_b = TPB * TP * 24;
  unsigned char* s_a = smem;                    // [slot][hi, lo]
  unsigned char* s_g = s_a + 4 * a_bytes;       // [slot][hi, lo]
  unsigned char* s_win = s_g + 4 * g_bytes;     // 1 or 2 slots
  unsigned char* s_tab = s_win + a.ws * win_b;  // 2 slots

  const int tid = threadIdx.x;
  int bx = blockIdx.x;
  const int col = bx % a.col_tiles;
  bx /= a.col_tiles;
  const int group = bx % a.groups;
  const int c0 = (bx / a.groups) * WCK;
  const int t0 = group * TPB;
  const int ntaps = min(TPB, 9 - t0);
  const int split = blockIdx.y;
  const int tbeg = (int)((int64_t)split * a.tiles / a.splits);
  const int tend = (int)((int64_t)(split + 1) * a.tiles / a.splits);
  const bool x_al = Cin % 4 == 0 && hopper::aligned16(a.x);

  // corner table slot: [TPB][TP] window indices of the 4 corners (short4)
  // and their weights wy * wx * m (float4)
  const auto tab_idx = [&](int slot) {
    return reinterpret_cast<short4*>(s_tab + slot * tab_b);
  };
  const auto tab_w = [&](int slot) {
    return reinterpret_cast<float4*>(s_tab + slot * tab_b + TPB * TP * 8);
  };
  // a tile's x window of this block's channels into window slot `slot`:
  // 16 pieces of 4 channels per position, piece q at q ^ (pos & 7)
  const auto load_window = [&](int tile, int slot) {
    int b, y0, x0;
    tile_origin(tile, a.tiles_x, a.tiles_y, th, b, y0, x0);
    unsigned char* dst = s_win + slot * win_b;
    for (int e = tid; e < WH * WW * 16; e += WNT) {
      const int pos = e >> 4;
      const int q = e & 15;
      const int wr = pos / WW;
      const int yy = y0 - h + wr;
      const int xc = x0 - h + (pos - wr * WW);
      const int ch = c0 + 4 * q;
      const bool in = yy >= 0 && yy < H && xc >= 0 && xc < W;
      hopper::copy4(dst + pos * WPIX_B + ((q ^ (pos & 7)) << 4),
                    in ? a.x + (((int64_t)b * H + yy) * W + xc) * Cin + ch
                       : a.x,
                    in ? Cin - ch : 0, x_al);
    }
  };
  // a tile's g^T, hi and lo, into g slot `slot`: one contiguous copy
  const auto load_g = [&](int tile, int slot) {
    const float* src =
        a.gsplit + ((int64_t)tile * a.col_tiles + col) * 2 * NP * TP;
    unsigned char* dst = s_g + slot * 2 * g_bytes;
    for (int e = tid; e < NP * TP / 2; e += WNT)
      hopper::cp_async16(dst + 16 * e, src + 4 * e, 16);
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
    tile_origin(tile, a.tiles_x, a.tiles_y, th, b, y0, x0);
    const int y = y0 + ep / WTW;
    const int xx = x0 + ep % WTW;
    e_in = ej < ntaps && y < H && xx < W;
    if (!e_in) return;
    const int64_t n = ((int64_t)b * H + y) * W + xx;
    const int t = t0 + ej;
    e_dy = a.offset[n * 18 + 2 * t];
    e_dx = a.offset[n * 18 + 2 * t + 1];
    e_m = a.mask[n * 9 + t];
  };
  // as dcn_local_fwd's corner table (dcn_local.cu), at index tid = ej TP
  // + ep
  const auto write_entries = [&](int slot) {
    if (ej >= ntaps) return;
    int idx[4] = {0, 0, 0, 0};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    if (e_in) {
      const int t = t0 + ej;
      const float vy = (float)(t / 3 - 1) + fminf(fmaxf(e_dy, -R), R);
      const float vx = (float)(t % 3 - 1) + fminf(fmaxf(e_dx, -R), R);
      const float fy = floorf(vy);
      const float fx = floorf(vx);
      const float ly = vy - fy;
      const float lx = vx - fx;
      const float wy[2] = {1.f - ly, ly};
      const float wx[2] = {1.f - lx, lx};
      const int r0 = ep / WTW + h + (int)fy;  // >= 0: fy >= -1 - R
      const int cc = ep % WTW + h + (int)fx;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          idx[2 * i + j] = min(r0 + i, WH - 1) * WW + min(cc + j, WW - 1);
          wt[2 * i + j] = wy[i] * wx[j] * e_m;
        }
      }
    }
    tab_idx(slot)[tid] = make_short4((short)idx[0], (short)idx[1],
                                     (short)idx[2], (short)idx[3]);
    tab_w(slot)[tid] = make_float4(wt[0], wt[1], wt[2], wt[3]);
  };
  // A_t of tap t0 + j into A slot s_ai (hi, then lo): an item is 4 pixels
  // 4 pq .. 4 pq + 3 x 4 channels 4 q .. 4 q + 3, each sample summed over
  // its corners as the forward sums it, then transposed to 4 pixels of
  // one channel per 16 bytes and split into TF32 hi and lo. The 16
  // channel quartets of one pixel quartet are neighbouring threads, so a
  // quarter-warp reads 8 distinct bank groups of one window position;
  // ASBO's 16 bytes of padding spread its stores over 8 bank groups too.
  const auto build = [&](int j, int tslot, const unsigned char* win,
                         unsigned char* s_ai) {
    const int q = tid & 15;
    for (int pq = tid >> 4; pq < TP / 4; pq += WNT / 16) {
      float4 v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const short4 id = tab_idx(tslot)[j * TP + 4 * pq + i];
        const float4 w4 = tab_w(tslot)[j * TP + 4 * pq + i];
        const int pos[4] = {id.x, id.y, id.z, id.w};
        const float wk[4] = {w4.x, w4.y, w4.z, w4.w};
        v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 c = *reinterpret_cast<const float4*>(
              win + pos[k] * WPIX_B + ((q ^ (pos[k] & 7)) << 4));
          v[i].x = fmaf(c.x, wk[k], v[i].x);
          v[i].y = fmaf(c.y, wk[k], v[i].y);
          v[i].z = fmaf(c.z, wk[k], v[i].z);
          v[i].w = fmaf(c.w, wk[k], v[i].w);
        }
      }
      const float4 u[4] = {make_float4(v[0].x, v[1].x, v[2].x, v[3].x),
                           make_float4(v[0].y, v[1].y, v[2].y, v[3].y),
                           make_float4(v[0].z, v[1].z, v[2].z, v[3].z),
                           make_float4(v[0].w, v[1].w, v[2].w, v[3].w)};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int ch = 4 * q + c;
        const int at = (ch >> 3) * ASBO + pq * 128 + (ch & 7) * 16;
        const float4 hi = hopper::tf32_hi(u[c]);
        *reinterpret_cast<float4*>(s_ai + at) = hi;
        *reinterpret_cast<float4*>(s_ai + a_bytes + at) =
            hopper::tf32_lo(u[c], hi);
      }
    }
  };

  const int wg = tid >> 7;  // warpgroup: output channels NP col + NH wg ..
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
      unsigned char* s_ai = s_a + (step & 1) * 2 * a_bytes;
      build(j, slot, win, s_ai);
      hopper::fence_async_shared();
      __syncthreads();  // A_t visible to both warpgroups
      DCN_PHASE(1);     // phase 1: building A_t
      if (next && a.ws == 1 && j == ntaps - 1) {
        load_window(tile + 1, 0);  // the window's last build is done
        hopper::cp_async_commit();
      }
      // this warpgroup's NH columns: 3xTF32 per 8 pixels and N tile
      const unsigned char* gs =
          s_g + slot * 2 * g_bytes + wg * (NH / 8) * GSBO;
      hopper::wgmma_fence();
      for (int ks = 0; ks < TP / 8; ++ks) {
        const uint64_t a_hi = hopper::desc(s_ai + ks * 256, 128, ASBO);
        const uint64_t a_lo =
            hopper::desc(s_ai + a_bytes + ks * 256, 128, ASBO);
#pragma unroll
        for (int nb = 0; nb < NTW; ++nb) {
          const unsigned char* bt = gs + nb * (TWID / 8) * GSBO + ks * 256;
          hopper::wgmma_3xtf32<TWID>(acc[j][nb], a_hi, a_lo,
                                     hopper::desc(bt, 128, GSBO),
                                     hopper::desc(bt + g_bytes, 128, GSBO));
        }
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
  // tile; grad w when the pixels are not split, else this split's partial
  const int Cout = a.Cout;
  const int n0 = col * NP;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const bool pairs = Cout % 2 == 0;
  float* out = a.splits > 1 ? a.partial + (int64_t)split * 9 * Cin * Cout
                            : a.grad_w;
#pragma unroll
  for (int j = 0; j < TPB; ++j) {
    if (j >= ntaps) break;
    const int t = t0 + j;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int c = c0 + 16 * warp + lane / 4 + 8 * hh;
      if (c >= Cin) continue;
      float* row = out + ((int64_t)t * Cin + c) * Cout;
#pragma unroll
      for (int nb = 0; nb < NTW; ++nb) {
#pragma unroll
        for (int jj = 0; jj < TWID / 8; ++jj) {
          const int o = n0 + NH * wg + TWID * nb + 8 * jj + 2 * (lane & 3);
          if (o >= Cout) continue;
          const float v0 = acc[j][nb][4 * jj + 2 * hh];
          const float v1 = acc[j][nb][4 * jj + 2 * hh + 1];
          if (o + 1 < Cout && pairs) {
            *reinterpret_cast<float2*>(row + o) = make_float2(v0, v1);
          } else {
            row[o] = v0;
            if (o + 1 < Cout) row[o + 1] = v1;
          }
        }
      }
    }
  }
  DCN_PHASE(3);  // phase 3: the flush of the accumulators
  DCN_PHASES_END;
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

template <int NB>
int launch_weight(const WeightArgs& a, int chunks, int smem,
                  cudaStream_t s) {
  static int smem_set = 0;  // the dynamic shared memory allowed so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dcn_local_bwd_weight_kernel<NB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const dim3 grid(chunks * a.groups * a.col_tiles, a.splits);
  dcn_local_bwd_weight_kernel<NB><<<grid, WNT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Both launchers run on `stream`, allocate nothing, do not synchronise,
// and return cudaGetLastError() as an int (0 = ok).

// The plan (ops/dcn.bwd_data_fp32_plan) comes in as tile_h, tile_w,
// chunk (32, 16 or 8), warpgroups (1, or 2 from chunk 16), splits and
// the dynamic shared memory in bytes;
// each is checked against this file's constants and the shapes, and a
// mismatch returns cudaErrorInvalidValue before any launch; so does R
// past 8. grad_x must be zero-filled by the caller (each block adds its
// grad-x tile with atomics); `wsplit` holds 2 * 9 * Cin * KP floats of
// scratch (KP = Cout rounded up to 8); `partial` holds
// splits * B * H * W * 27 floats when splits > 1 and may be null
// otherwise; grad_offset (B, H, W, 18) and grad_mask (B, H, W, 9) are
// fully written.
extern "C" int dcn_local_bwd_data(const float* x, const float* offset,
                                  const float* mask, const float* weight,
                                  const float* grad_out, float* grad_x,
                                  float* grad_offset, float* grad_mask,
                                  float* partial, float* wsplit, int B,
                                  int H, int W, int Cin, int Cout, int R,
                                  int tile_h, int tile_w, int chunk,
                                  int warpgroups, int splits, int smem,
                                  void* stream) {
  const int npix = B * H * W;
  if (npix <= 0 || Cin <= 0) return (int)cudaSuccess;
  const int nsteps = 9 * ((Cin + chunk - 1) / (chunk > 0 ? chunk : 1));
  if (Cout <= 0 || tile_h != DTH || tile_w != DTW ||
      (chunk != 32 && chunk != 16 && chunk != 8) ||
      (warpgroups != 1 && (warpgroups != 2 || chunk < 16)) || R < 1 ||
      R > MAX_R ||
      splits < 1 || splits > nsteps ||
      smem != data_smem_bytes(Cout, R, chunk) || wsplit == nullptr ||
      (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  const int64_t rows = (int64_t)9 * Cin;
  const int64_t count = rows * kpad(Cout);
  dcn_local_bwd_split_weight_kernel<<<(unsigned)((count + threads - 1) /
                                                 threads),
                                      threads, 0, s>>>(weight, wsplit, rows,
                                                       Cout, kpad(Cout));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const DataArgs a{x, offset, mask, wsplit, grad_out, grad_x, grad_offset,
                   grad_mask, partial, npix, H, W, Cin, Cout, R,
                   (W + DTW - 1) / DTW, (H + DTH - 1) / DTH, nsteps, splits};
  const dim3 grid(B * a.tiles_y * a.tiles_x, 1, splits);
  const bool two = warpgroups == 2;
  err = (cudaError_t)(
      chunk == 32   ? (two ? launch_data<32, 2>(a, grid, smem, s)
                           : launch_data<32, 1>(a, grid, smem, s))
      : chunk == 16 ? (two ? launch_data<16, 2>(a, grid, smem, s)
                           : launch_data<16, 1>(a, grid, smem, s))
                    : launch_data<8, 1>(a, grid, smem, s));
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int64_t items = (int64_t)npix * 9;
  dcn_local_bwd_data_reduce_kernel<<<(unsigned)((items + threads - 1) /
                                                threads),
                                     threads, 0, s>>>(
      partial, grad_offset, grad_mask, npix, splits);
  return (int)cudaGetLastError();
}

// The plan (ops/dcn.bwd_weight_fp32_plan) comes in as tile_h (4, 2 or 1),
// tile_w, chunk, n_tile (output channels per block: 64, 128 or 256),
// taps (per block), window_slots (1 or 2), splits (of the pixel tiles)
// and the dynamic shared memory in bytes; each is checked against this
// file's constants and the shapes, and a mismatch returns
// cudaErrorInvalidValue before any launch. grad_w (3, 3, Cin, Cout) is
// fully written; `gsplit` holds tiles * col_tiles * 2 * n_tile * tile_h *
// tile_w floats of scratch (the output grad split into TF32 hi and lo by
// tile); `partial` holds splits * 9 * Cin * Cout floats when splits > 1
// and may be null otherwise.
extern "C" int dcn_local_bwd_weight(
    const float* x, const float* offset, const float* mask,
    const float* grad_out, float* grad_w, float* partial, float* gsplit,
    int B, int H, int W, int Cin, int Cout, int R, int tile_h, int tile_w,
    int chunk, int n_tile, int taps, int window_slots, int splits, int smem,
    void* stream) {
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
      smem != weight_smem_bytes(nb, taps, R, tile_h, window_slots) ||
      gsplit == nullptr || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int col_tiles = (Cout + n_tile - 1) / n_tile;
  const int threads = 256;
  const int64_t items =
      (int64_t)tiles * col_tiles * (tile_h * WTW / 4) * n_tile;
  dcn_local_bwd_split_grad_kernel<<<(unsigned)((items + threads - 1) /
                                               threads),
                                    threads, 0, s>>>(
      grad_out, gsplit, H, W, Cout, tile_h, tiles_x, tiles_y, n_tile,
      col_tiles, items);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const WeightArgs a{x, offset, mask, gsplit, grad_w, partial, H, W, Cin,
                     Cout, R, tile_h, window_slots, tiles_x, tiles_y, tiles,
                     (9 + taps - 1) / taps, col_tiles, splits};
  const int chunks = (Cin + WCK - 1) / WCK;
  err = nb == 1   ? launch_weight<1>(a, chunks, smem, s)
        : nb == 2 ? launch_weight<2>(a, chunks, smem, s)
                  : launch_weight<4>(a, chunks, smem, s);
  if (err != 0 || splits == 1) return err;
  const int64_t count = (int64_t)9 * Cin * Cout;
  dcn_local_bwd_weight_reduce_kernel<<<(unsigned)((count + threads - 1) /
                                                  threads),
                                       threads, 0, s>>>(
      partial, grad_w, count, splits);
  return (int)cudaGetLastError();
}

// The gather route (ops/dcn.bwd_weight_fp32_plan's route "gather"): grad_w
// (3, 3, Cin, Cout) is fully written. With splits > 1, `partial` holds
// splits * 9 * Cin * Cout floats of scratch; with splits == 1 it may be
// null.
extern "C" int dcn_local_bwd_weight_gather(
    const float* x, const float* offset, const float* mask,
    const float* grad_out, float* grad_w, float* partial, int B, int H,
    int W, int Cin, int Cout, int R, int splits, void* stream) {
  const int npix = B * H * W;
  if (Cin <= 0 || Cout <= 0 || splits < 1) return (int)cudaErrorInvalidValue;
  if (splits > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  const int per_split = (((npix + splits - 1) / splits + GP - 1) / GP) * GP;
  const int tiles = ((Cin + GC - 1) / GC) * ((Cout + GO - 1) / GO);
  const dim3 grid(tiles, 9, splits);
  float* dst = splits > 1 ? partial : grad_w;
  dcn_local_bwd_weight_gather_kernel<<<grid, GNT, 0, (cudaStream_t)stream>>>(
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

// The gather route of bwd_data, `dcn_local_bwd_data_gather`: the
// planner's choice (ops/dcn.bwd_data_fp32_plan route "gather") where the
// window design does not take the call, for max_offset past 8 (MAX_R) or
// an output-grad tile past shared memory (past about 360 output
// channels). It is the first design of this kernel, from before the
// window design, and takes every R and every width. One block per tile
// of 64 pixels and one tap. Per chunk of 32 input channels it forms
// G_t(p, c) = sum_o g(p, o) w[t, c, o] on the CUDA cores (g and the
// weight slice staged in shared memory 32 output channels at a time),
// then, one warp per pixel and one lane per channel, reads the (up to
// 3 x 3) x values of the tap's support straight from global memory and
// accumulates grad mask_t = sum_c G S_t, grad dy_t = m clip'(dy) sum_c G
// sum_k hat'(.) hat(.) x and grad dx_t likewise (reduced by warp shuffles
// in a fixed order), and adds m hat hat G into grad x at the (<= 4)
// bilinear corners by float32 atomicAdd, so grad x sums in an order that
// changes from run to run (rounding-level differences only). What bounds
// it is what bounds the window design (the operations: chip_smoke.py
// dcn_bwd_data_bound_ms_3xtf32, or dcn_bwd_bound_ms for the same work on
// the CUDA cores, where this route runs); in practice the G contraction
// on the CUDA cores, redone per tap, and the scattered atomics decide its
// time (6.06 ms per 544 x 960 image at R=1 on an H100 when it was the
// path's kernel). No path launches it.
namespace {
namespace data_gather {

constexpr int DP = 64;    // pixels per block
constexpr int DK = 32;    // input channels per chunk (one warp)
constexpr int DO = 32;    // output channels per staged chunk
constexpr int DNT = 256;  // threads (8 warps)
constexpr int DPW = DP / (DNT / 32);  // pixels per warp

__global__ void __launch_bounds__(DNT)
dcn_local_bwd_data_gather_kernel(const float* __restrict__ x,
                                 const float* __restrict__ offset,
                                 const float* __restrict__ mask,
                                 const float* __restrict__ weight,
                                 const float* __restrict__ grad_out,
                                 float* __restrict__ grad_x,
                                 float* __restrict__ grad_offset,
                                 float* __restrict__ grad_mask, int npix,
                                 int H, int W, int Cin, int Cout, int Ri) {
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
    // others are at least 1.5 away); u is formed as (t + d) - (t + k), in
    // JAX's order, so both see a kink at the same inputs
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
        for (int i = 0; i < DPW; ++i)
          G[i] = fmaf(s_g[warp + 8 * i][o], wv, G[i]);
      }
    }
    if (c >= Cin) continue;  // lanes past Cin (last chunk): nothing to add
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
          const float wk = wy * wx;
          S = fmaf(wk, v, S);
          Sy = fmaf(gy * wx, v, Sy);
          Sx = fmaf(wy * gx, v, Sx);
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

}  // namespace data_gather
}  // namespace

// The gather route of bwd_data: any R >= 1 and any Cin, Cout. grad_x must
// be zero-filled by the caller (the kernel adds into it with atomics);
// grad_offset (B, H, W, 18) and grad_mask (B, H, W, 9) are fully written.
// Launches on `stream`, allocates nothing, does not synchronise, and
// returns cudaGetLastError() as an int; R < 1 or a map past 2^31 pixels
// returns cudaErrorInvalidValue.
extern "C" int dcn_local_bwd_data_gather(
    const float* x, const float* offset, const float* mask,
    const float* weight, const float* grad_out, float* grad_x,
    float* grad_offset, float* grad_mask, int B, int H, int W, int Cin,
    int Cout, int R, void* stream) {
  const int64_t npix = (int64_t)B * H * W;
  if (npix <= 0) return (int)cudaSuccess;
  if (R < 1 || Cin < 0 || Cout < 0 || npix > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((npix + data_gather::DP - 1) / data_gather::DP),
                  9);
  data_gather::dcn_local_bwd_data_gather_kernel<<<grid, data_gather::DNT, 0,
                                                  (cudaStream_t)stream>>>(
      x, offset, mask, weight, grad_out, grad_x, grad_offset, grad_mask,
      (int)npix, H, W, Cin, Cout, R);
  return (int)cudaGetLastError();
}
