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
// ops/dcn_pallas_halo.py deform_conv2d_local_halo (whose haloed window
// this kernel keeps in shared memory). The backward is
// dcn_local_bwd_bf16.cu.
//
// What bounds it on the H100: the contraction, 2 * 9 * Cin * Cout
// operations per pixel, at the dense bf16 tensor-core peak
// (989 TFLOP/s); the sampling, about 8 * 9 * Cin float32 operations per
// pixel, at the float32 peak (67 TFLOP/s); together they take longer
// than the 2 * (Cin + 27 + Cout) bytes per pixel at 3.35 TB/s at every
// DLA-34 neck shape, so the bound is the operations' (chip_smoke.py
// dcn_bound_ms_bf16). In practice the sampling's shared-memory reads and
// float32 work, the latency of its inputs, and enough blocks to fill
// 132 SMs decide the time.
//
// What the design does about it. A block (one warpgroup, 128 threads)
// takes a 4 x 16 tile of output pixels of one image, the 64 rows of a
// wgmma M tile, and up to 256 output channels (NB wgmma N tiles of 64),
// so each sample is built once per pixel for all of Cout at the neck.
// Its K loop runs over steps (Cin chunk of 64, tap), chunk-major:
//   - the chunk's x window, the tile with a halo of R + 1 on every side
//     (every corner a clamped offset can reach), is copied global ->
//     shared by cp.async into one of two window slots (one when Cin is
//     a single chunk), zero-filled outside the map and past Cin; the
//     step's (64 x Cout) weight slice into one of two weight slots. Step
//     s + 1's copies fly while step s samples and multiplies.
//   - the block builds A_t (64 pixels x 64 channels, bf16) from the
//     window, 8 channels of one pixel per thread and item, from a corner
//     table (window index, hat weight wy*wx, mask) computed once per
//     block; A is written in the interleaved wgmma layout.
//   - one wgmma m64n64k16 per 16 channels and N tile accumulates in
//     float32 registers; B is the weight slot read MN-major (trans-b).
// Small maps split the K loop over blocks (`splits`, chosen by
// ops/dcn.fwd_bf16_plan so that each launch has at least two blocks per
// SM): each split writes a float32 partial tile, and a second kernel sums
// the partials in split order, adds the bias and rounds once. Without a
// split the block adds the bias and rounds itself. The window's 16-byte
// pieces are XOR-swizzled by window position, so the eight pixels a
// quarter-warp samples read eight bank groups.

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int TH = 4;          // tile rows
constexpr int TW = 16;         // tile columns
constexpr int TP = TH * TW;    // pixels per block: one wgmma M tile
constexpr int CK = 64;         // input channels per chunk
constexpr int NT = 128;        // threads: one warpgroup
constexpr int PIX_B = CK * 2;  // bytes of one window pixel (8 pieces)
constexpr int A_BYTES = TP * CK * 2;
constexpr int A_SBO = (CK / 8) * 128;  // A: bytes between 8-row groups
constexpr int TABLE_BYTES = 9 * 4 * TP * 2 + 9 * 4 * TP * 4 + 9 * TP * 4;

__host__ __device__ constexpr int b_bytes(int nb) { return CK * 64 * nb * 2; }

__host__ __device__ constexpr int window_bytes(int R) {
  return (TH + 2 * (R + 1)) * (TW + 2 * (R + 1)) * PIX_B;
}

// x window slots: two when the K loop has more than one Cin chunk
__host__ __device__ constexpr int window_slots(int nsteps) {
  return nsteps > 9 ? 2 : 1;
}

// A, two weight slots, the window slots, the corner table
__host__ __device__ constexpr int smem_bytes(int nb, int R, int nsteps) {
  return A_BYTES + 2 * b_bytes(nb) + window_slots(nsteps) * window_bytes(R) +
         TABLE_BYTES;
}

__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }

struct Args {
  const bf16* x;
  const bf16* offset;
  const bf16* mask;
  const bf16* weight;
  const bf16* bias;
  bf16* out;
  float* partial;
  int64_t npix;
  int H, W, Cin, Cout, R;
  int tiles_x, tiles_y, nsteps, splits;
};

template <int NB>
__global__ void __launch_bounds__(NT)
dcn_local_fwd_bf16_kernel(const Args a) {
  constexpr int N = 64 * NB;        // output channels per block
  constexpr int B_LBO = N * 16;     // B: bytes between 8-row K groups
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* s_a = smem;
  unsigned char* s_b = s_a + A_BYTES;            // 2 slots
  unsigned char* s_win = s_b + 2 * b_bytes(NB);  // 1 or 2 slots
  const int h = a.R + 1;
  const int WH = TH + 2 * h;
  const int WW = TW + 2 * h;
  const int win_b = WH * WW * PIX_B;
  // the corner table: [9][4][TP] window indices and weights, [9][TP] mask
  int16_t* t_idx =
      reinterpret_cast<int16_t*>(s_win + window_slots(a.nsteps) * win_b);
  float* t_w = reinterpret_cast<float*>(t_idx + 9 * 4 * TP);
  float* t_m = t_w + 9 * 4 * TP;

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int txi = tile % a.tiles_x;
  const int tyi = (tile / a.tiles_x) % a.tiles_y;
  const int b = tile / (a.tiles_x * a.tiles_y);
  const int y0 = tyi * TH;
  const int x0 = txi * TW;
  const int n0 = blockIdx.y * N;
  const int split = blockIdx.z;
  const int s_begin = (int)((int64_t)split * a.nsteps / a.splits);
  const int s_end = (int)((int64_t)(split + 1) * a.nsteps / a.splits);
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout;
  const float R = (float)a.R;
  const bool x_al = Cin % 8 == 0 && hopper::aligned16(a.x);
  const bool w_al = Cout % 8 == 0 && hopper::aligned16(a.weight);

  // the corner table of every (tap, pixel): window index of each corner
  // (clamped into the window; a corner past it has weight 0), the hat
  // weight wy*wx, and the mask; 0 for pixels past the map
  for (int e = tid; e < 9 * TP; e += NT) {
    const int t = e / TP;
    const int p = e - t * TP;
    const int py = p / TW;
    const int px = p - py * TW;
    const int y = y0 + py;
    const int xx = x0 + px;
    int idx[4] = {0, 0, 0, 0};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    float m = 0.f;
    if (y < H && xx < W) {
      const int64_t n = ((int64_t)b * H + y) * W + xx;
      const bf16* o = a.offset + n * 18;
      const float dy = fminf(fmaxf(f32(o[2 * t]), -R), R);
      const float dx = fminf(fmaxf(f32(o[2 * t + 1]), -R), R);
      m = f32(a.mask[n * 9 + t]);
      // tap-relative sample position and its hat weights, computed as
      // the plain version computes max(0, 1 - |(t + d) - a|)
      const float vy = __fadd_rn((float)(t / 3 - 1), dy);
      const float vx = __fadd_rn((float)(t % 3 - 1), dx);
      const float fy = floorf(vy);
      const float fx = floorf(vx);
      const float wy[2] = {1.f - fabsf(vy - fy), 1.f - fabsf(vy - (fy + 1.f))};
      const float wx[2] = {1.f - fabsf(vx - fx), 1.f - fabsf(vx - (fx + 1.f))};
      const int r0 = py + h + (int)fy;  // >= 0: fy >= -1 - R
      const int c0 = px + h + (int)fx;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          idx[2 * i + j] = min(r0 + i, WH - 1) * WW + min(c0 + j, WW - 1);
          wt[2 * i + j] = __fmul_rn(wy[i], wx[j]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      t_idx[(t * 4 + k) * TP + p] = (int16_t)idx[k];
      t_w[(t * 4 + k) * TP + p] = wt[k];
    }
    t_m[t * TP + p] = m;
  }

  // copies of step s: its weight slice into slot `slot`, and, when
  // `window`, its chunk's x window into window slot chunk & 1
  const auto load = [&](int s, int slot, bool window) {
    const int chunk = s / 9;
    const int t = s - 9 * chunk;
    const int c0 = chunk * CK;
    if (window) {
      unsigned char* dst = s_win + (chunk & 1) * win_b;
      for (int e = tid; e < WH * WW * 8; e += NT) {
        const int pos = e >> 3;
        const int q = e & 7;
        const int wr = pos / WW;
        const int yy = y0 - h + wr;
        const int xc = x0 - h + (pos - wr * WW);
        const int ch = c0 + 8 * q;
        const bool in = yy >= 0 && yy < H && xc >= 0 && xc < W;
        const bf16* src =
            in ? a.x + (((int64_t)b * H + yy) * W + xc) * Cin + ch : a.x;
        hopper::copy8(dst + pos * PIX_B + ((q ^ (pos & 7)) << 4), src,
                      in ? Cin - ch : 0, x_al);
      }
    }
    unsigned char* dst = s_b + slot * b_bytes(NB);
    const bf16* wtap = a.weight + (int64_t)t * Cin * Cout;
    for (int e = tid; e < CK * (N / 8); e += NT) {
      const int k = e / (N / 8);
      const int q = e - k * (N / 8);
      const int ch = c0 + k;
      const int o = n0 + 8 * q;
      const bool in = ch < Cin && o < Cout;
      hopper::copy8(dst + (k >> 3) * B_LBO + q * 128 + (k & 7) * 16,
                    in ? wtap + (int64_t)ch * Cout + o : a.weight,
                    in ? Cout - o : 0, w_al);
    }
  };

  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;

  DCN_PHASES_BEGIN;  // phase 0: copies issued, product, next copies
  load(s_begin, 0, true);
  hopper::cp_async_commit();
  for (int s = s_begin; s < s_end; ++s) {
    const int i = s - s_begin;
    const int chunk = s / 9;
    const int t = s - 9 * chunk;
    DCN_PHASE(0);
    hopper::cp_async_wait_all();
    hopper::fence_async_shared();
    __syncthreads();  // step s's copies (and the table) visible; step
                      // s - 1's product done, so its slots are free
    DCN_PHASE(1);     // phase 1: copy wait and barrier
    if (s + 1 < s_end) {
      load(s + 1, (i + 1) & 1, (s + 1) / 9 != chunk);
      hopper::cp_async_commit();
    }

    // A_t = bf16(m * S_t), 8 channels of one pixel per item, term by
    // term as the plain version builds it
    const unsigned char* win = s_win + (chunk & 1) * win_b;
    // this thread's pixel and its four corners, read once per step
    const int p = tid & (TP - 1);
    int pos[4];
    float wk[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      pos[k] = t_idx[(t * 4 + k) * TP + p];
      wk[k] = t_w[(t * 4 + k) * TP + p];
    }
    const float m = t_m[t * TP + p];
#pragma unroll
    for (int it = 0; it < TP * 8 / NT; ++it) {
      const int q = tid / TP + (NT / TP) * it;  // channel octet
      uint4 raw[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        raw[k] = *reinterpret_cast<const uint4*>(
            win + pos[k] * PIX_B + ((q ^ (pos[k] & 7)) << 4));
      float s8[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) s8[c] = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bf162* v = reinterpret_cast<const bf162*>(&raw[k]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float2 f = __bfloat1622float2(v[c]);
          s8[2 * c] = __fadd_rn(s8[2 * c], __fmul_rn(f.x, wk[k]));
          s8[2 * c + 1] = __fadd_rn(s8[2 * c + 1], __fmul_rn(f.y, wk[k]));
        }
      }
      uint4 packed;
      bf162* pk = reinterpret_cast<bf162*>(&packed);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        pk[c] = __floats2bfloat162_rn(__fmul_rn(s8[2 * c], m),
                                      __fmul_rn(s8[2 * c + 1], m));
      *reinterpret_cast<uint4*>(s_a + (p >> 3) * A_SBO + q * 128 +
                                (p & 7) * 16) = packed;
    }
    DCN_PHASE(2);     // phase 2: building A_t
    hopper::fence_async_shared();
    __syncthreads();  // A complete
    DCN_PHASE(3);     // phase 3: barrier before the product

    const unsigned char* bslot = s_b + (i & 1) * b_bytes(NB);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) hopper::fence_acc(acc[nb]);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < CK / 16; ++ks) {
      const uint64_t da = hopper::desc(s_a + ks * 256, 128, A_SBO);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        hopper::wgmma_m64n64k16<1>(
            acc[nb], da,
            hopper::desc(bslot + 2 * ks * B_LBO + nb * 1024, B_LBO, 128), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) hopper::fence_acc(acc[nb]);
  }

  DCN_PHASE(0);
  DCN_PHASES_END;
  // epilogue from the fragments: rows 16 warp + lane / 4 (+ 8), columns
  // 8 j + 2 (lane % 4) (+ 1) of each N tile
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool pairs = Cout % 2 == 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int p = 16 * warp + lane / 4 + 8 * hh;
    const int y = y0 + p / TW;
    const int xx = x0 + p % TW;
    if (y >= H || xx >= W) continue;
    const int64_t n = ((int64_t)b * H + y) * W + xx;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int o = n0 + 64 * nb + 8 * j + 2 * (lane & 3);
        if (o >= Cout) continue;
        float v0 = acc[nb][4 * j + 2 * hh];
        float v1 = acc[nb][4 * j + 2 * hh + 1];
        const bool two = o + 1 < Cout;
        if (a.splits > 1) {
          // float32 partial of this split, summed by the reduce kernel
          float* dst = a.partial + ((int64_t)split * a.npix + n) * Cout + o;
          if (two && pairs) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            dst[0] = v0;
            if (two) dst[1] = v1;
          }
        } else {
          if (a.bias) {
            v0 += f32(a.bias[o]);
            if (two) v1 += f32(a.bias[o + 1]);
          }
          bf16* dst = a.out + n * Cout + o;
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

// out[n, o] = bf16(sum over the splits of partial[s, n, o], in split
// order, + bias[o])
__global__ void dcn_local_fwd_bf16_reduce_kernel(
    const float* __restrict__ partial, const bf16* __restrict__ bias,
    bf16* __restrict__ out, int64_t count, int Cout, int splits) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float v = 0.f;
  for (int k = 0; k < splits; ++k) v += partial[(int64_t)k * count + e];
  if (bias) v += f32(bias[e % Cout]);
  out[e] = __float2bfloat16_rn(v);
}

template <int NB>
int launch(const Args& a, int B, int col_tiles, int smem,
           cudaStream_t stream) {
  static int smem_set = 0;  // the dynamic shared memory allowed so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dcn_local_fwd_bf16_kernel<NB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const dim3 grid(B * a.tiles_y * a.tiles_x, col_tiles, a.splits);
  dcn_local_fwd_bf16_kernel<NB><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan (ops/dcn.fwd_bf16_plan) comes in as tile_h, tile_w, chunk,
// n_tile (output channels per block: 64, 128 or 256), splits and the
// dynamic shared memory in bytes; each is checked against this file's
// constants and the shapes, and a mismatch returns
// cudaErrorInvalidValue before any launch. `partial` holds
// splits * B * H * W * Cout floats when splits > 1 and may be null
// otherwise; `bias` may be null. Launches on `stream`, allocates nothing,
// does not synchronise, and returns cudaGetLastError() as an int.
extern "C" int dcn_local_fwd_bf16(const bf16* x, const bf16* offset,
                                  const bf16* mask, const bf16* weight,
                                  const bf16* bias, bf16* out,
                                  float* partial, int B, int H, int W,
                                  int Cin, int Cout, int R, int tile_h,
                                  int tile_w, int chunk, int n_tile,
                                  int splits, int smem, void* stream) {
  const int npix = B * H * W;
  if (npix <= 0 || Cout <= 0) return (int)cudaSuccess;
  const int nb = n_tile / 64;
  const int nchunks = (Cin + CK - 1) / CK;
  const int nsteps = 9 * (nchunks > 0 ? nchunks : 1);
  if (tile_h != TH || tile_w != TW || chunk != CK || R < 1 ||
      (nb != 1 && nb != 2 && nb != 4) || n_tile != 64 * nb ||
      (n_tile < Cout && n_tile != 256) || splits < 1 || splits > nsteps ||
      smem != smem_bytes(nb, R, nsteps) ||
      (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{x, offset, mask, weight, bias, out, partial, npix, H, W, Cin, Cout, R,
         (W + TW - 1) / TW, (H + TH - 1) / TH, nsteps, splits};
  const cudaStream_t s = (cudaStream_t)stream;
  const int col_tiles = (Cout + n_tile - 1) / n_tile;
  int err = nb == 1   ? launch<1>(a, B, col_tiles, smem, s)
            : nb == 2 ? launch<2>(a, B, col_tiles, smem, s)
                      : launch<4>(a, B, col_tiles, smem, s);
  if (err != 0 || splits == 1) return err;
  const int64_t count = (int64_t)npix * Cout;
  const int threads = 256;
  dcn_local_fwd_bf16_reduce_kernel<<<(unsigned)((count + threads - 1) /
                                                threads),
                                     threads, 0, s>>>(partial, bias, out,
                                                      count, Cout, splits);
  return (int)cudaGetLastError();
}
