// Exact modulated 3x3 deformable convolution (DCNv2), forward, at float32
// (`dcn_exact_fwd`, the contraction in 3xTF32 on the tensor cores) and at
// bfloat16 (`dcn_exact_fwd_bf16`), for Hopper (sm_90a).
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
// order without fused multiply-adds (dcn_exact.cuh `corners`), each
// corner's product added in turn, so it matches the plain version bit for
// bit and only the float32 summation order of the contraction differs.
// float32: A_t and w are split into TF32 hi and lo parts and contracted
// three times (hi*hi + hi*lo + lo*hi, "3xTF32"), which keeps float32's
// accuracy. bfloat16: every input is read as float32, A_t is rounded to
// bf16 and contracted with the bf16 weight with float32 accumulation, the
// bias is added in float32 and the sum rounded to bf16 once: where the JAX
// op rounds.
//
// Replaces centertrack_tpu/ops/dcn.py:315 `deform_conv2d`, which has no
// Pallas kernel: XLA runs it as a gather (`_deform_conv2d_slot`, a
// corner-slot gather and one matmul per tap, at h*w >= 4096) or as a dense
// one-hot matmul (`_deform_conv2d_onehot`, below 4096 pixels). The port
// serves `dla_node="dcn"` (every neck node) and the coarse nodes of
// `"dcn_mix"` with these two kernels; they have no backward yet.
//
// What bounds them on the H100: the operations, as for the clamped
// forwards at the same shapes (chip_smoke.py dcn_bound_ms_3xtf32 at
// float32, dcn_bound_ms_bf16 at bfloat16): the contraction, 2 * 9 * Cin *
// Cout per pixel (three times at the TF32 peak at float32, at the bf16
// peak at bfloat16), and the sampling, about 8 * 9 * Cin float32
// operations per pixel, against the bytes of the inputs and the output:
// 0.192 / 0.049 ms for the 16 neck launches of a 544 x 960 frame. In
// practice the sampling's reads, the latency of its inputs and enough
// blocks to fill 132 SMs decide the time.
//
// What the design does about it (the clamped forwards' design,
// dcn_local.cu, with a window that is the tile's own bounding box). A
// block (two warpgroups, 256 threads) takes a 4 x 16 tile of output
// pixels of one image, the 64 rows of a wgmma M tile, and up to 256
// output channels, half of them per warpgroup, so each sample is built
// once per pixel for all of Cout at the neck. Before its K loop the block
// computes its corner table (the top-left corner of each (tap, pixel) and
// the four weights) and, from it, the smallest rectangle of map positions
// holding every live corner of its 64 pixels x 9 taps (dcn_exact.cuh
// `block_box`). Where that box's area is at most the plan's capacity, the
// block takes its window route; else its gather route. The choice is per
// block, made on the device (nothing is read back; a CUDA graph captures
// it), and both routes build the same A_t bit for bit:
//   - window route: each Cin chunk's box (32 float32 or 64 bf16 channels
//     a pixel) is copied global -> shared by cp.async, zero-filled past
//     Cin, into one of two window slots where the plan has two (the next
//     chunk's box flies under a step), else into the one slot once the
//     chunk's last A is built; the corner positions in the table are
//     relative to the box.
//   - gather route: the corners are read from global memory (positions
//     relative to the image), only those of weight not 0.
// The K loop runs over steps (Cin chunk, tap), chunk-major, and is
// software-pipelined: the block builds A_s (64 pixels x one chunk) into one
// of two A slots in the interleaved wgmma layout while the product of step
// s - 1 runs on the tensor cores; the step's weight slice is in one of two
// weight slots (float32: split into TF32 hi and lo and laid K-major once
// per call by a small kernel into a scratch, since TF32 wgmma reads B
// K-major only; bf16: copied as it is, read MN-major). float32: three
// wgmma m64nNk8 per 8 channels and N tile; bf16: one wgmma m64nNk16 per
// 16 channels; N = 32 or 64, float32 accumulators in registers. Small maps
// split the K loop over blocks (`splits`, chosen by
// ops/dcn.exact_fwd_fp32_plan / exact_fwd_bf16_plan for the fewest waves):
// each split writes a float32 partial tile, and a second kernel sums the
// partials in split order, adds the bias once (and rounds, at bf16), so
// two launches give the same bits. A launch given `route_counts` (two
// ints) adds each tile's route to it: window tiles, gather tiles.

#include <type_traits>

#include "dcn_exact.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;
using dcn_exact::PIX_B;
using dcn_exact::TH;
using dcn_exact::TP;
using dcn_exact::TW;

constexpr int NWG = 2;           // warpgroups
constexpr int NT = 128 * NWG;    // threads
constexpr int A_BYTES = TP * 128;  // one part (hi, lo, or the bf16 A) of
                                   // an A slot: 64 pixels x one chunk
constexpr int SBO = 1024;        // A and float32 B: bytes between 8-row
                                 // groups (a row is one chunk: 128 bytes)
// the corner table: the top-left corner's position of every (tap, pixel)
// and its four weights; then the block's box (4 ints). All the block's
// shared memory is dynamic: a static array would count against the
// 227 KB the plans fill
constexpr int TABLE_BYTES = 9 * TP * 4 + 9 * 4 * TP * 4 + 16;
constexpr int PER = (9 * TP + NT - 1) / NT;  // table entries per thread

__host__ __device__ constexpr int chunk_of(bool low) { return low ? 64 : 32; }
__host__ __device__ constexpr int parts_of(bool low) { return low ? 1 : 2; }

// one part of one weight slot: a chunk x 64 nb output channels
__host__ __device__ constexpr int b_bytes(int nb) { return 8192 * nb; }

// two A slots and two weight slots (each of `parts` parts), the window
// slots of `cap` pixels, the corner table
__host__ __device__ constexpr int smem_bytes(int parts, int nb, int cap,
                                             int slots) {
  return 2 * parts * A_BYTES + 2 * parts * b_bytes(nb) + slots * cap * PIX_B +
         TABLE_BYTES;
}

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
struct Args {
  const T* x;
  const T* offset;
  const T* mask;
  const T* weight;      // bf16: read by the kernel
  const float* wsplit;  // float32: the split weight the kernel reads
  const T* bias;
  T* out;
  float* partial;
  int* route_counts;
  int64_t npix;
  int H, W, Cin, Cout, CinP, CoutP;
  int tiles_x, tiles_y, nsteps, splits, slots, cap;
};

// v += c * w, term by term without fused multiply-adds
__device__ __forceinline__ void add4(float4& v, const float4& c, float w) {
  v.x = __fadd_rn(v.x, __fmul_rn(c.x, w));
  v.y = __fadd_rn(v.y, __fmul_rn(c.y, w));
  v.z = __fadd_rn(v.z, __fmul_rn(c.z, w));
  v.w = __fadd_rn(v.w, __fmul_rn(c.w, w));
}

__device__ __forceinline__ void add8(float (&s)[8], const uint4& raw,
                                     float w) {
  const bf162* v = reinterpret_cast<const bf162*>(&raw);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float2 f = __bfloat1622float2(v[c]);
    s[2 * c] = __fadd_rn(s[2 * c], __fmul_rn(f.x, w));
    s[2 * c + 1] = __fadd_rn(s[2 * c + 1], __fmul_rn(f.y, w));
  }
}

// 16 bytes of x at `src` (`live` channels of it inside the row) from
// global memory, zeros past them
__device__ __forceinline__ float4 load_piece(const float* src, int live,
                                             bool aligned) {
  if (live >= 4 && aligned) return __ldg(reinterpret_cast<const float4*>(src));
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = i < live ? src[i] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint4 load_piece(const bf16* src, int live,
                                            bool aligned) {
  if (live >= 8 && aligned) return __ldg(reinterpret_cast<const uint4*>(src));
  bf16 v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = i < live ? src[i] : __float2bfloat16(0.f);
  return *reinterpret_cast<const uint4*>(v);
}

// Piece q of A_t at one pixel whose corners lie at `pos` (box positions in
// the window `win`, or, with win null, pixel indices of the image at `img`
// of x) with weights wk: 4 float32 channels (hi and lo TF32 parts written)
// or 8 bf16 channels, stored at `at` of the A slot `s_ai`. The window
// route reads every corner (a corner of weight 0 is clamped into the box
// and not added); the gather route reads only those of weight not 0.
template <typename T>
__device__ __forceinline__ void sample_piece(unsigned char* s_ai, int at,
                                             const unsigned char* win,
                                             const T* img, int Cin, int ch,
                                             bool x_al, const int (&pos)[4],
                                             const float (&wk)[4], int q) {
  constexpr bool LOW = std::is_same<T, bf16>::value;
  if constexpr (!LOW) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (win) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 c = *reinterpret_cast<const float4*>(
            win + pos[k] * PIX_B + ((q ^ (pos[k] & 7)) << 4));
        if (wk[k] != 0.f) add4(v, c, wk[k]);
      }
    } else if (Cin - ch > 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (wk[k] != 0.f)
          add4(v, load_piece(img + (int64_t)pos[k] * Cin + ch, Cin - ch, x_al),
               wk[k]);
    }
    const float4 hi = hopper::tf32_hi(v);
    *reinterpret_cast<float4*>(s_ai + at) = hi;
    *reinterpret_cast<float4*>(s_ai + A_BYTES + at) = hopper::tf32_lo(v, hi);
  } else {
    float s8[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) s8[c] = 0.f;
    if (win) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            win + pos[k] * PIX_B + ((q ^ (pos[k] & 7)) << 4));
        if (wk[k] != 0.f) add8(s8, raw, wk[k]);
      }
    } else if (Cin - ch > 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (wk[k] != 0.f)
          add8(s8, load_piece(img + (int64_t)pos[k] * Cin + ch, Cin - ch,
                              x_al),
               wk[k]);
    }
    uint4 packed;
    bf162* pk = reinterpret_cast<bf162*>(&packed);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      pk[c] = __floats2bfloat162_rn(s8[2 * c], s8[2 * c + 1]);
    *reinterpret_cast<uint4*>(s_ai + at) = packed;
  }
}

// v0 (and v1 when `two`) at dst, as a pair where `pairs` allows it
__device__ __forceinline__ void store2(float* dst, float v0, float v1,
                                      bool two, bool pairs) {
  if (two && pairs) {
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
  } else {
    dst[0] = v0;
    if (two) dst[1] = v1;
  }
}

__device__ __forceinline__ void store2(bf16* dst, float v0, float v1,
                                       bool two, bool pairs) {
  if (two && pairs) {
    *reinterpret_cast<bf162*>(dst) = __floats2bfloat162_rn(v0, v1);
  } else {
    dst[0] = __float2bfloat16_rn(v0);
    if (two) dst[1] = __float2bfloat16_rn(v1);
  }
}

template <typename T, int NB>
__device__ __forceinline__ void exact_fwd(const Args<T>& a) {
  constexpr bool LOW = std::is_same<T, bf16>::value;
  constexpr int CK = chunk_of(LOW);
  constexpr int PARTS = parts_of(LOW);
  constexpr int N = 64 * NB;               // output channels per block
  constexpr int NH = N / NWG;              // of each warpgroup
  constexpr int TWID = NH < 64 ? NH : 64;  // its wgmma N
  constexpr int NTW = NH / TWID;           // its wgmma N tiles
  constexpr int B_LBO = N * 16;            // bf16 B: bytes between 8-row K
                                           // groups
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* s_a = smem;                                 // [slot][part]
  unsigned char* s_b = s_a + 2 * PARTS * A_BYTES;            // [slot][part]
  unsigned char* s_win = s_b + 2 * PARTS * b_bytes(NB);      // window slots
  const int win_b = a.cap * PIX_B;
  int* t_pos = reinterpret_cast<int*>(s_win + a.slots * win_b);
  float* t_w = reinterpret_cast<float*>(t_pos + 9 * TP);
  int* s_box = reinterpret_cast<int*>(t_w + 9 * 4 * TP);

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
  const bool x_al = Cin % (16 / (int)sizeof(T)) == 0 &&
                    hopper::aligned16(a.x);
  const bool w_al = Cout % 8 == 0 && hopper::aligned16(a.weight);

  DCN_PHASES_BEGIN;  // phase 4: the corner table, the box, the route
  // the corner table of every (tap, pixel) e = t * TP + p: its four
  // weights, and the top-left corner, kept in registers until the box is
  // known; pixels past the map have weight 0
  int e_iy[PER], e_ix[PER];
  int rmin = INT_MAX, rmax = INT_MIN, cmin = INT_MAX, cmax = INT_MIN;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = tid + NT * j;
    e_iy[j] = 0;
    e_ix[j] = 0;
    if (e < 9 * TP) {
      const int t = e / TP;
      const int p = e - t * TP;
      const int y = y0 + p / TW;
      const int xx = x0 + p % TW;
      float wt[4] = {0.f, 0.f, 0.f, 0.f};
      if (y < H && xx < W) {
        const int64_t n = ((int64_t)b * H + y) * W + xx;
        const T* o = a.offset + n * 18;
        int live;
        dcn_exact::corners(y, xx, t, f32(o[2 * t]), f32(o[2 * t + 1]),
                           f32(a.mask[n * 9 + t]), H, W, e_iy[j], e_ix[j],
                           wt, live);
        dcn_exact::fold_box(e_iy[j], e_ix[j], live, rmin, rmax, cmin, cmax);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) t_w[(t * 4 + k) * TP + p] = wt[k];
    }
  }
  const dcn_exact::Box box =
      dcn_exact::block_box(rmin, rmax, cmin, cmax, s_box);
  const bool window = (int64_t)box.bh * box.bw <= a.cap;
  if (a.route_counts && tid == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    atomicAdd(a.route_counts + (window ? 0 : 1), 1);
  // each top-left corner's position: in the box (window route) or in the
  // image (gather route); published by the first step's barrier
  const int stride = window ? box.bw : W;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = tid + NT * j;
    if (e < 9 * TP)
      t_pos[e] = window ? (e_iy[j] - box.r0) * box.bw + (e_ix[j] - box.c0)
                        : e_iy[j] * W + e_ix[j];
  }
  const int area = window ? box.bh * box.bw : 1;
  const T* img = a.x + (int64_t)b * H * W * Cin;
  DCN_PHASE(4);

  // the x box of a Cin chunk into its window slot
  const auto load_window = [&](int chunk) {
    dcn_exact::copy_box(s_win + (a.slots == 2 ? (chunk & 1) * win_b : 0),
                        a.x, b, H, W, Cin, chunk * CK, box, x_al, tid, NT);
  };
  // step s's weight slice into weight slot `slot`: float32 hi and lo from
  // the padded split weight (K-major, no bounds needed); bf16 from w,
  // MN-major, zero past Cin and Cout
  const auto load_weights = [&](int s, int slot) {
    const int chunk = s / 9;
    const int t = s - 9 * chunk;
    if constexpr (!LOW) {
      for (int e = tid; e < 2 * N * 8; e += NT) {
        const int hl = e / (N * 8);
        const int r = e - hl * (N * 8);
        const int n = r >> 3;
        const int kq = r & 7;
        hopper::cp_async16(
            s_b + (2 * slot + hl) * b_bytes(NB) + (n >> 3) * SBO + kq * 128 +
                (n & 7) * 16,
            a.wsplit + (((int64_t)hl * 9 + t) * a.CoutP + n0 + n) * a.CinP +
                chunk * CK + 4 * kq,
            16);
      }
    } else {
      unsigned char* dst = s_b + slot * b_bytes(NB);
      const T* wtap = a.weight + (int64_t)t * Cin * Cout;
      for (int e = tid; e < CK * (N / 8); e += NT) {
        const int k = e / (N / 8);
        const int q = e - k * (N / 8);
        const int ch = chunk * CK + k;
        const int o = n0 + 8 * q;
        const bool in = ch < Cin && o < Cout;
        hopper::copy8(dst + (k >> 3) * B_LBO + q * 128 + (k & 7) * 16,
                      in ? wtap + (int64_t)ch * Cout + o : a.weight,
                      in ? Cout - o : 0, w_al);
      }
    }
  };

  const int wg = tid >> 7;  // warpgroup: output channels n0 + NH wg ..
  float acc[NTW][TWID / 2];
#pragma unroll
  for (int nb = 0; nb < NTW; ++nb)
#pragma unroll
    for (int i = 0; i < TWID / 2; ++i) acc[nb][i] = 0.f;

  // The K loop, software-pipelined: step s builds A_s while the product
  // of step s - 1 is still on the tensor cores, then issues its own
  // product, waits for the one before it, and refills that one's weight
  // slot with step s + 1's slice. A and the weights have two slots each.
  // On the window route the box of the next chunk is copied as early as
  // its slot is free: at the first step of a chunk with two window slots,
  // after the last step's A with one.
#pragma unroll
  for (int nb = 0; nb < NTW; ++nb) hopper::fence_acc(acc[nb]);
  if (window) load_window(s_begin / 9);
  load_weights(s_begin, 0);
  hopper::cp_async_commit();
  for (int s = s_begin; s < s_end; ++s) {
    const int i = s - s_begin;
    const int chunk = s / 9;
    const int t = s - 9 * chunk;
    const bool first = s == s_begin || t == 0;  // of its chunk here
    const bool next_window = window && (chunk + 1) * 9 < s_end &&
                             (a.slots == 2 ? first : t == 8);
    // the box was copied after step s - 1's A (one slot), or by this
    // split's first step (its chunk's only step here); else it was waited
    // for at a barrier before a product of the previous chunk
    if (s == s_begin || (first && (a.slots == 1 || s - 1 == s_begin))) {
      hopper::cp_async_wait_all();
      hopper::fence_async_shared();
      __syncthreads();  // the window (and the table) visible
    }
    DCN_PHASE(0);  // phase 0: the chunk's window wait

    // A_s, one piece (4 float32 or 8 bf16 channels) of one pixel per item,
    // into A slot i & 1
    const unsigned char* win =
        window ? s_win + (a.slots == 2 ? (chunk & 1) * win_b : 0) : nullptr;
    unsigned char* s_ai = s_a + (i & 1) * PARTS * A_BYTES;
    const int p = tid & (TP - 1);
    const int base = t_pos[t * TP + p];
    int pos[4] = {base, base + 1, base + stride, base + stride + 1};
    float wk[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wk[k] = t_w[(t * 4 + k) * TP + p];
      if (window) pos[k] = min(max(pos[k], 0), area - 1);
    }
#pragma unroll
    for (int it = 0; it < TP * 8 / NT; ++it) {
      const int q = tid / TP + (NT / TP) * it;  // piece of the chunk
      sample_piece<T>(s_ai, (p >> 3) * SBO + q * 128 + (p & 7) * 16, win,
                      img, Cin, chunk * CK + q * (16 / (int)sizeof(T)), x_al,
                      pos, wk, q);
    }
    DCN_PHASE(1);  // phase 1: building A_s
    hopper::cp_async_wait_all();
    hopper::fence_async_shared();
    __syncthreads();  // A_s and step s's weights visible
    DCN_PHASE(2);     // phase 2: copy wait and barrier

    // this warpgroup's NH columns of the weight slot; the accumulators
    // are touched by nothing but the products until the loop ends, so
    // product s queues behind product s - 1 without a wait
    hopper::wgmma_fence();
    if constexpr (!LOW) {
      const unsigned char* bslot =
          s_b + 2 * (i & 1) * b_bytes(NB) + wg * (NH / 8) * SBO;
#pragma unroll
      for (int ks = 0; ks < CK / 8; ++ks) {
        const uint64_t a_hi = hopper::desc(s_ai + ks * 256, 128, SBO);
        const uint64_t a_lo =
            hopper::desc(s_ai + A_BYTES + ks * 256, 128, SBO);
#pragma unroll
        for (int nb = 0; nb < NTW; ++nb) {
          const unsigned char* bt = bslot + nb * (TWID / 8) * SBO + ks * 256;
          hopper::wgmma_3xtf32<TWID>(
              acc[nb], a_hi, a_lo, hopper::desc(bt, 128, SBO),
              hopper::desc(bt + b_bytes(NB), 128, SBO));
        }
      }
    } else {
      const unsigned char* bslot = s_b + (i & 1) * b_bytes(NB);
#pragma unroll
      for (int ks = 0; ks < CK / 16; ++ks) {
        const uint64_t da = hopper::desc(s_ai + ks * 256, 128, SBO);
#pragma unroll
        for (int nb = 0; nb < NTW; ++nb)
          hopper::wgmma_bf16<TWID, 0, 1>(
              acc[nb], da,
              hopper::desc(bslot + 2 * ks * B_LBO +
                               (wg * NH + nb * TWID) / 8 * 128,
                           B_LBO, 128),
              1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_one();  // this warpgroup's product s - 1 is done
    __syncthreads();  // every product s - 1 is done: its A and weight
                      // slots are free
    if (s + 1 < s_end || next_window) {
      if (s + 1 < s_end) load_weights(s + 1, (i + 1) & 1);
      if (next_window) load_window(chunk + 1);
      hopper::cp_async_commit();
    }
    DCN_PHASE(3);  // phase 3: the product issued, the last one waited
  }
  hopper::wgmma_wait_all();
#pragma unroll
  for (int nb = 0; nb < NTW; ++nb) hopper::fence_acc(acc[nb]);

  DCN_PHASE(3);
  DCN_PHASES_END;
  // epilogue from the fragments: rows 16 warp + lane / 4 (+ 8), columns
  // 8 j + 2 (lane % 4) (+ 1) of each of the warpgroup's N tiles
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const bool pairs = Cout % 2 == 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int pp = 16 * warp + lane / 4 + 8 * hh;
    const int y = y0 + pp / TW;
    const int xx = x0 + pp % TW;
    if (y >= H || xx >= W) continue;
    const int64_t n = ((int64_t)b * H + y) * W + xx;
#pragma unroll
    for (int nb = 0; nb < NTW; ++nb) {
#pragma unroll
      for (int j = 0; j < TWID / 8; ++j) {
        const int o = n0 + NH * wg + TWID * nb + 8 * j + 2 * (lane & 3);
        if (o >= Cout) continue;
        float v0 = acc[nb][4 * j + 2 * hh];
        float v1 = acc[nb][4 * j + 2 * hh + 1];
        const bool two = o + 1 < Cout;
        if (a.splits > 1) {
          // float32 partial of this split, summed by the reduce kernel
          store2(a.partial + ((int64_t)split * a.npix + n) * Cout + o, v0, v1,
                 two, pairs);
        } else {
          if (a.bias) {
            v0 += f32(a.bias[o]);
            if (two) v1 += f32(a.bias[o + 1]);
          }
          store2(a.out + n * Cout + o, v0, v1, two, pairs);
        }
      }
    }
  }
}

template <int NB>
__global__ void __launch_bounds__(NT, 1)
    dcn_exact_fwd_kernel(const Args<float> a) {
  exact_fwd<float, NB>(a);
}

template <int NB>
__global__ void __launch_bounds__(NT, 1)
    dcn_exact_fwd_bf16_kernel(const Args<bf16> a) {
  exact_fwd<bf16, NB>(a);
}

// out[n, o] = sum over the splits of partial[s, n, o], in split order,
// + bias[o], in out's dtype (bf16: rounded once)
template <typename T>
__global__ void dcn_exact_fwd_reduce_kernel(const float* __restrict__ partial,
                                            const T* __restrict__ bias,
                                            T* __restrict__ out,
                                            int64_t count, int Cout,
                                            int splits) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float v = 0.f;
  for (int k = 0; k < splits; ++k) v += partial[(int64_t)k * count + e];
  if (bias) v += f32(bias[e % Cout]);
  if constexpr (std::is_same<T, bf16>::value)
    out[e] = __float2bfloat16_rn(v);
  else
    out[e] = v;
}

// wsplit[hl][t][n][c] = the hi (hl = 0) or lo (1) TF32 part of w[t][c][n],
// 0 past Cin or Cout: w transposed to K-major by 32 x 32 tiles of shared
// memory, (CoutP, CinP) per tap
__global__ void dcn_exact_fwd_split_weight_kernel(
    const float* __restrict__ w, float* __restrict__ wsplit, int Cin,
    int Cout, int CinP, int CoutP) {
  __shared__ float tile[32][33];
  const int t = blockIdx.z;
  const int c0 = blockIdx.y * 32;
  const int n0 = blockIdx.x * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int c = c0 + r;
    const int n = n0 + threadIdx.x;
    tile[r][threadIdx.x] =
        c < Cin && n < Cout ? w[((int64_t)t * Cin + c) * Cout + n] : 0.f;
  }
  __syncthreads();
  const int64_t half = (int64_t)9 * CoutP * CinP;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int n = n0 + r;
    const int c = c0 + threadIdx.x;
    const float v = tile[threadIdx.x][r];
    const float hi = hopper::tf32_rna(v);
    const int64_t o = ((int64_t)t * CoutP + n) * CinP + c;
    wsplit[o] = hi;
    wsplit[half + o] = hopper::tf32_rna(v - hi);
  }
}

template <typename K, typename T>
int run_kernel(K kernel, int& smem_set, const Args<T>& a, int B,
               int col_tiles, int smem, cudaStream_t stream) {
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const dim3 grid(B * a.tiles_y * a.tiles_x, col_tiles, a.splits);
  kernel<<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int NB>
int launch_nb(const Args<T>& a, int B, int col_tiles, int smem,
              cudaStream_t stream) {
  static int smem_set = 0;  // the dynamic shared memory allowed so far
  if constexpr (std::is_same<T, bf16>::value)
    return run_kernel(dcn_exact_fwd_bf16_kernel<NB>, smem_set, a, B,
                      col_tiles, smem, stream);
  else
    return run_kernel(dcn_exact_fwd_kernel<NB>, smem_set, a, B, col_tiles,
                      smem, stream);
}

// The plan's checks, the weight split (float32), the launch and the
// split partials' sum: see the extern "C" launchers below.
template <typename T>
int launch(Args<T> a, const float* weight32, float* wsplit, int B, int H,
           int W, int Cin, int Cout, int tile_h, int tile_w, int chunk,
           int n_tile, int box_capacity, int window_slots, int splits,
           int smem, cudaStream_t s) {
  constexpr bool LOW = std::is_same<T, bf16>::value;
  constexpr int CK = chunk_of(LOW);
  const int64_t npix = (int64_t)B * H * W;
  if (B < 0 || H < 0 || W < 0 || Cin < 0 || Cout < 0 || npix > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (npix == 0 || Cout == 0) return (int)cudaSuccess;
  const int nb = n_tile / 64;
  const int nchunks = Cin > 0 ? (Cin + CK - 1) / CK : 1;
  const int nsteps = 9 * nchunks;
  if (tile_h != TH || tile_w != TW || chunk != CK ||
      (nb != 1 && nb != 2 && nb != 4) || n_tile != 64 * nb ||
      (window_slots != 1 && window_slots != 2) || box_capacity < 1 ||
      splits < 1 || splits > nsteps || splits > 65535 ||
      smem != smem_bytes(parts_of(LOW), nb, box_capacity, window_slots) ||
      smem > 232448 || (!LOW && wsplit == nullptr) ||
      (splits > 1 && a.partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const int col_tiles = (Cout + n_tile - 1) / n_tile;
  a.npix = npix;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  a.CinP = nchunks * CK;
  a.CoutP = col_tiles * n_tile;
  a.tiles_x = (W + TW - 1) / TW;
  a.tiles_y = (H + TH - 1) / TH;
  a.nsteps = nsteps;
  a.splits = splits;
  a.slots = window_slots;
  a.cap = box_capacity;
  int err;
  if constexpr (!LOW) {
    dcn_exact_fwd_split_weight_kernel<<<dim3(a.CoutP / 32, a.CinP / 32, 9),
                                        dim3(32, 8), 0, s>>>(
        weight32, wsplit, Cin, Cout, a.CinP, a.CoutP);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  err = nb == 1   ? launch_nb<T, 1>(a, B, col_tiles, smem, s)
        : nb == 2 ? launch_nb<T, 2>(a, B, col_tiles, smem, s)
                  : launch_nb<T, 4>(a, B, col_tiles, smem, s);
  if (err != 0 || splits == 1) return err;
  const int64_t count = npix * Cout;
  const int threads = 256;
  dcn_exact_fwd_reduce_kernel<T>
      <<<(unsigned)((count + threads - 1) / threads), threads, 0, s>>>(
          a.partial, a.bias, a.out, count, Cout, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan (ops/dcn.exact_fwd_fp32_plan) comes in as tile_h, tile_w,
// chunk, n_tile (output channels per block: 64, 128 or 256), box_capacity
// (window pixels), window_slots (1 or 2), splits and the dynamic shared
// memory in bytes; each is checked against this file's constants and the
// shapes, and a mismatch returns cudaErrorInvalidValue before any launch;
// so do a map past 2^31 pixels and negative sizes. `wsplit` holds
// 2 * 9 * CoutP * CinP floats of scratch (CinP = Cin rounded up to the
// chunk, CoutP = Cout rounded up to n_tile); `partial` holds splits * B *
// H * W * Cout floats when splits > 1 and may be null otherwise; `bias`
// and `route_counts` (2 ints: window tiles, gather tiles, added to) may be
// null. Any offset; out (B, H, W, Cout) is fully written. Launches on
// `stream`, allocates nothing, reads nothing back, does not synchronise (a
// CUDA graph captures it), and returns cudaGetLastError() as an int.
extern "C" int dcn_exact_fwd(const float* x, const float* offset,
                             const float* mask, const float* weight,
                             const float* bias, float* out, float* partial,
                             float* wsplit, int* route_counts, int B, int H,
                             int W, int Cin, int Cout, int tile_h, int tile_w,
                             int chunk, int n_tile, int box_capacity,
                             int window_slots, int splits, int smem,
                             void* stream) {
  Args<float> a{};
  a.x = x;
  a.offset = offset;
  a.mask = mask;
  a.weight = weight;
  a.wsplit = wsplit;
  a.bias = bias;
  a.out = out;
  a.partial = partial;
  a.route_counts = route_counts;
  return launch(a, weight, wsplit, B, H, W, Cin, Cout, tile_h, tile_w, chunk,
                n_tile, box_capacity, window_slots, splits, smem,
                (cudaStream_t)stream);
}

// The same at bfloat16 (ops/dcn.exact_fwd_bf16_plan): no weight split;
// the sum of the split partials is rounded to bf16 once.
extern "C" int dcn_exact_fwd_bf16(const bf16* x, const bf16* offset,
                                  const bf16* mask, const bf16* weight,
                                  const bf16* bias, bf16* out, float* partial,
                                  int* route_counts, int B, int H, int W,
                                  int Cin, int Cout, int tile_h, int tile_w,
                                  int chunk, int n_tile, int box_capacity,
                                  int window_slots, int splits, int smem,
                                  void* stream) {
  Args<bf16> a{};
  a.x = x;
  a.offset = offset;
  a.mask = mask;
  a.weight = weight;
  a.bias = bias;
  a.out = out;
  a.partial = partial;
  a.route_counts = route_counts;
  return launch(a, nullptr, nullptr, B, H, W, Cin, Cout, tile_h, tile_w,
                chunk, n_tile, box_capacity, window_slots, splits, smem,
                (cudaStream_t)stream);
}
