// Exact modulated 3x3 deformable convolution (DCNv2), backward, at float32
// (`dcn_exact_bwd_data`, `dcn_exact_bwd_weight`: the contractions in 3xTF32
// on the tensor cores) and at bfloat16 (`dcn_exact_bwd_data_bf16`,
// `dcn_exact_bwd_weight_bf16`), for Hopper (sm_90a). The forward is
// dcn_exact.cu, whose header states the function and the layouts:
//
//   out[p, o] = bias[o] + sum_t sum_c  A_t(p, c) * w[t, c, o]
//   A_t(p, c) = sum_k  hat_k(p, t) * m_t(p) * x[b, corner_k(p, t), c]
//
// the sample position py = (y + i - 1) + dy clipped to [-1, H], y0 =
// floor(py), fy = py - y0, hats (1 - fy)(1 - fx), (1 - fy) fx, fy (1 - fx),
// fy fx, corners outside the map reading 0.
//
// Replaces the backward of centertrack_tpu/ops/dcn.py:315 `deform_conv2d`,
// which has no Pallas kernel: JAX trains it by jax.vjp of its XLA op
// (`_deform_conv2d_slot`, ops/dcn.py:140, at h*w >= 4096, and
// `_deform_conv2d_onehot`, :244, below). Its derivative rules are that vjp's,
// which is what autograd of this package's plain version
// (ops/dcn.deform_conv2d_plain) gives: floor' = 0, and the clip's
// derivative clip' = 1 inside (-1, size), 1/2 at exactly -1 or size (zero
// offsets reach that tie at every border tap), 0 outside. With G_t(p, c) =
// sum_o g(p, o) w[t, c, o] and d_k = sum_c G_t(p, c) x[corner_k, c]:
//
//   grad x[corner_k, c]  += m hat_k G_t(p, c)
//   grad mask_t(p)        = sum_k hat_k d_k            (the unmasked sample)
//   grad dy_t(p)          = clip'(py) m sum_k dhat_k/dfy d_k, dx likewise
//   grad w[t]             = sum_p A_t(p)^T g(p)
//
// (dcn_exact.cuh `grad_corners` gives the hats and the derivative weights,
// clip' and m folded in). bfloat16: every input is read as float32 and
// everything runs in float32 on the bf16 values, G from the bf16 g and w
// with float32 sums, A_t rounded to bf16 as the forward rounds it, and each
// gradient rounded to bf16 once: the float32 vjp of the bf16 forward with
// its roundings passed through, which is what the plain version's autograd
// computes at bf16. grad x is summed in a float32 scratch and rounded once
// by a second kernel, never by bf16 atomics.
//
//   dcn_exact_bwd_data[_bf16]: grad x, grad offset, grad mask. A block (one
//   or two warpgroups) takes a 4 x 16 tile of output pixels of one image.
//   It copies the tile's output grad (64 x Cout, float32 split into TF32 hi
//   and lo in place) once by cp.async, and its offsets and mask. From them
//   it finds the tile's data box: the smallest rectangle holding every
//   corner its 64 pixels x 9 taps need (`needed` of grad_corners: inside
//   the map, one weight not 0; one row and one column more than the
//   forward's box of live corners at integer positions). Where the box's
//   area is at most the plan's capacity the block takes its window route,
//   else its gather route; the choice is per block, on the device. Its K
//   loop runs over steps (Cin chunk of CK channels, tap), chunk-major:
//     - per chunk, window route: the box of x (CK channels a pixel) comes
//       in by cp.async, zero-filled past Cin;
//     - G_t = g w[t]^T (64 pixels x CK channels) on the tensor cores,
//       3xTF32 wgmma m64nNk8 at float32 (the weight split into hi and lo
//       once per call by a small kernel into a scratch), bf16 wgmma
//       m64n32k16 at bf16 (g and w read in their own layouts, K-major);
//       the next step's weight slice flies during the walk. An output
//       grad wider than 256 channels is contracted in pieces of 256, each
//       piece's g and w copied per step;
//     - the corner walk: each thread takes two pixels and CPT channels,
//       straight from its accumulator fragment (the weight slice's columns
//       are permuted so that it holds CPT consecutive channels), computes
//       each tap's corners and weights (grad_corners, in the forward's
//       arithmetic), reads x of each needed corner from the window (or
//       global memory), sums d_k over its channels against the three
//       weights, and adds m hat_k G into grad x (float32, or the float32
//       scratch at bf16) by global vector reductions (red.global.add.v4.f32,
//       native on sm_90), since two pixels of a tile, and the halos of
//       neighbouring tiles, may hit one corner. A float32 grad-x tile in
//       shared memory would need atomics there, which sm_90 runs as
//       compare-and-swap loops (ATOMS.CAST.SPIN): such a tile made this
//       kernel about twice as slow (PERF.md).
//   grad offset and grad mask are summed over a thread's channels, then its
//   quad by shuffles, then its warpgroups and the chunks in a fixed order,
//   so they are the same bit for bit on every launch; grad x sums in an
//   order that changes from run to run (rounding-level differences only).
//   Small maps split the K loop over blocks by waves: grad offset and grad
//   mask go to float32 partials per split that a second kernel sums in
//   split order.
//
//   dcn_exact_bwd_weight[_bf16]: grad w[t] = sum_p A_t(p)^T g(p), the
//   design of the clamped weight kernels (dcn_local_bwd.cu,
//   dcn_local_bwd_bf16.cu) with the forward's window: D = A_t^T g with M =
//   a chunk of 64 input channels, N = Cout (up to 256, half per
//   warpgroup), K = pixels. A block takes a chunk, a group of taps (3, or
//   1 at N 256) and walks its split's pixel tiles (th x 16, th 4, 2 or 1)
//   in order. Per tile it computes its taps' corners and the box of their
//   live corners (dcn_exact.cuh `corners`, `block_box`, as the forward
//   does); where the box fits the plan's capacity its x (64 channels a
//   pixel) comes in by cp.async a tile ahead (two slots, or one from the
//   tile's last build on), else the tile builds A_t from global memory.
//   A_t is built as the forward builds it, term by term without fused
//   multiply-adds, so at bf16 it is the bf16 sample the forward
//   contracted. float32: A_t laid K-major (4 pixels of one channel per 16
//   bytes) and split into TF32 hi and lo, g^T split and laid out per tile
//   by a small kernel into a scratch and copied as it is; 3xTF32 wgmma.
//   bf16: A_t MN-major (8 channels of one pixel per 16 bytes, read with
//   trans-a), g in its own layout (trans-b); bf16 wgmma. The pixel tiles
//   are split over blocks by waves; the splits' float32 partials are summed
//   in split order by a second kernel (at bf16 rounded once), so grad w is
//   bit-identical on every launch.
//
// A launch given `route_counts` (two ints) adds each tile's route to them:
// window tiles, gather tiles (the weight kernels: each tile and tap group
// once). ops/dcn.exact_bwd_tile_routes and exact_tile_routes are the two
// rules in PyTorch.
//
// What bounds them on the H100: the G and grad-w contractions, 2 * 9 * Cin
// * Cout operations a pixel each (three times at the dense TF32 peak at
// float32, at the bf16 peak at bf16), and the bilinear work (the data
// kernel about 38 * 9 * Cin float32 operations a pixel, the weight kernel
// 8 * 9 * Cin), against the bytes of the inputs and outputs
// (chip_smoke.py exact_bwd_data_bound_ms, exact_bwd_weight_bound_ms).
// In practice the walk (its reads and grad x's reductions) and the
// latency of each tile's copies decide the time.

#include <climits>
#include <type_traits>

#include "dcn_exact.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;
using dcn_exact::TH;
using dcn_exact::TP;
using dcn_exact::TW;

template <typename T>
__host__ __device__ constexpr bool is_low() {
  return std::is_same<T, bf16>::value;
}

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (is_low<T>())
    return __float2bfloat16_rn(v);
  else
    return v;
}

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
  if (live >= 4 && aligned)
    return __ldg(reinterpret_cast<const float4*>(src));
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
  for (int i = 0; i < 8; ++i)
    v[i] = i < live ? src[i] : __float2bfloat16(0.f);
  return *reinterpret_cast<const uint4*>(v);
}

__device__ __forceinline__ void copy_piece(void* dst, const float* src,
                                           int live, bool aligned) {
  hopper::copy4(dst, src, live, aligned);
}
__device__ __forceinline__ void copy_piece(void* dst, const bf16* src,
                                           int live, bool aligned) {
  hopper::copy8(dst, src, live, aligned);
}

// The wgmma N column that holds channel c (0..N-1) of a warpgroup's N
// channels: thread quad lane q holds columns 8 j + 2 q + e of its
// fragment; channel CPT q + 2 j + e goes there, so that each thread holds
// CPT = N / 4 consecutive channels.
template <int N>
__device__ __forceinline__ int fragment_column(int c) {
  constexpr int CPT = N / 4;
  const int q = c / CPT;
  const int r = c - q * CPT;
  return 8 * (r >> 1) + 2 * q + (r & 1);
}

// ---- the data kernels ---------------------------------------------------

constexpr int OM_B = TP * 27 * 4;       // the tile's offsets and mask
constexpr int SUMS_B = 3 * 9 * TP * 4;  // grad mask, dy, dx sums
constexpr int BOX_B = 16;               // block_box's 4 ints
constexpr int MAX_KC = 256;             // output channels of a G piece

// bytes of a window pixel (CK channels of x), padded by 16 so that
// neighbouring pixels start in other bank groups
template <typename T>
__host__ __device__ constexpr int x_pitch(int ck) {
  return ck * (int)sizeof(T) + 16;
}

// the g tile (float32: hi and lo), one weight slot (hi and lo), the window
// of `cap` pixels, the offsets and mask, the sums, the box
template <typename T>
__host__ __device__ constexpr int data_smem_bytes(int kc, int ck, int cap) {
  return (is_low<T>() ? 1 : 2) * (TP + ck) * kc * (int)sizeof(T) +
         cap * x_pitch<T>(ck) + OM_B + SUMS_B + BOX_B;
}

// v (n channels of one corner) added into grad x at `dst` by global
// reductions: one red.global.add.v4.f32 (v2 where n is 2) per 4 (2)
// channels where all n lie inside Cin (`live`) and `aligned`, else one
// per channel
template <int n>
__device__ __forceinline__ void scatter(float* dst, const float (&v)[n],
                                        int live, bool aligned) {
  if (aligned && live >= n) {
    if constexpr (n % 4 == 0) {
#pragma unroll
      for (int i = 0; i < n; i += 4)
        atomicAdd(reinterpret_cast<float4*>(dst + i),
                  make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
      return;
    } else if constexpr (n % 2 == 0) {
#pragma unroll
      for (int i = 0; i < n; i += 2)
        atomicAdd(reinterpret_cast<float2*>(dst + i),
                  make_float2(v[i], v[i + 1]));
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < n; ++i)
    if (i < live) atomicAdd(dst + i, v[i]);
}

template <typename T>
struct DataArgs {
  const T* x;
  const T* offset;
  const T* mask;
  const T* weight;      // bf16: read by the kernel
  const float* wsplit;  // float32: (2, 9, Cin, KP), hi then lo
  const T* grad_out;
  float* grad_acc;  // float32 grad x (float32), the scratch (bf16)
  T* grad_offset;
  T* grad_mask;
  float* partial;
  int* route_counts;
  int64_t npix;
  int H, W, Cin, Cout, KC, pieces, KP;
  int tiles_x, tiles_y, nsteps, splits, cap;
};

// The data kernel for chunks of CK input channels, NWG warpgroups, each
// with NW = CK / NWG of them (its wgmma N); the warpgroups share the
// tile's shared memory and touch distinct channels of it.
template <typename T, int CK, int NWG>
__global__ void __launch_bounds__(128 * NWG)
    dcn_exact_bwd_data_kernel(const DataArgs<T> a) {
  constexpr bool LOW = is_low<T>();
  constexpr int NT = 128 * NWG;
  constexpr int NW = CK / NWG;
  constexpr int CPT = NW / 4;  // channels per thread and pixel
  constexpr int EK = 16 / (int)sizeof(T);  // elements of a 16-byte piece
  constexpr int KSTEP = LOW ? 16 : 8;      // K of one wgmma: 256 bytes
  constexpr int XP = x_pitch<T>(CK);
  constexpr int PER = (9 * TP + NT - 1) / NT;  // box entries per thread
  constexpr int PARTS = LOW ? 1 : 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout, KC = a.KC;
  const int SBO = KC * (int)sizeof(T) * 8;  // g and weight slot: bytes
                                            // between 8-row groups
  const int g_part = TP * KC * (int)sizeof(T);
  const int w_part = CK * KC * (int)sizeof(T);
  unsigned char* s_g = smem;                         // [part] TP x KC
  unsigned char* s_w = s_g + PARTS * g_part;         // [part] CK x KC
  unsigned char* s_win = s_w + PARTS * w_part;       // cap x XP
  float* s_om = reinterpret_cast<float*>(s_win + a.cap * XP);  // [TP][27]
  float* sums = s_om + TP * 27;  // [3][9][TP]: grad mask, dy, dx
  int* s_box = reinterpret_cast<int*>(sums + 27 * TP);

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int txi = tile % a.tiles_x;
  const int tyi = (tile / a.tiles_x) % a.tiles_y;
  const int b = tile / (a.tiles_x * a.tiles_y);
  const int y0 = tyi * TH;
  const int x0 = txi * TW;
  const int split = blockIdx.z;
  const int s_begin = (int)((int64_t)split * a.nsteps / a.splits);
  const int s_end = (int)((int64_t)(split + 1) * a.nsteps / a.splits);
  const bool x_al = Cin % EK == 0 && hopper::aligned16(a.x);
  const bool g_al = Cout % EK == 0 && hopper::aligned16(a.grad_out);
  const bool w_al = Cout % EK == 0 && hopper::aligned16(a.weight);
  const bool acc_al = Cin % 4 == 0 && hopper::aligned16(a.grad_acc);
  const T* img = a.x + (int64_t)b * H * W * Cin;
  float* acc_img = a.grad_acc + (int64_t)b * H * W * Cin;

  for (int e = tid; e < 27 * TP; e += NT) {
    sums[e] = 0.f;
    // the tile's offsets and mask, once; 0 past the map
    const int p = e / 27;
    const int k = e - 27 * p;
    const int y = y0 + p / TW;
    const int xx = x0 + p % TW;
    float v = 0.f;
    if (y < H && xx < W) {
      const int64_t n = ((int64_t)b * H + y) * W + xx;
      v = k < 18 ? f32(a.offset[n * 18 + k]) : f32(a.mask[n * 9 + k - 18]);
    }
    s_om[e] = v;
  }
  __syncthreads();  // the offsets and mask visible

  // the tile's data box: every needed corner of its pixels' 9 taps
  int rmin = INT_MAX, rmax = INT_MIN, cmin = INT_MAX, cmax = INT_MIN;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = tid + NT * j;
    if (e >= 9 * TP) break;
    const int t = e / TP;
    const int p = e - t * TP;
    const int y = y0 + p / TW;
    const int xx = x0 + p % TW;
    if (y >= H || xx >= W) continue;
    const float* om = s_om + p * 27;
    int iy, ix, needed;
    float hat[4], gy[4], gx[4];
    dcn_exact::grad_corners(y, xx, t, om[2 * t], om[2 * t + 1], om[18 + t],
                            H, W, iy, ix, hat, gy, gx, needed);
    dcn_exact::fold_box(iy, ix, needed, rmin, rmax, cmin, cmax);
  }
  const dcn_exact::Box box =
      dcn_exact::block_box(rmin, rmax, cmin, cmax, s_box);
  const bool window = (int64_t)box.bh * box.bw <= a.cap;
  if (a.route_counts && tid == 0 && split == 0)
    atomicAdd(a.route_counts + (window ? 0 : 1), 1);

  // the box of x of a Cin chunk into the window: pieces of EK channels
  const auto load_window = [&](int chunk) {
    constexpr int NPC = CK / EK;
    const int n = box.bh * box.bw * NPC;
    for (int e = tid; e < n; e += NT) {
      const int pos = e / NPC;
      const int q = e - pos * NPC;
      const int wr = pos / box.bw;
      const int yy = box.r0 + wr;
      const int xc = box.c0 + (pos - wr * box.bw);
      const int ch = chunk * CK + EK * q;
      copy_piece(s_win + pos * XP + 16 * q,
                 img + ((int64_t)yy * W + xc) * Cin + ch, Cin - ch, x_al);
    }
  };
  // piece pc of the tile's output grad: (pixel, EK channels) pieces,
  // K-major; 0 past the map and past Cout
  const auto load_g = [&](int pc) {
    const int QP = KC / EK;
    for (int e = tid; e < TP * QP; e += NT) {
      const int p = e / QP;
      const int q = e - p * QP;
      const int y = y0 + p / TW;
      const int xx = x0 + p % TW;
      const int o = pc * KC + EK * q;
      const bool in = y < H && xx < W;
      const int64_t n = ((int64_t)b * H + y) * W + xx;
      copy_piece(s_g + (p >> 3) * SBO + q * 128 + (p & 7) * 16,
                 in ? a.grad_out + n * Cout + o : a.grad_out,
                 in ? Cout - o : 0, g_al);
    }
  };
  // float32: g -> its TF32 hi part in place and its lo part beside it
  const auto split_g = [&]() {
    if constexpr (!LOW) {
      for (int e = tid; e < TP * KC / 4; e += NT) {
        float4* gp = reinterpret_cast<float4*>(s_g) + e;
        const float4 v = *gp;
        const float4 hi = hopper::tf32_hi(v);
        *gp = hi;
        reinterpret_cast<float4*>(s_g + g_part)[e] = hopper::tf32_lo(v, hi);
      }
    }
  };
  // step s's B = w[t]^T (K = output channel of piece pc, N = channel of
  // the chunk), K-major, input channel c at B column NW (c / NW) +
  // fragment_column(c % NW); float32 hi and lo from the split weight,
  // bf16 from w
  const auto load_weights = [&](int s, int pc) {
    const int chunk = s / 9;
    const int t = s - 9 * chunk;
    const int QP = KC / EK;
    for (int e = tid; e < PARTS * CK * QP; e += NT) {
      const int row = e / QP;  // hl CK + c
      const int q = e - row * QP;
      const int hl = row / CK;
      const int c = row - hl * CK;
      const int ch = chunk * CK + c;
      const bool in = ch < Cin;
      const int n = c / NW * NW + fragment_column<NW>(c % NW);
      unsigned char* dst =
          s_w + hl * w_part + (n >> 3) * SBO + q * 128 + (n & 7) * 16;
      if constexpr (!LOW) {
        hopper::cp_async16(
            dst,
            in ? a.wsplit + (((int64_t)hl * 9 + t) * Cin + ch) * a.KP +
                     pc * KC + 4 * q
               : a.wsplit,
            in ? 16 : 0);
      } else {
        const int o = pc * KC + EK * q;
        copy_piece(dst,
                   in ? a.weight + ((int64_t)t * Cin + ch) * Cout + o
                      : a.weight,
                   in ? Cout - o : 0, w_al);
      }
    }
  };
  DCN_PHASES_BEGIN;  // phase 0: the tile's staging and each step's wait
  if (window) load_window(s_begin / 9);
  if (a.pieces == 1) {
    load_g(0);
    load_weights(s_begin, 0);
  }
  hopper::cp_async_commit();
  hopper::cp_async_wait_all();
  __syncthreads();
  if (a.pieces == 1) split_g();

  const int wg = tid >> 7;          // warpgroup: channels NW wg ..
  const int warp = (tid >> 5) & 3;  // tile row
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
      for (int k = 0; k < 3; ++k) sums[(9 * k + tap) * TP + p] += v[hh][k];
    }
  };
  for (int s = s_begin; s < s_end; ++s) {
    const int chunk = s / 9;
    const int t = s - 9 * chunk;
    const bool chunk_ends = s + 1 == s_end || (s + 1) / 9 != chunk;
    hopper::cp_async_wait_all();
    hopper::fence_async_shared();
    __syncthreads();  // step s's copies (and g's split) visible; step
                      // s - 1's walk done
    DCN_PHASE(0);
    if (pend_t >= 0) {
      add_sums(pend_t, pend);
      pend_t = -1;
    }

    // G_t = g w[t]^T, this warpgroup's NW columns, over the pieces of the
    // output grad; the first K step overwrites G
    for (int pc = 0; pc < a.pieces; ++pc) {
      if (a.pieces > 1) {
        load_g(pc);
        load_weights(s, pc);
        hopper::cp_async_commit();
        hopper::cp_async_wait_all();
        __syncthreads();
        split_g();
        hopper::fence_async_shared();
        __syncthreads();
      }
      hopper::fence_acc(G);
      hopper::wgmma_fence();
      const unsigned char* s_wg = s_w + wg * (NW / 8) * SBO;
      uint64_t dg = hopper::desc(s_g, 128, SBO);
      uint64_t dw = hopper::desc(s_wg, 128, SBO);
      if constexpr (!LOW) {
        uint64_t dg_lo = hopper::desc(s_g + g_part, 128, SBO);
        uint64_t dw_lo = hopper::desc(s_wg + w_part, 128, SBO);
        for (int ks = 0; ks < KC / KSTEP; ++ks) {
          hopper::wgmma_3xtf32<NW>(G, dg, dg_lo, dw, dw_lo, pc > 0 || ks > 0);
          dg += 16;
          dg_lo += 16;
          dw += 16;
          dw_lo += 16;
        }
      } else {
        for (int ks = 0; ks < KC / KSTEP; ++ks) {
          hopper::wgmma_bf16<NW, 0, 0>(G, dg, dw, pc > 0 || ks > 0);
          dg += 16;
          dw += 16;
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_acc(G);
      __syncthreads();  // the product is done: the g and weight slots free
    }
    DCN_PHASE(1);  // phase 1: G on the tensor cores
    if (a.pieces == 1 && !chunk_ends) {
      load_weights(s + 1, 0);  // flies during the walk
      hopper::cp_async_commit();
    }

    // The corner walk. This thread holds G for two pixels (tile row
    // `warp`, columns lane / 4 and lane / 4 + 8) and, per pixel, the CPT
    // channels NW wg + CPT l4 + i: G[4 (i / 2) + 2 hh + i % 2].
    const int cl = NW * wg + CPT * l4;  // its first channel in the chunk
    const int ch0 = chunk * CK + cl;
    float v[2][3];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      v[hh][0] = v[hh][1] = v[hh][2] = 0.f;
      const int p = 16 * warp + (lane >> 2) + 8 * hh;
      const int y = y0 + warp;
      const int xx = x0 + (lane >> 2) + 8 * hh;
      if (y >= H || xx >= W) continue;
      const float* om = s_om + p * 27;
      const float m = om[18 + t];
      int iy, ix, needed;
      float hat[4], gy[4], gx[4];
      dcn_exact::grad_corners(y, xx, t, om[2 * t], om[2 * t + 1], m, H, W,
                              iy, ix, hat, gy, gx, needed);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!(needed >> k & 1)) continue;
        const int yy = iy + (k >> 1);
        const int xc = ix + (k & 1);
        float xv[CPT];
        if (window) {
          const int pos = (yy - box.r0) * box.bw + (xc - box.c0);
          const T* src = reinterpret_cast<const T*>(s_win + pos * XP) + cl;
#pragma unroll
          for (int i = 0; i < CPT; ++i) xv[i] = f32(src[i]);
        } else {
          const T* src = img + ((int64_t)yy * W + xc) * Cin + ch0;
#pragma unroll
          for (int i = 0; i < CPT; ++i)
            xv[i] = ch0 + i < Cin ? f32(src[i]) : 0.f;
        }
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < CPT; ++i)
          d = fmaf(G[4 * (i >> 1) + 2 * hh + (i & 1)], xv[i], d);
        v[hh][0] = fmaf(hat[k], d, v[hh][0]);
        v[hh][1] = fmaf(gy[k], d, v[hh][1]);
        v[hh][2] = fmaf(gx[k], d, v[hh][2]);
        const float wt = __fmul_rn(hat[k], m);
        if (wt == 0.f) continue;
        float add[CPT];
#pragma unroll
        for (int i = 0; i < CPT; ++i)
          add[i] = wt * G[4 * (i >> 1) + 2 * hh + (i & 1)];
        scatter<CPT>(acc_img + ((int64_t)yy * W + xc) * Cin + ch0, add,
                     Cin - ch0, acc_al);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int k = 1; k < 4; k <<= 1)
#pragma unroll
        for (int q = 0; q < 3; ++q)
          v[hh][q] += __shfl_xor_sync(0xffffffffu, v[hh][q], k);
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
    DCN_PHASE(2);  // phase 2: the corner walk and its sums
    if (chunk_ends) {
      __syncthreads();  // the chunk's walks are done: its window is free
      DCN_PHASE(3);  // phase 3: the chunk's barrier
      if (s + 1 < s_end) {
        if (window) load_window(chunk + 1);
        if (a.pieces == 1) load_weights(s + 1, 0);
        hopper::cp_async_commit();
      }
    }
  }
  DCN_PHASE(0);
  DCN_PHASES_END;
  __syncthreads();
  if (pend_t >= 0) add_sums(pend_t, pend);
  __syncthreads();
  for (int e = tid; e < 9 * TP; e += NT) {
    const int t = e / TP;
    const int p = e - t * TP;
    const int y = y0 + p / TW;
    const int xx = x0 + p % TW;
    if (y >= H || xx >= W) continue;
    const int64_t n = ((int64_t)b * H + y) * W + xx;
    const float gm = sums[t * TP + p];
    const float gdy = sums[(9 + t) * TP + p];
    const float gdx = sums[(18 + t) * TP + p];
    if (a.splits > 1) {
      float* dst = a.partial + ((int64_t)split * a.npix + n) * 27 + 3 * t;
      dst[0] = gdy;
      dst[1] = gdx;
      dst[2] = gm;
    } else {
      a.grad_offset[n * 18 + 2 * t] = from_f32<T>(gdy);
      a.grad_offset[n * 18 + 2 * t + 1] = from_f32<T>(gdx);
      a.grad_mask[n * 9 + t] = from_f32<T>(gm);
    }
  }
}

// grad offset and grad mask = the sum over the splits of the partials, in
// split order (bf16: rounded once); one thread per (pixel, tap)
template <typename T>
__global__ void dcn_exact_bwd_data_reduce_kernel(
    const float* __restrict__ partial, T* __restrict__ grad_offset,
    T* __restrict__ grad_mask, int64_t npix, int splits) {
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
  grad_offset[n * 18 + 2 * t] = from_f32<T>(gdy);
  grad_offset[n * 18 + 2 * t + 1] = from_f32<T>(gdx);
  grad_mask[e] = from_f32<T>(gm);
}

// wsplit[hl][t][c][o] = the hi (hl = 0) or lo (1) TF32 part of w[t][c][o],
// o padded to KP with zeros
__global__ void dcn_exact_bwd_split_weight_kernel(
    const float* __restrict__ w, float* __restrict__ wsplit, int64_t rows,
    int Cout, int KP) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * KP) return;
  const int64_t row = e / KP;
  const int o = (int)(e - row * KP);
  const float v = o < Cout ? w[row * Cout + o] : 0.f;
  const float hi = hopper::tf32_rna(v);
  wsplit[e] = hi;
  wsplit[rows * KP + e] = hopper::tf32_rna(v - hi);
}

// dst[e] = bf16(src[e])
__global__ void dcn_exact_round_kernel(const float* __restrict__ src,
                                       bf16* __restrict__ dst,
                                       int64_t count) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < count) dst[e] = __float2bfloat16_rn(src[e]);
}

template <typename T, int CK, int NWG>
int launch_data_kernel(const DataArgs<T>& a, dim3 grid, int smem,
                       cudaStream_t s) {
  static int smem_set = 0;  // the dynamic shared memory allowed so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dcn_exact_bwd_data_kernel<T, CK, NWG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  dcn_exact_bwd_data_kernel<T, CK, NWG><<<grid, 128 * NWG, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The plan's checks, the weight split (float32), the launch, the split
// partials' sum and (bf16) grad x's rounding: see the extern "C"
// launchers below.
template <typename T>
int launch_data(DataArgs<T> a, const float* weight32, T* grad_x, int B,
                int H, int W, int Cin, int Cout, int tile_h, int tile_w,
                int chunk, int warpgroups, int k_tile, int box_capacity,
                int splits, int smem, cudaStream_t s) {
  constexpr bool LOW = is_low<T>();
  const int64_t npix = (int64_t)B * H * W;
  if (B < 0 || H < 0 || W < 0 || Cin < 0 || Cout < 0 || npix > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (npix == 0 || Cin == 0) return (int)cudaSuccess;
  const int ka = LOW ? 16 : 8;  // the K of a G piece is a multiple of it
  const int want_kc = Cout == 0 ? ka
                      : Cout <= MAX_KC ? (Cout + ka - 1) / ka * ka
                                       : MAX_KC;
  const int nsteps = 9 * ((Cin + chunk - 1) / (chunk > 0 ? chunk : 1));
  const bool plan_ok =
      LOW ? (chunk == 64 && warpgroups == 2) || (chunk == 32 && warpgroups == 1)
          : (chunk == 32 && warpgroups == 2) ||
                (chunk == 16 && warpgroups == 2) ||
                (chunk == 8 && warpgroups == 1);
  if (!plan_ok || tile_h != TH || tile_w != TW || k_tile != want_kc ||
      box_capacity < 1 || splits < 1 || splits > nsteps || splits > 65535 ||
      smem != data_smem_bytes<T>(k_tile, chunk, box_capacity) ||
      smem > 232448 || (!LOW && a.wsplit == nullptr) ||
      (splits > 1 && a.partial == nullptr) || a.grad_acc == nullptr)
    return (int)cudaErrorInvalidValue;
  a.npix = npix;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  a.KC = k_tile;
  a.pieces = Cout == 0 ? 1 : (Cout + k_tile - 1) / k_tile;
  a.KP = a.pieces * k_tile;
  a.tiles_x = (W + TW - 1) / TW;
  a.tiles_y = (H + TH - 1) / TH;
  a.nsteps = nsteps;
  a.splits = splits;
  a.cap = box_capacity;
  const int threads = 256;
  cudaError_t err;
  if constexpr (!LOW) {
    const int64_t rows = (int64_t)9 * Cin;
    const int64_t count = rows * a.KP;
    dcn_exact_bwd_split_weight_kernel<<<(unsigned)((count + threads - 1) /
                                                   threads),
                                        threads, 0, s>>>(weight32,
                                                         const_cast<float*>(
                                                             a.wsplit),
                                                         rows, Cout, a.KP);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(B * a.tiles_y * a.tiles_x, 1, splits);
  int rc;
  if constexpr (LOW) {
    rc = chunk == 64 ? launch_data_kernel<T, 64, 2>(a, grid, smem, s)
                     : launch_data_kernel<T, 32, 1>(a, grid, smem, s);
  } else {
    rc = chunk == 32   ? launch_data_kernel<T, 32, 2>(a, grid, smem, s)
         : chunk == 16 ? launch_data_kernel<T, 16, 2>(a, grid, smem, s)
                       : launch_data_kernel<T, 8, 1>(a, grid, smem, s);
  }
  if (rc != 0) return rc;
  if (splits > 1) {
    const int64_t items = npix * 9;
    dcn_exact_bwd_data_reduce_kernel<T>
        <<<(unsigned)((items + threads - 1) / threads), threads, 0, s>>>(
            a.partial, a.grad_offset, a.grad_mask, npix, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if constexpr (LOW) {
    const int64_t count = npix * Cin;
    dcn_exact_round_kernel<<<(unsigned)((count + threads - 1) / threads),
                             threads, 0, s>>>(a.grad_acc, grad_x, count);
    return (int)cudaGetLastError();
  }
  return 0;
}

// ---- the weight kernels -------------------------------------------------

constexpr int WNT = 256;  // threads, two warpgroups
constexpr int WCK = 64;   // input channels per block (wgmma M)
constexpr int WTW = 16;   // tile columns
constexpr int A_LBO = (WCK / 8) * 128;  // bf16 A: bytes between 8-pixel
                                        // groups

// taps per block by N tile (64 nb output channels): its accumulators, nb
// 16 float32 a thread and tap, in registers
__host__ __device__ constexpr int weight_taps(int nb) {
  return nb == 4 ? 1 : 3;
}

// float32 A (64 channels x th 16 pixels, K-major): bytes between
// 8-channel groups, padded by 16 so that the 8 channels a quarter-warp
// stores at once fall in 8 bank groups
__host__ __device__ constexpr int weight_asbo(int th) {
  return th * WTW * 32 + 16;
}

// bytes of a window pixel: 64 channels
template <typename T>
__host__ __device__ constexpr int wpix_bytes() {
  return WCK * (int)sizeof(T);
}

// two A slots and two g slots (float32: hi and lo of each), the window
// slots of `cap` pixels, two corner tables (per tap and pixel the
// top-left corner's position and 4 weights), the box
template <typename T>
__host__ __device__ constexpr int weight_smem_bytes(int nb, int th, int ws,
                                                    int cap) {
  const int tp = th * WTW;
  const int taps = weight_taps(nb);
  return (is_low<T>() ? 2 * tp * WCK * 2 + 2 * tp * 64 * nb * 2
                      : 4 * 8 * weight_asbo(th) + 4 * 64 * nb * tp * 4) +
         ws * cap * wpix_bytes<T>() + 2 * taps * tp * 20 + BOX_B;
}

template <typename T>
struct WeightArgs {
  const T* x;
  const T* offset;
  const T* mask;
  const T* grad_out;    // bf16: read by the kernel
  const float* gsplit;  // float32: the split output grad it reads
  T* grad_w;
  float* partial;
  int* route_counts;
  int H, W, Cin, Cout, th, ws, cap;
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
// channel np col + o (0 past the map and past Cout): each tile's g^T,
// K-major by 4 pixels, in the shared-memory image the weight kernel
// copies as it is. One thread per (tile, col, 4 pixels, channel).
__global__ void dcn_exact_bwd_split_grad_kernel(
    const float* __restrict__ g, float* __restrict__ gsplit, int H, int W,
    int Cout, int th, int tiles_x, int tiles_y, int np, int col_tiles,
    int64_t items) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= items) return;
  const int tp = th * WTW;
  const int o = (int)(e % np);
  int64_t r = e / np;
  const int pq = (int)(r % (tp / 4));
  r /= tp / 4;
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
  float* dst = gsplit + ((int64_t)tile * col_tiles + col) * 2 * np * tp +
               (o >> 3) * (tp * 8) + pq * 32 + (o & 7) * 4;
  *reinterpret_cast<float4*>(dst) = hi;
  *reinterpret_cast<float4*>(dst + np * tp) = hopper::tf32_lo(val, hi);
}

// The weight-gradient kernel for N tiles of 64 NB output channels. Block
// (chunk of 64 input channels, group of TPB taps, N tile, pixel split):
// it walks its split's pixel tiles (th x 16 pixels each) in order; per
// tile it builds each tap's A_t from the tile's box window (or from global
// memory) and adds A_t^T g into that tap's accumulators, half of the N
// tile per warpgroup.
template <typename T, int NB>
__global__ void __launch_bounds__(WNT, 1)
    dcn_exact_bwd_weight_kernel(const WeightArgs<T> a) {
  constexpr bool LOW = is_low<T>();
  constexpr int TPB = weight_taps(NB);  // taps of a block at most
  constexpr int NP = 64 * NB;           // output channels of a block
  constexpr int NH = NP / 2;            // of each warpgroup
  constexpr int TWID = NH < 64 ? NH : 64;  // its wgmma N
  constexpr int NTW = NH / TWID;           // its wgmma N tiles
  constexpr int EK = 16 / (int)sizeof(T);  // channels of a 16-byte piece
  constexpr int NPC = WCK / EK;            // pieces of a window pixel
  constexpr int PIX = wpix_bytes<T>();
  constexpr int G_LBO = NP * 16;  // bf16 g: bytes between 8-pixel groups
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout;
  const int th = a.th;
  const int TPX = th * WTW;  // pixels of a tile: the K of one tile
  const int ASBO = weight_asbo(th);  // float32 A: bytes between 8-channel
                                     // groups
  const int GSBO = TPX * 32;  // float32 g: bytes between 8-channel groups
  const int a_bytes = LOW ? TPX * WCK * 2 : 8 * ASBO;  // one A part
  const int g_bytes = NP * TPX * (int)sizeof(T);       // one g part
  constexpr int PARTS = LOW ? 1 : 2;
  const int win_b = a.cap * PIX;
  const int tab_b = TPB * TPX * 20;
  unsigned char* s_a = smem;                          // [slot][part]
  unsigned char* s_g = s_a + 2 * PARTS * a_bytes;     // [slot][part]
  unsigned char* s_win = s_g + 2 * PARTS * g_bytes;   // 1 or 2 slots
  unsigned char* s_tab = s_win + a.ws * win_b;        // 2 slots
  int* s_box = reinterpret_cast<int*>(s_tab + 2 * tab_b);

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
  const bool x_al = Cin % EK == 0 && hopper::aligned16(a.x);
  const bool g_al = Cout % 8 == 0 && hopper::aligned16(a.grad_out);
  const bool counts = a.route_counts && tid == 0 && c0 == 0 && col == 0;

  // corner table slot: [TPB][TPX] the top-left corner's position (in the
  // box, or in the image on the gather route), [TPB][4][TPX] its weights
  const auto tab_pos = [&](int slot) {
    return reinterpret_cast<int*>(s_tab + slot * tab_b);
  };
  const auto tab_w = [&](int slot) {
    return reinterpret_cast<float*>(s_tab + slot * tab_b + TPB * TPX * 4);
  };
  // a tile's box of x of this block's channels into window slot `slot`:
  // NPC pieces a pixel, piece q at q ^ (pos & 7)
  const auto load_window = [&](int tile, int slot, const dcn_exact::Box& bx_) {
    int b, y0, x0;
    tile_origin(tile, a.tiles_x, a.tiles_y, th, b, y0, x0);
    unsigned char* dst = s_win + slot * win_b;
    const int n = bx_.bh * bx_.bw * NPC;
    for (int e = tid; e < n; e += WNT) {
      const int pos = e / NPC;
      const int q = e - pos * NPC;
      const int wr = pos / bx_.bw;
      const int yy = bx_.r0 + wr;
      const int xc = bx_.c0 + (pos - wr * bx_.bw);
      const int ch = c0 + EK * q;
      copy_piece(dst + pos * PIX + ((q ^ (pos & 7)) << 4),
                 a.x + (((int64_t)b * H + yy) * W + xc) * Cin + ch, Cin - ch,
                 x_al);
    }
  };
  // a tile's output grad into g slot `slot`: float32 its split g^T, hi
  // and lo, one contiguous copy; bf16 MN-major (8 output channels of one
  // pixel per 16 bytes, K = pixel), 0 past the map and past Cout
  const auto load_g = [&](int tile, int slot) {
    unsigned char* dst = s_g + slot * PARTS * g_bytes;
    if constexpr (!LOW) {
      const float* src =
          a.gsplit + ((int64_t)tile * a.col_tiles + col) * 2 * NP * TPX;
      for (int e = tid; e < NP * TPX / 2; e += WNT)
        hopper::cp_async16(dst + 16 * e, src + 4 * e, 16);
    } else {
      int b, y0, x0;
      tile_origin(tile, a.tiles_x, a.tiles_y, th, b, y0, x0);
      for (int e = tid; e < TPX * (NP / 8); e += WNT) {
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
    }
  };
  // This thread's corner-table entry, tap t0 + ej at pixel ep, computed
  // at the start of the tile before (its box first) and written at that
  // tile's end.
  static_assert(TPB * 64 <= WNT, "one corner-table entry per thread");
  const int ej = tid / TPX;
  const int ep = tid - ej * TPX;
  int e_iy = 0, e_ix = 0;
  float e_w[4] = {0.f, 0.f, 0.f, 0.f};
  // the entries of `tile` and its box of live corners; every thread calls
  // it (block_box's barriers)
  const auto entries = [&](int tile) {
    int b, y0, x0;
    tile_origin(tile, a.tiles_x, a.tiles_y, th, b, y0, x0);
    const int y = y0 + ep / WTW;
    const int xx = x0 + ep % WTW;
    int rmin = INT_MAX, rmax = INT_MIN, cmin = INT_MAX, cmax = INT_MIN;
    e_iy = e_ix = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) e_w[k] = 0.f;
    if (ej < ntaps && y < H && xx < W) {
      const int64_t n = ((int64_t)b * H + y) * W + xx;
      const int t = t0 + ej;
      int live;
      dcn_exact::corners(y, xx, t, f32(a.offset[n * 18 + 2 * t]),
                         f32(a.offset[n * 18 + 2 * t + 1]),
                         f32(a.mask[n * 9 + t]), H, W, e_iy, e_ix, e_w, live);
      dcn_exact::fold_box(e_iy, e_ix, live, rmin, rmax, cmin, cmax);
    }
    return dcn_exact::block_box(rmin, rmax, cmin, cmax, s_box);
  };
  const auto write_entries = [&](int slot, const dcn_exact::Box& bx_,
                                 bool window) {
    if (ej >= ntaps) return;
    tab_pos(slot)[ej * TPX + ep] =
        window ? (e_iy - bx_.r0) * bx_.bw + (e_ix - bx_.c0) : e_iy * W + e_ix;
#pragma unroll
    for (int k = 0; k < 4; ++k) tab_w(slot)[(ej * 4 + k) * TPX + ep] = e_w[k];
  };
  // A_t of tap t0 + j into A slot s_ai, from the window `win` (box of width
  // bw and area `area`) or, with win null, from the image at `img`
  const auto build = [&](int j, int tslot, const unsigned char* win, int bw,
                         int area, const T* img, unsigned char* s_ai) {
    const int* tp_ = tab_pos(tslot) + j * TPX;
    const float* tw_ = tab_w(tslot) + j * 4 * TPX;
    const int stride = win ? bw : W;
    if constexpr (!LOW) {
      // an item is 4 pixels 4 pq .. 4 pq + 3 x 4 channels 4 q .. 4 q + 3,
      // each sample summed over its corners as the forward sums it, then
      // transposed to 4 pixels of one channel per 16 bytes and split into
      // TF32 hi and lo
      const int q = tid & 15;
      const int ch = c0 + 4 * q;
      for (int pq = tid >> 4; pq < TPX / 4; pq += WNT / 16) {
        float4 v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = 4 * pq + i;
          const int base = tp_[p];
          v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float wk = tw_[k * TPX + p];
            int pos = base + (k & 1) + (k >> 1) * stride;
            if (win) {
              pos = min(max(pos, 0), area - 1);
              const float4 c = *reinterpret_cast<const float4*>(
                  win + pos * PIX + ((q ^ (pos & 7)) << 4));
              if (wk != 0.f) add4(v[i], c, wk);
            } else if (wk != 0.f && Cin - ch > 0) {
              add4(v[i], load_piece(img + (int64_t)pos * Cin + ch, Cin - ch,
                                    x_al),
                   wk);
            }
          }
        }
        const float4 u[4] = {make_float4(v[0].x, v[1].x, v[2].x, v[3].x),
                             make_float4(v[0].y, v[1].y, v[2].y, v[3].y),
                             make_float4(v[0].z, v[1].z, v[2].z, v[3].z),
                             make_float4(v[0].w, v[1].w, v[2].w, v[3].w)};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int cc = 4 * q + c;
          const int at = (cc >> 3) * ASBO + pq * 128 + (cc & 7) * 16;
          const float4 hi = hopper::tf32_hi(u[c]);
          *reinterpret_cast<float4*>(s_ai + at) = hi;
          *reinterpret_cast<float4*>(s_ai + a_bytes + at) =
              hopper::tf32_lo(u[c], hi);
        }
      }
    } else {
      // 8 channels of one pixel per item, MN-major
      const int p = tid & (TPX - 1);
      const int base = tp_[p];
      int pos[4];
      float wk[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wk[k] = tw_[k * TPX + p];
        pos[k] = base + (k & 1) + (k >> 1) * stride;
        if (win) pos[k] = min(max(pos[k], 0), area - 1);
      }
      for (int q = tid / TPX; q < 8; q += WNT / TPX) {
        const int ch = c0 + 8 * q;
        float s8[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) s8[c] = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (win) {
            const uint4 raw = *reinterpret_cast<const uint4*>(
                win + pos[k] * PIX + ((q ^ (pos[k] & 7)) << 4));
            if (wk[k] != 0.f) add8(s8, raw, wk[k]);
          } else if (wk[k] != 0.f && Cin - ch > 0) {
            add8(s8,
                 load_piece(img + (int64_t)pos[k] * Cin + ch, Cin - ch, x_al),
                 wk[k]);
          }
        }
        uint4 packed;
        bf162* pk = reinterpret_cast<bf162*>(&packed);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          pk[c] = __floats2bfloat162_rn(s8[2 * c], s8[2 * c + 1]);
        *reinterpret_cast<uint4*>(s_ai + (p >> 3) * A_LBO + q * 128 +
                                  (p & 7) * 16) = packed;
      }
    }
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
  // next tile's box is found at the start of this tile and its window
  // flies during this tile (two slots; with one, from the last tap's
  // build on), its g from this tile's first product on.
  DCN_PHASES_BEGIN;  // phase 0 (with the first tile's staging): copy wait
  dcn_exact::Box box{0, 0, 1, 1};
  bool window = true;
  if (tbeg < tend) {
    box = entries(tbeg);
    window = (int64_t)box.bh * box.bw <= a.cap;
    if (counts) atomicAdd(a.route_counts + (window ? 0 : 1), 1);
    write_entries(0, box, window);
    if (window) load_window(tbeg, 0, box);
    load_g(tbeg, 0);
    hopper::cp_async_commit();
  }
  int step = 0;  // products issued: A slot step & 1
  for (int tile = tbeg; tile < tend; ++tile) {
    const int slot = (tile - tbeg) & 1;
    const bool next = tile + 1 < tend;
    const unsigned char* win =
        window ? s_win + (a.ws == 2 ? slot * win_b : 0) : nullptr;
    int b, y0, x0;
    tile_origin(tile, a.tiles_x, a.tiles_y, th, b, y0, x0);
    const T* img = a.x + (int64_t)b * H * W * Cin;
    hopper::cp_async_wait_all();
    DCN_PHASE(0);  // phase 0: the wait for the tile's copies
    hopper::fence_async_shared();
    __syncthreads();  // the tile's window, g and table visible; the last
                      // tile's builds done
    DCN_PHASE(5);     // phase 5: the barrier after it
    dcn_exact::Box nbox{0, 0, 1, 1};
    bool nwindow = true;
    if (next) {
      nbox = entries(tile + 1);
      nwindow = (int64_t)nbox.bh * nbox.bw <= a.cap;
      if (counts) atomicAdd(a.route_counts + (nwindow ? 0 : 1), 1);
      if (a.ws == 2 && nwindow) {
        load_window(tile + 1, slot ^ 1, nbox);
        hopper::cp_async_commit();
      }
    }
    DCN_PHASE(6);  // phase 6: the next tile's corners, box and window copy
#pragma unroll
    for (int j = 0; j < TPB; ++j) {
      if (j >= ntaps) break;
      unsigned char* s_ai = s_a + (step & 1) * PARTS * a_bytes;
      build(j, slot, win, box.bw, box.bh * box.bw, img, s_ai);
      hopper::fence_async_shared();
      __syncthreads();  // A_t visible to both warpgroups
      DCN_PHASE(1);     // phase 1: building A_t
      if (next && nwindow && a.ws == 1 && j == ntaps - 1) {
        load_window(tile + 1, 0, nbox);  // the window's last build is done
        hopper::cp_async_commit();
      }
      hopper::wgmma_fence();
      if constexpr (!LOW) {
        // this warpgroup's NH columns: 3xTF32 per 8 pixels and N tile
        const unsigned char* gs =
            s_g + slot * 2 * g_bytes + wg * (NH / 8) * GSBO;
        for (int ks = 0; ks < TPX / 8; ++ks) {
          const uint64_t a_hi = hopper::desc(s_ai + ks * 256, 128, ASBO);
          const uint64_t a_lo =
              hopper::desc(s_ai + a_bytes + ks * 256, 128, ASBO);
#pragma unroll
          for (int nb = 0; nb < NTW; ++nb) {
            const unsigned char* bt = gs + nb * (TWID / 8) * GSBO + ks * 256;
            hopper::wgmma_3xtf32<TWID>(
                acc[j][nb], a_hi, a_lo, hopper::desc(bt, 128, GSBO),
                hopper::desc(bt + g_bytes, 128, GSBO));
          }
        }
      } else {
        const unsigned char* gs = s_g + slot * g_bytes + wg * (NH / 8) * 128;
        for (int ks = 0; ks < TPX / 16; ++ks) {
          const uint64_t da = hopper::desc(s_ai + 2 * ks * A_LBO, A_LBO, 128);
#pragma unroll
          for (int nb = 0; nb < NTW; ++nb)
            hopper::wgmma_bf16<TWID, 1, 1>(
                acc[j][nb], da,
                hopper::desc(gs + nb * (TWID / 8) * 128 + 2 * ks * G_LBO,
                             G_LBO, 128),
                1);
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
    if (next) {
      write_entries(slot ^ 1, nbox, nwindow);
      box = nbox;
      window = nwindow;
    }
    DCN_PHASE(4);  // phase 4: the next tile's corner table
  }
  hopper::wgmma_wait_all();
#pragma unroll
  for (int j = 0; j < TPB; ++j)
#pragma unroll
    for (int nb = 0; nb < NTW; ++nb) hopper::fence_acc(acc[j][nb]);

  // epilogue from the fragments: rows (input channels) 16 warp + lane / 4
  // (+ 8), columns (output channels) 8 jj + 2 (lane % 4) (+ 1) of each N
  // tile; grad w when the pixels are not split (bf16: rounded), else this
  // split's float32 partial
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
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
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (o + e >= Cout) continue;
            const float v = acc[j][nb][4 * jj + 2 * hh + e];
            if (a.splits > 1)
              a.partial[(int64_t)split * 9 * Cin * Cout + row + o + e] = v;
            else
              a.grad_w[row + o + e] = from_f32<T>(v);
          }
        }
      }
    }
  }
  DCN_PHASE(3);  // phase 3: the flush of the accumulators
  DCN_PHASES_END;
}

// grad_w[e] = the sum over the splits of partial[s, e], in split order
// (bf16: rounded once)
template <typename T>
__global__ void dcn_exact_bwd_weight_reduce_kernel(
    const float* __restrict__ partial, T* __restrict__ grad_w, int64_t count,
    int splits) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[(int64_t)k * count + e];
  grad_w[e] = from_f32<T>(s);
}

template <typename T, int NB>
int launch_weight_kernel(const WeightArgs<T>& a, int chunks, int smem,
                         cudaStream_t s) {
  static int smem_set = 0;  // the dynamic shared memory allowed so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dcn_exact_bwd_weight_kernel<T, NB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const dim3 grid(chunks * a.groups * a.col_tiles, a.splits);
  dcn_exact_bwd_weight_kernel<T, NB><<<grid, WNT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_weight(WeightArgs<T> a, int B, int H, int W, int Cin, int Cout,
                  int tile_h, int tile_w, int chunk, int n_tile, int taps,
                  int window_slots, int box_capacity, int splits, int smem,
                  cudaStream_t s) {
  constexpr bool LOW = is_low<T>();
  const int nb = n_tile / 64;
  const int tiles_x = (W + WTW - 1) / WTW;
  const int tiles_y = tile_h > 0 ? (H + tile_h - 1) / tile_h : 0;
  const int64_t tiles = (int64_t)B * tiles_y * tiles_x;
  if (Cin <= 0 || Cout <= 0 || tiles <= 0 || tiles > 0x7fffffff ||
      tile_w != WTW || (tile_h != 4 && tile_h != 2 && tile_h != 1) ||
      chunk != WCK || (nb != 1 && nb != 2 && nb != 4) || n_tile != 64 * nb ||
      (n_tile < Cout && n_tile != 256) || taps != weight_taps(nb) ||
      (window_slots != 1 && window_slots != 2) || box_capacity < 1 ||
      splits < 1 || splits > tiles || splits > 65535 ||
      smem != weight_smem_bytes<T>(nb, tile_h, window_slots, box_capacity) ||
      smem > 232448 || (!LOW && a.gsplit == nullptr) ||
      (splits > 1 && a.partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const int col_tiles = (Cout + n_tile - 1) / n_tile;
  const int threads = 256;
  if constexpr (!LOW) {
    const int64_t items =
        tiles * col_tiles * (tile_h * WTW / 4) * (int64_t)n_tile;
    dcn_exact_bwd_split_grad_kernel<<<(unsigned)((items + threads - 1) /
                                                 threads),
                                      threads, 0, s>>>(
        a.grad_out, const_cast<float*>(a.gsplit), H, W, Cout, tile_h,
        tiles_x, tiles_y, n_tile, col_tiles, items);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  a.th = tile_h;
  a.ws = window_slots;
  a.cap = box_capacity;
  a.tiles_x = tiles_x;
  a.tiles_y = tiles_y;
  a.tiles = (int)tiles;
  a.groups = (9 + taps - 1) / taps;
  a.col_tiles = col_tiles;
  a.splits = splits;
  const int chunks = (Cin + WCK - 1) / WCK;
  int err = nb == 1   ? launch_weight_kernel<T, 1>(a, chunks, smem, s)
            : nb == 2 ? launch_weight_kernel<T, 2>(a, chunks, smem, s)
                      : launch_weight_kernel<T, 4>(a, chunks, smem, s);
  if (err != 0 || splits == 1) return err;
  const int64_t count = (int64_t)9 * Cin * Cout;
  dcn_exact_bwd_weight_reduce_kernel<T>
      <<<(unsigned)((count + threads - 1) / threads), threads, 0, s>>>(
          a.partial, a.grad_w, count, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// Every launcher runs on `stream`, allocates nothing, reads nothing back,
// does not synchronise (a CUDA graph captures it) and returns
// cudaGetLastError() as an int (0 = ok). The plan comes in as ints, each
// checked against this file's constants and the shapes; a mismatch
// returns cudaErrorInvalidValue before any launch. `route_counts` (2 ints:
// window tiles, gather tiles, added to) may be null. Any offset.

// The data gradient at float32 (ops/dcn.exact_bwd_data_fp32_plan):
// tile_h, tile_w, chunk (32, 16 or 8), warpgroups (2, 2 or 1), k_tile (the
// output channels of a G piece: Cout padded to 8 up to 256, else 256),
// box_capacity, splits and the dynamic shared memory. grad_x must be
// zero-filled by the caller (the blocks add into it with atomics);
// `wsplit` holds 2 * 9 * Cin * KP floats of scratch (KP = Cout rounded up
// to k_tile); `partial` holds splits * B * H * W * 27 floats when splits >
// 1 and may be null otherwise; grad_offset (B, H, W, 18) and grad_mask
// (B, H, W, 9) are fully written.
extern "C" int dcn_exact_bwd_data(const float* x, const float* offset,
                                  const float* mask, const float* weight,
                                  const float* grad_out, float* grad_x,
                                  float* grad_offset, float* grad_mask,
                                  float* partial, float* wsplit,
                                  int* route_counts, int B, int H, int W,
                                  int Cin, int Cout, int tile_h, int tile_w,
                                  int chunk, int warpgroups, int k_tile,
                                  int box_capacity, int splits, int smem,
                                  void* stream) {
  DataArgs<float> a{};
  a.x = x;
  a.offset = offset;
  a.mask = mask;
  a.weight = weight;
  a.wsplit = wsplit;
  a.grad_out = grad_out;
  a.grad_acc = grad_x;
  a.grad_offset = grad_offset;
  a.grad_mask = grad_mask;
  a.partial = partial;
  a.route_counts = route_counts;
  return launch_data(a, weight, grad_x, B, H, W, Cin, Cout, tile_h, tile_w,
                     chunk, warpgroups, k_tile, box_capacity, splits, smem,
                     (cudaStream_t)stream);
}

// The same at bfloat16 (ops/dcn.exact_bwd_data_bf16_plan: chunk 64 and two
// warpgroups or 32 and one, k_tile Cout padded to 16 up to 256): grad x
// is summed in
// `grad_acc` (B * H * W * Cin floats, zero-filled by the caller) and
// rounded once into grad_x; no weight split.
extern "C" int dcn_exact_bwd_data_bf16(
    const bf16* x, const bf16* offset, const bf16* mask, const bf16* weight,
    const bf16* grad_out, float* grad_acc, bf16* grad_x, bf16* grad_offset,
    bf16* grad_mask, float* partial, int* route_counts, int B, int H, int W,
    int Cin, int Cout, int tile_h, int tile_w, int chunk, int warpgroups,
    int k_tile, int box_capacity, int splits, int smem, void* stream) {
  DataArgs<bf16> a{};
  a.x = x;
  a.offset = offset;
  a.mask = mask;
  a.weight = weight;
  a.grad_out = grad_out;
  a.grad_acc = grad_acc;
  a.grad_offset = grad_offset;
  a.grad_mask = grad_mask;
  a.partial = partial;
  a.route_counts = route_counts;
  return launch_data(a, nullptr, grad_x, B, H, W, Cin, Cout, tile_h, tile_w,
                     chunk, warpgroups, k_tile, box_capacity, splits, smem,
                     (cudaStream_t)stream);
}

// The weight gradient at float32 (ops/dcn.exact_bwd_weight_fp32_plan):
// tile_h (4, 2 or 1), tile_w, chunk, n_tile (64, 128 or 256), taps (per
// block), window_slots (1 or 2), box_capacity, splits (of the pixel tiles)
// and the dynamic shared memory. grad_w (3, 3, Cin, Cout) is fully written;
// `gsplit` holds tiles * col_tiles * 2 * n_tile * tile_h * tile_w floats of
// scratch; `partial` holds splits * 9 * Cin * Cout floats when splits > 1
// and may be null otherwise.
extern "C" int dcn_exact_bwd_weight(
    const float* x, const float* offset, const float* mask,
    const float* grad_out, float* grad_w, float* partial, float* gsplit,
    int* route_counts, int B, int H, int W, int Cin, int Cout, int tile_h,
    int tile_w, int chunk, int n_tile, int taps, int window_slots,
    int box_capacity, int splits, int smem, void* stream) {
  WeightArgs<float> a{};
  a.x = x;
  a.offset = offset;
  a.mask = mask;
  a.grad_out = grad_out;
  a.gsplit = gsplit;
  a.grad_w = grad_w;
  a.partial = partial;
  a.route_counts = route_counts;
  return launch_weight(a, B, H, W, Cin, Cout, tile_h, tile_w, chunk, n_tile,
                       taps, window_slots, box_capacity, splits, smem,
                       (cudaStream_t)stream);
}

// The same at bfloat16 (ops/dcn.exact_bwd_weight_bf16_plan): no split
// output grad; grad_w bf16, rounded once.
extern "C" int dcn_exact_bwd_weight_bf16(
    const bf16* x, const bf16* offset, const bf16* mask,
    const bf16* grad_out, bf16* grad_w, float* partial, int* route_counts,
    int B, int H, int W, int Cin, int Cout, int tile_h, int tile_w,
    int chunk, int n_tile, int taps, int window_slots, int box_capacity,
    int splits, int smem, void* stream) {
  WeightArgs<bf16> a{};
  a.x = x;
  a.offset = offset;
  a.mask = mask;
  a.grad_out = grad_out;
  a.grad_w = grad_w;
  a.partial = partial;
  a.route_counts = route_counts;
  return launch_weight(a, B, H, W, Cin, Cout, tile_h, tile_w, chunk, n_tile,
                       taps, window_slots, box_capacity, splits, smem,
                       (cudaStream_t)stream);
}
