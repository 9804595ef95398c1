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
//       kernel about twice as slow (PERF.md). Summing grad x over the
//       tile's box on the tensor cores instead (S_t^T G_t in 3xTF32,
//       flushed once a chunk) cut the reductions 8x and made it slower at
//       both dtypes (PERF.md): no thread waits for a reduction, and they
//       take 6-13% (float32) and 11-29% (bf16) of a block's cycles, the
//       walk's reads and sums 40-59%.
//   grad offset and grad mask are summed over a thread's channels, then its
//   quad by shuffles, then its warpgroups and the chunks in a fixed order,
//   so they are the same bit for bit on every launch; grad x sums in an
//   order that changes from run to run (rounding-level differences only).
//   Small maps split the K loop over blocks by waves: grad offset and grad
//   mask go to float32 partials per split that a second kernel sums in
//   split order.
//
//   dcn_exact_bwd_weight[_bf16]: grad w[t] = sum_p A_t(p)^T g(p),
//   computed transposed: D_t[o, c] = sum_p g(p, o) A_t(p, c), with M = 64
//   output channels (an M tile), N = a chunk of 64 input channels, K =
//   pixels, so every product is m64n64 whatever Cout. A block takes a
//   chunk, a group of taps (5 at Cout 64, 3 at 128, 1 at 256: what its
//   consumers' registers hold), up to 256 output channels (128 at
//   float32) and walks its split's pixel tiles (th x 16, th 4 at bf16, 2
//   at float32) in order, warp-specialised on mbarriers (WRoles):
//     - one producer warpgroup stages: per tile its corners (dcn_exact.cuh
//       `corners`, as the forward computes them, from offsets and mask
//       loaded a tile ahead) and their box of live corners, whose x (64
//       channels a pixel) comes by cp.async into a window slot where it
//       fits the plan's capacity, and its output grad by cp.async, each
//       completing on an mbarrier (bulk copies, a row each, were slower:
//       PERF.md); two slots of each, so it stages a tile ahead;
//     - the other producer warpgroups (two at Cout 64, else one) build:
//       stage by stage in turn, each tap's sample A_t from the window (or
//       from global memory) as the forward builds it, term by term
//       without fused multiply-adds (at bf16 the bf16 sample the forward
//       contracted), two items' corner reads before either's sums, into
//       the next free stage of a ring;
//     - consumer warpgroups (one at Cout 64, else two, each with its M
//       tiles) only issue wgmma: per tile they load g^T of their M tiles
//       from shared memory into registers once (float32: split into TF32
//       hi and lo as it is loaded) and take it as wgmma's register A for
//       every tap of the block; B is the stage's sample (float32: K-major
//       hi and lo, 3xTF32; bf16: MN-major, trans-b). A stage is freed
//       when its product is done.
//   setmaxnreg gives the consumers their accumulators and g^T's fragment
//   (232 registers for one, 160 for two), the producers the rest (88,
//   96). No barrier of the whole block is left in the tile loop (the
//   stager's box reduction has one of its own). The pixel tiles are split
//   over blocks by waves (a block's flush counted as steps); the splits'
//   float32 partials are summed in split order by a second kernel (at
//   bf16 rounded once), so grad w is bit-identical on every launch.
//
// A launch given `route_counts` (two ints) adds each tile's route to them:
// window tiles, gather tiles (the weight kernels: each tile and tap group
// once). ops/dcn.exact_bwd_tile_routes and exact_tile_routes are the two
// rules in PyTorch. A data launch given `reductions` (one 64-bit int) adds
// to it the float32 values its blocks added into grad x (or the scratch)
// by global reductions: it runs the kernel's COUNT instance, in which each
// thread counts them as it sends them and each warp adds its sum once at
// the end; a launch without runs the instance that does not count.
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
  unsigned long long* reductions;
  int64_t npix;
  int H, W, Cin, Cout, KC, pieces, KP;
  int tiles_x, tiles_y, nsteps, splits, cap;
};

// The data kernel for chunks of CK input channels, NWG warpgroups, each
// with NW = CK / NWG of them (its wgmma N); the warpgroups share the
// tile's shared memory and touch distinct channels of it. COUNT: add the
// reductions into grad x to a.reductions.
template <typename T, int CK, int NWG, bool COUNT>
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
  int reduced = 0;  // floats this thread added into grad x
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
    DCN_PHASE(1);  // consumer 1: G on the tensor cores
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
        DCN_PHASE(2);
        scatter<CPT>(acc_img + ((int64_t)yy * W + xc) * Cin + ch0, add,
                     Cin - ch0, acc_al);
        DCN_PHASE(4);  // consumer 4: grad x's global reductions
        if constexpr (COUNT) reduced += min(max(Cin - ch0, 0), CPT);
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
    DCN_PHASE(2);  // consumer 2: the corner walk's reads and its sums
    if (chunk_ends) {
      __syncthreads();  // the chunk's walks are done: its window is free
      DCN_PHASE(3);  // consumer 3: the chunk's barrier
      if (s + 1 < s_end) {
        if (window) load_window(chunk + 1);
        if (a.pieces == 1) load_weights(s + 1, 0);
        hopper::cp_async_commit();
      }
    }
  }
  DCN_PHASE(0);
  DCN_PHASES_END;
  if constexpr (COUNT) {
#pragma unroll
    for (int k = 16; k > 0; k >>= 1)
      reduced += __shfl_xor_sync(0xffffffffu, reduced, k);
    if (lane == 0 && reduced)
      atomicAdd(a.reductions, (unsigned long long)reduced);
  }
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

template <typename T, int CK, int NWG, bool COUNT>
int launch_data_instance(const DataArgs<T>& a, dim3 grid, int smem,
                         cudaStream_t s) {
  static int smem_set = 0;  // the dynamic shared memory allowed so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dcn_exact_bwd_data_kernel<T, CK, NWG, COUNT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  dcn_exact_bwd_data_kernel<T, CK, NWG, COUNT>
      <<<grid, 128 * NWG, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int CK, int NWG>
int launch_data_kernel(const DataArgs<T>& a, dim3 grid, int smem,
                       cudaStream_t s) {
  if (a.reductions)
    return launch_data_instance<T, CK, NWG, true>(a, grid, smem, s);
  return launch_data_instance<T, CK, NWG, false>(a, grid, smem, s);
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

constexpr int WCK = 64;  // input channels per block (the wgmma N)
constexpr int WTW = 16;  // tile columns
constexpr int WMAX_STAGES = 8;  // the barriers' room for stages
constexpr int WKS = 4;     // k steps of a tile at most (th 4 bf16, th 2
                           // float32): the consumers' g fragment
constexpr int WENT = 20;   // bytes of a corner-table entry
constexpr int A_LBO = (WCK / 8) * 128;  // bf16 sample: bytes between
                                        // 8-pixel groups
// the stages of the sample ring: float32 3 (hi and lo, 4 KB each a tap
// at th 2), bf16 6
template <typename T>
__host__ __device__ constexpr int weight_stages() {
  return is_low<T>() ? 6 : 3;
}
static_assert(weight_stages<float>() <= WMAX_STAGES &&
                  weight_stages<bf16>() <= WMAX_STAGES,
              "the barriers hold WMAX_STAGES stages");
// the barriers (full and empty per stage; g full, g empty, window full
// and built per slot), the stager warps' box partials and each slot's box
// and route
constexpr int WBAR_B = (2 * WMAX_STAGES + 8) * 8 + 2 * 4 * 16 + 2 * 32;

// The roles by the block's output channels (np, M tiles of 64): NPROD
// producer warpgroups, one staging the tiles and NPROD - 1 building the
// samples (stage by stage in turn); NCONS consumer warpgroups hold MPW M
// tiles each and accumulators for TPW taps (MPW * TPW * 32 float32 a
// thread) beside g^T's fragment. np 64: three producers (two building),
// one consumer (5 taps); np 128: two and two, an M tile each (3 taps);
// np 256: two and two, two M tiles each (1 tap). setmaxnreg: one consumer 232 and
// the producers 88 (128 x 232 + 384 x 88), two consumers 160 and the
// producers 96 (256 x 160 + 256 x 96), within the 512 x 128 registers
// of the launch.
template <int NP_>
struct WRoles;
template <>
struct WRoles<64> {
  static constexpr int NPROD = 3, NCONS = 1, MPW = 1, TPW = 5;
  static constexpr int PREGS = 88, CREGS = 232;
};
template <>
struct WRoles<128> {
  static constexpr int NPROD = 2, NCONS = 2, MPW = 1, TPW = 3;
  static constexpr int PREGS = 96, CREGS = 160;
};
template <>
struct WRoles<256> {
  static constexpr int NPROD = 2, NCONS = 2, MPW = 2, TPW = 1;
  static constexpr int PREGS = 96, CREGS = 160;
};

// float32 sample (64 channels x th 16 pixels, K-major): bytes between
// 8-channel groups, padded by 16 so that the 8 channels a quarter-warp
// stores at once fall in 8 bank groups
__host__ __device__ constexpr int weight_asbo(int th) {
  return th * WTW * 32 + 16;
}

// one stage of the ring: a tap's sample (float32: hi and lo)
template <typename T>
__host__ __device__ constexpr int weight_stage_bytes(int th) {
  return is_low<T>() ? th * WTW * WCK * 2 : 2 * 8 * weight_asbo(th);
}

// bytes of a g row (np output channels of one pixel), padded so that the
// rows a consumer warp reads at once fall in distinct bank groups
template <typename T>
__host__ __device__ constexpr int weight_gpitch(int np) {
  return np * (int)sizeof(T) + (is_low<T>() ? 16 : 32);
}

// the barriers, the sample stages, two g slots, two corner tables (per
// tap and pixel the top-left corner and 4 weights), the window slots of
// `cap` pixels (64 channels each)
template <typename T>
__host__ __device__ constexpr int weight_smem_bytes(int np, int th, int taps,
                                                    int ws, int cap) {
  const int tp = th * WTW;
  return WBAR_B + weight_stages<T>() * weight_stage_bytes<T>(th) +
         2 * tp * weight_gpitch<T>(np) + 2 * taps * tp * WENT +
         ws * cap * WCK * (int)sizeof(T);
}

template <typename T>
struct WeightArgs {
  const T* x;
  const T* offset;
  const T* mask;
  const T* grad_out;
  T* grad_w;
  float* partial;
  int* route_counts;
  int H, W, Cin, Cout, th, taps, ws, cap;
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

// The weight-gradient kernel for blocks of NP_ output channels. Block
// (chunk of 64 input channels, group of taps, NP_ output channels, pixel
// split), warpgroups in two roles (WRoles):
//   - the producers (the last NPROD warpgroups) walk the split's pixel
//     tiles in order. Per tile they find the next tile's corners and
//     their box of live corners (two barriers of their own), copy the
//     next tile's window (where the box fits the capacity) and output
//     grad by cp.async, each completing on an mbarrier, then build each
//     tap's sample from the window (or from global memory) into the next
//     free stage of the ring and mark it full;
//   - the consumers (the first NCONS warpgroups) only issue wgmma: per
//     tile they take g^T of their M tiles (64 output channels, the M)
//     from the g slot into registers (float32: split into TF32 hi and
//     lo), free the slot, and per full stage add g^T A_t into that tap's
//     accumulators (K the tile's pixels, N the 64 channels), freeing the
//     stage once the product is done.
// At the end the consumers write their accumulators: grad w, or the
// split's float32 partial.
template <typename T, int NP_>
__global__ void __launch_bounds__(
    128 * (WRoles<NP_>::NPROD + WRoles<NP_>::NCONS), 1)
    dcn_exact_bwd_weight_kernel(const WeightArgs<T> a) {
  using R = WRoles<NP_>;
  constexpr bool LOW = is_low<T>();
  constexpr int MPW = R::MPW;
  constexpr int TPW = R::TPW;
  constexpr int NC = 128 * R::NCONS;  // consumer threads
  constexpr int EK = 16 / (int)sizeof(T);  // channels of a 16-byte piece
  constexpr int NPC = WCK / EK;            // pieces of a window pixel
  constexpr int PIX = WCK * (int)sizeof(T);
  constexpr int NB = R::NPROD - 1;  // sampler warpgroups
  constexpr int EPT = (9 * 64 + 127) / 128;  // table entries a stager
                                             // thread fills at most
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout;
  const int TPX = a.th * WTW;  // pixels of a tile: the K of a product
  constexpr int S = weight_stages<T>();
  const int stage_b = weight_stage_bytes<T>(a.th);
  const int gpitch = weight_gpitch<T>(NP_);
  const int g_b = TPX * gpitch;
  const int tab_b = a.taps * TPX * WENT;
  const int win_b = a.cap * PIX;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + WMAX_STAGES;
  uint64_t* g_full = empty + WMAX_STAGES;  // [2]
  uint64_t* g_empty = g_full + 2;          // [2]
  uint64_t* win_full = g_empty + 2;        // [2]
  uint64_t* built = win_full + 2;          // [2]
  int4* s_boxp = reinterpret_cast<int4*>(built + 2);  // [2][4]
  int4* s_info = s_boxp + 2 * 4;  // [2][2]: the box, the route
  unsigned char* s_stage = smem + WBAR_B;
  unsigned char* s_g = s_stage + S * stage_b;
  unsigned char* s_tab = s_g + 2 * g_b;
  unsigned char* s_win = s_tab + 2 * tab_b;

  const int tid = threadIdx.x;
  int bx = blockIdx.x;
  const int col = bx % a.col_tiles;
  bx /= a.col_tiles;
  const int group = bx % a.groups;
  const int c0 = (bx / a.groups) * WCK;
  const int n0 = col * NP_;
  const int t0 = group * a.taps;
  const int ntaps = min(a.taps, 9 - t0);
  const int split = blockIdx.y;
  const int tbeg = (int)((int64_t)split * a.tiles / a.splits);
  const int ntiles = (int)((int64_t)(split + 1) * a.tiles / a.splits) - tbeg;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(full + s, 128);
      hopper::mbar_init(empty + s, NC);
    }
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(g_full + i, 128);
      hopper::mbar_init(g_empty + i, NC);
      hopper::mbar_init(win_full + i, 128);
      hopper::mbar_init(built + i, 128 * NB);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();  // the barriers initialised; the roles never meet again

  if (tid >= NC) {
    // ---- the producers ---------------------------------------------------
    hopper::setmaxnreg_dec<R::PREGS>();
    const int pt = tid - NC;
    // producer warpgroup 0 stages the tiles (its threads pt 0..127), the
    // others build: sampler warpgroup bwg fills stages n with n % NB ==
    // bwg, by its 128 threads bt
    const int pwg = pt >> 7;
    const int bwg = pwg - 1;
    const int bt = pt & 127;
    const bool x_al = Cin % EK == 0 && hopper::aligned16(a.x);
    const bool g_al = Cout % EK == 0 && hopper::aligned16(a.grad_out);
    const bool counts = a.route_counts && pt == 0 && c0 == 0 && col == 0;
    DCN_PHASES_BEGIN;
    // table slot: [taps][TPX] the top-left corner (row, column as two
    // int16), [taps][4][TPX] its weights
    const auto tab_pos = [&](int slot) {
      return reinterpret_cast<int*>(s_tab + slot * tab_b);
    };
    const auto tab_w = [&](int slot) {
      return reinterpret_cast<float*>(s_tab + slot * tab_b +
                                      a.taps * TPX * 4);
    };
    // this stager thread's entries (tap j, pixel p) = e / TPX, e % TPX for
    // e = pt + 128 i: their offsets and mask (in their own type, so that
    // no conversion waits for the loads)
    T ev[EPT][3];
    const auto load_entries = [&](int tile) {
      int b, y0, x0;
      tile_origin(tile, a.tiles_x, a.tiles_y, a.th, b, y0, x0);
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        const int e = pt + 128 * i;
        const int j = e / TPX;
        const int p = e - j * TPX;
        const int y = y0 + p / WTW;
        const int xx = x0 + p % WTW;
        ev[i][0] = ev[i][1] = ev[i][2] = from_f32<T>(0.f);
        if (j < ntaps && y < H && xx < W) {
          const int64_t n = ((int64_t)b * H + y) * W + xx;
          const int t = t0 + j;
          ev[i][0] = a.offset[n * 18 + 2 * t];
          ev[i][1] = a.offset[n * 18 + 2 * t + 1];
          ev[i][2] = a.mask[n * 9 + t];
        }
      }
    };
    // the entries of `tile` into table slot `slot` and the box of their
    // live corners (dcn_exact.cuh corners, the forward's arithmetic), by
    // the stager warps with a barrier of their own
    const auto finish_entries = [&](int tile, int slot) {
      int b, y0, x0;
      tile_origin(tile, a.tiles_x, a.tiles_y, a.th, b, y0, x0);
      int rmin = INT_MAX, rmax = INT_MIN, cmin = INT_MAX, cmax = INT_MIN;
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        const int e = pt + 128 * i;
        const int j = e / TPX;
        const int p = e - j * TPX;
        if (j >= ntaps) continue;
        const int y = y0 + p / WTW;
        const int xx = x0 + p % WTW;
        int iy = 0, ix = 0, live = 0;
        float w4[4] = {0.f, 0.f, 0.f, 0.f};
        if (y < H && xx < W) {
          dcn_exact::corners(y, xx, t0 + j, f32(ev[i][0]), f32(ev[i][1]),
                             f32(ev[i][2]), H, W, iy, ix, w4, live);
          dcn_exact::fold_box(iy, ix, live, rmin, rmax, cmin, cmax);
        }
        tab_pos(slot)[j * TPX + p] =
            (int)(((uint32_t)iy & 0xffffu) | ((uint32_t)ix << 16));
#pragma unroll
        for (int k = 0; k < 4; ++k) tab_w(slot)[(j * 4 + k) * TPX + p] = w4[k];
      }
      rmin = __reduce_min_sync(0xffffffffu, rmin);
      rmax = __reduce_max_sync(0xffffffffu, rmax);
      cmin = __reduce_min_sync(0xffffffffu, cmin);
      cmax = __reduce_max_sync(0xffffffffu, cmax);
      int4* bp = s_boxp + 4 * slot;
      if ((pt & 31) == 0) bp[pt >> 5] = make_int4(rmin, rmax, cmin, cmax);
      hopper::bar_sync(1, 128);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int4 v = bp[w];
        rmin = min(rmin, v.x);
        rmax = max(rmax, v.y);
        cmin = min(cmin, v.z);
        cmax = max(cmax, v.w);
      }
      return rmin <= rmax ? dcn_exact::Box{rmin, cmin, rmax - rmin + 1,
                                           cmax - cmin + 1}
                          : dcn_exact::Box{0, 0, 1, 1};
    };
    // the copies this thread issued so far complete `bar`'s phase
    const auto arrive_copies = [&](uint64_t* bar) {
      hopper::mbar_arrive_cp_async(bar);
      hopper::mbar_arrive(bar);
    };
    // A tile's box of x of this block's channels into window slot
    // `wslot` (where `copy`; the arrival always), NPC pieces a pixel by
    // cp.async, row by row: bf16 piece q at q ^ (pos & 7), so that the
    // build's lanes (32 pixels) read 8 bank groups; float32 unswizzled
    // (its lanes read one pixel's 256 contiguous bytes).
    const auto load_window = [&](int tile, int wslot,
                                 const dcn_exact::Box& bx_, bool copy,
                                 uint64_t* bar) {
      int b, y0, x0;
      tile_origin(tile, a.tiles_x, a.tiles_y, a.th, b, y0, x0);
      unsigned char* dst = s_win + wslot * win_b;
      const int n = bx_.bw * NPC;  // pieces a box row
      for (int wr = 0; copy && wr < bx_.bh; ++wr) {
        const T* row = a.x + (((int64_t)b * H + bx_.r0 + wr) * W + bx_.c0) *
                                 Cin + c0;
        for (int e = pt; e < n; e += 128) {
          const int wc = e / NPC;  // NPC a power of two
          const int q = e % NPC;
          const int pos = wr * bx_.bw + wc;
          copy_piece(dst + pos * PIX + ((LOW ? q ^ (pos & 7) : q) << 4),
                     row + (int64_t)wc * Cin + EK * q, Cin - c0 - EK * q,
                     x_al);
        }
      }
      arrive_copies(bar);
    };
    // a tile's output grad (NP_ channels from n0 of each pixel, a row of
    // gpitch bytes) into g slot `gslot`, 0 past the map and past Cout
    const auto load_g = [&](int tile, int gslot, uint64_t* bar) {
      int b, y0, x0;
      tile_origin(tile, a.tiles_x, a.tiles_y, a.th, b, y0, x0);
      unsigned char* dst = s_g + gslot * g_b;
      constexpr int PPR = NP_ / EK;  // pieces a row, a power of two
      for (int e = pt; e < TPX * PPR; e += 128) {
        const int p = e / PPR;
        const int q = e % PPR;
        const int y = y0 + p / WTW;
        const int xx = x0 + p % WTW;
        const int o = n0 + EK * q;
        const bool in = y < H && xx < W;
        copy_piece(dst + p * gpitch + q * 16,
                   in ? a.grad_out + (((int64_t)b * H + y) * W + xx) * Cout +
                            o
                      : a.grad_out,
                   in ? Cout - o : 0, g_al);
      }
      arrive_copies(bar);
    };
    // tap j's sample of the tile into stage `st`, from the window `win`
    // (box bx_) or, with win null, from the image at `img`: summed over
    // its corners as the forward sums it, term by term
    const auto build = [&](int j, int tslot, const unsigned char* win,
                           const dcn_exact::Box& bx_, const T* img,
                           unsigned char* st) {
      const int* tp_ = tab_pos(tslot) + j * TPX;
      const float* tw_ = tab_w(tslot) + j * 4 * TPX;
      const int stride = win ? bx_.bw : W;
      const int area = bx_.bh * bx_.bw;
      const auto base_of = [&](int p) {
        const int v = tp_[p];
        const int iy = (int)(int16_t)(v & 0xffff);
        const int ix = v >> 16;
        return win ? (iy - bx_.r0) * bx_.bw + (ix - bx_.c0) : iy * W + ix;
      };
      if constexpr (!LOW) {
        // an item is 2 pixels 2 pp, 2 pp + 1 x 2 channels 2 q2, 2 q2 + 1
        // (a warp: one pixel pair, all 64 channels), stored as 2 pixels
        // of one channel per 8 bytes (K-major: 4 pixels a 16-byte row)
        // and split into TF32 hi and lo
        const int asbo = weight_asbo(a.th);
        // channels 2 q2, 2 q2 + 1 of pixels 2 pp, 2 pp + 1
        const auto store = [&](int pp, int q2, float2 v0, float2 v1) {
          const float2 u[2] = {make_float2(v0.x, v1.x),
                               make_float2(v0.y, v1.y)};
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int cc = 2 * q2 + c;
            const int at = (cc >> 3) * asbo + (pp >> 1) * 128 +
                           (cc & 7) * 16 + (pp & 1) * 8;
            const float2 hi = make_float2(hopper::tf32_rna(u[c].x),
                                          hopper::tf32_rna(u[c].y));
            *reinterpret_cast<float2*>(st + at) = hi;
            *reinterpret_cast<float2*>(st + 8 * asbo + at) = make_float2(
                hopper::tf32_rna(u[c].x - hi.x),
                hopper::tf32_rna(u[c].y - hi.y));
          }
        };
        if (win) {
          // two items (pixel pairs pp and pp + 4) at once: their 16
          // corner reads issued before any sum, for the latency
          const int q2 = bt & 31;
          for (int pp0 = bt >> 5; pp0 < TPX / 2; pp0 += 8) {
            float2 c[2][2][4];
            float w[2][2][4];
#pragma unroll
            for (int it = 0; it < 2; ++it)
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const int p = 2 * (pp0 + 4 * it) + i;
                const int base = base_of(p);
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                  w[it][i][k] = tw_[k * TPX + p];
                  const int pos = min(
                      max(base + (k & 1) + (k >> 1) * stride, 0), area - 1);
                  c[it][i][k] = *reinterpret_cast<const float2*>(
                      win + pos * PIX + 8 * q2);
                }
              }
#pragma unroll
            for (int it = 0; it < 2; ++it) {
              float2 v[2];
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                v[i] = make_float2(0.f, 0.f);
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                  if (w[it][i][k] != 0.f) {
                    v[i].x = __fadd_rn(v[i].x,
                                       __fmul_rn(c[it][i][k].x, w[it][i][k]));
                    v[i].y = __fadd_rn(v[i].y,
                                       __fmul_rn(c[it][i][k].y, w[it][i][k]));
                  }
                }
              }
              store(pp0 + 4 * it, q2, v[0], v[1]);
            }
          }
          return;
        }
        // from the image: a half-warp a pixel, 4 channels (16 bytes) a
        // lane, two items' 8 corner reads before either's sums; the
        // halves then trade 2 channels so that each lane stores 2
        // channels of both pixels
        const int h = (bt >> 4) & 1;
        const int q4 = bt & 15;
        const int ch = c0 + 4 * q4;
        const int left = Cin - ch;  // channels of this lane's piece
        for (int pp0 = bt >> 5; pp0 < TPX / 2; pp0 += 8) {
          float4 c[2][4];
          float w[2][4];
#pragma unroll
          for (int it = 0; it < 2; ++it) {
            const int p = 2 * (pp0 + 4 * it) + h;
            const int base = base_of(p);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              w[it][k] = tw_[k * TPX + p];
              c[it][k] = make_float4(0.f, 0.f, 0.f, 0.f);
              if (w[it][k] == 0.f || left <= 0) continue;
              const float* src =
                  img + (int64_t)(base + (k & 1) + (k >> 1) * stride) * Cin +
                  ch;
              if (x_al)
                c[it][k] = __ldg(reinterpret_cast<const float4*>(src));
              else
                c[it][k] = make_float4(src[0], left > 1 ? src[1] : 0.f,
                                       left > 2 ? src[2] : 0.f,
                                       left > 3 ? src[3] : 0.f);
            }
          }
#pragma unroll
          for (int it = 0; it < 2; ++it) {
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (w[it][k] != 0.f) {
                const float wk = w[it][k];
                v.x = __fadd_rn(v.x, __fmul_rn(c[it][k].x, wk));
                v.y = __fadd_rn(v.y, __fmul_rn(c[it][k].y, wk));
                v.z = __fadd_rn(v.z, __fmul_rn(c[it][k].z, wk));
                v.w = __fadd_rn(v.w, __fmul_rn(c[it][k].w, wk));
              }
            }
            // half 0 keeps channels 0, 1 of its piece and takes pixel 2
            // pp + 1's from half 1, which keeps 2, 3 and takes pixel 2 pp's
            const float2 mine = h ? make_float2(v.z, v.w)
                                  : make_float2(v.x, v.y);
            const float2 give = h ? make_float2(v.x, v.y)
                                  : make_float2(v.z, v.w);
            const float2 got = make_float2(
                __shfl_xor_sync(0xffffffffu, give.x, 16),
                __shfl_xor_sync(0xffffffffu, give.y, 16));
            store(pp0 + 4 * it, 2 * q4 + h, h ? got : mine, h ? mine : got);
          }
        }
      } else {
        // 8 channels of one pixel per item, MN-major (read with trans-b):
        // the forward's bf16 sample; a thread takes one pixel, its corners
        // once, and the channel groups q0, q0 + 128 / TPX, ...
        const int p = bt & (TPX - 1);
        const int base = base_of(p);
        int pos[4];
        float wk[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          wk[k] = tw_[k * TPX + p];
          pos[k] = base + (k & 1) + (k >> 1) * stride;
          if (win) pos[k] = min(max(pos[k], 0), area - 1);
        }
        const auto store = [&](int q, const float (&s8)[8]) {
          uint4 packed;
          bf162* pk = reinterpret_cast<bf162*>(&packed);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            pk[c] = __floats2bfloat162_rn(s8[2 * c], s8[2 * c + 1]);
          *reinterpret_cast<uint4*>(st + (p >> 3) * A_LBO + q * 128 +
                                    (p & 7) * 16) = packed;
        };
        const int qs = 128 / TPX;  // channel-group step
        if (win) {
          // two channel groups at once: their 8 corner reads issued
          // before any sum
          for (int q = bt / TPX; q < 8; q += 2 * qs) {
            const bool two = q + qs < 8;
            uint4 raw[2][4];
#pragma unroll
            for (int it = 0; it < 2; ++it) {
              const int qq = min(q + it * qs, 7);
#pragma unroll
              for (int k = 0; k < 4; ++k)
                raw[it][k] = *reinterpret_cast<const uint4*>(
                    win + pos[k] * PIX + ((qq ^ (pos[k] & 7)) << 4));
            }
#pragma unroll
            for (int it = 0; it < 2; ++it) {
              if (it == 1 && !two) break;
              float s8[8];
#pragma unroll
              for (int c = 0; c < 8; ++c) s8[c] = 0.f;
#pragma unroll
              for (int k = 0; k < 4; ++k)
                if (wk[k] != 0.f) add8(s8, raw[it][k], wk[k]);
              store(q + it * qs, s8);
            }
          }
          return;
        }
        for (int q = bt / TPX; q < 8; q += qs) {
          const int ch = c0 + 8 * q;
          float s8[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) s8[c] = 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (wk[k] != 0.f && Cin - ch > 0)
              add8(s8,
                   load_piece(img + (int64_t)pos[k] * Cin + ch, Cin - ch,
                              x_al),
                   wk[k]);
          store(q, s8);
        }
      }
    };

    if (pwg == 0) {
      // the stager: tile li into table, info, g and window slots li & 1
      // (one window slot: 0), once the samplers are done with the tile
      // that used them; the next tile's entry loads fly meanwhile
      if (ntiles > 0) load_entries(tbeg);
      for (int li = 0; li < ntiles; ++li) {
        const int tile = tbeg + li;
        const int slot = li & 1;
        if (li >= 2) hopper::mbar_wait(built + slot, ((li >> 1) - 1) & 1);
        DCN_PHASE(0);  // stager 0: the wait for the samplers
        const dcn_exact::Box box = finish_entries(tile, slot);
        const bool window = (int64_t)box.bh * box.bw <= a.cap;
        if (counts) atomicAdd(a.route_counts + (window ? 0 : 1), 1);
        if (pt == 0) {
          s_info[2 * slot] = make_int4(box.r0, box.c0, box.bh, box.bw);
          s_info[2 * slot + 1] = make_int4(window, 0, 0, 0);
        }
        DCN_PHASE(1);  // stager 1: corners, box and route of a tile
        if (li + 1 < ntiles) load_entries(tile + 1);
        DCN_PHASE(2);  // stager 2: the next tile's entry loads
        const int gu = (li >> 1) - 1;  // the g slot's use before
        if (gu >= 0) hopper::mbar_wait(g_empty + slot, gu & 1);
        load_g(tile, slot, g_full + slot);
        if (a.ws == 1 && li >= 1)  // the window's builds of the tile before
          hopper::mbar_wait(built + (slot ^ 1), ((li - 1) >> 1) & 1);
        load_window(tile, a.ws == 2 ? slot : 0, box, window,
                    win_full + (a.ws == 2 ? slot : 0));
        DCN_PHASE(3);  // stager 3: issuing a tile's copies
      }
    } else {
      // the samplers: tile li once its window (and the table and info
      // written before the copies' arrival) is in
      for (int li = 0; li < ntiles; ++li) {
        const int tile = tbeg + li;
        const int slot = li & 1;
        const int wslot = a.ws == 2 ? slot : 0;
        int b, y0, x0;
        tile_origin(tile, a.tiles_x, a.tiles_y, a.th, b, y0, x0);
        const T* img = a.x + (int64_t)b * H * W * Cin;
        hopper::mbar_wait(win_full + wslot, (a.ws == 2 ? li >> 1 : li) & 1);
        DCN_PHASE(4);  // sampler 4: the wait for the tile's window
        const int4 bi = s_info[2 * slot];
        const dcn_exact::Box box{bi.x, bi.y, bi.z, bi.w};
        const unsigned char* win =
            s_info[2 * slot + 1].x ? s_win + wslot * win_b : nullptr;
        for (int j = 0; j < ntaps; ++j) {
          const int n = li * ntaps + j;  // stage n % S, its (n / S)-th use
          if (n % NB != bwg) continue;
          const int s = n % S;
          const int u = n / S;
          if (u > 0) hopper::mbar_wait(empty + s, (u - 1) & 1);
          DCN_PHASE(5);  // sampler 5: the wait for a free stage
          build(j, slot, win, box, img, s_stage + s * stage_b);
          DCN_PHASE(6);  // sampler 6: building a sample
          hopper::fence_async_shared();
          hopper::mbar_arrive(full + s);
          DCN_PHASE(7);  // sampler 7: publishing it (fence, arrive)
        }
        hopper::mbar_arrive(built + slot);
      }
    }
    DCN_PHASES_END_IF(pt == 0 || pt == 128);
  } else {
    // ---- the consumers ---------------------------------------------------
    hopper::setmaxnreg_inc<R::CREGS>();
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int m0 = wg * MPW;  // this warpgroup's first M tile
    const int ksn = LOW ? TPX / 16 : TPX / 8;  // k steps of a product
    DCN_PHASES_BEGIN;
    float acc[TPW][MPW][32];
#pragma unroll
    for (int j = 0; j < TPW; ++j)
#pragma unroll
      for (int m = 0; m < MPW; ++m) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[j][m][i] = 0.f;
        hopper::fence_acc(acc[j][m]);
      }
    // g^T of this warpgroup's M tiles, the A fragments of a tile's k
    // steps (float32: TF32 hi, lo; bf16: gh only)
    uint32_t gh[MPW][WKS][4], gl[MPW][WKS][4];
    for (int li = 0; li < ntiles; ++li) {
      const int slot = li & 1;
      hopper::mbar_wait(g_full + slot, (li >> 1) & 1);
      DCN_PHASE(8);  // consumer 8: the wait for the tile's output grad
      const unsigned char* gs = s_g + slot * g_b;
#pragma unroll
      for (int m = 0; m < MPW; ++m) {
        const int o = 64 * (m0 + m) + 16 * warp + (lane >> 2);
#pragma unroll
        for (int ks = 0; ks < WKS; ++ks) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int oo = o + 8 * (i & 1);
            gh[m][ks][i] = gl[m][ks][i] = 0u;
            if (ks >= ksn) continue;
            if constexpr (!LOW) {
              const int k = 8 * ks + (lane & 3) + 4 * (i >> 1);
              const float v =
                  *reinterpret_cast<const float*>(gs + k * gpitch + oo * 4);
              const float hi = hopper::tf32_rna(v);
              gh[m][ks][i] = __float_as_uint(hi);
              gl[m][ks][i] = __float_as_uint(hopper::tf32_rna(v - hi));
            } else {
              const int k = 16 * ks + 2 * (lane & 3) + 8 * (i >> 1);
              const uint32_t lo16 = *reinterpret_cast<const uint16_t*>(
                  gs + k * gpitch + oo * 2);
              const uint32_t hi16 = *reinterpret_cast<const uint16_t*>(
                  gs + (k + 1) * gpitch + oo * 2);
              gh[m][ks][i] = lo16 | (hi16 << 16);
            }
          }
        }
      }
      hopper::mbar_arrive(g_empty + slot);
      DCN_PHASE(9);  // consumer 9: g^T into registers
#pragma unroll
      for (int j = 0; j < TPW; ++j) {
        if (j >= ntaps) break;
        const int n = li * ntaps + j;
        const int s = n % S;
        hopper::mbar_wait(full + s, (n / S) & 1);
        DCN_PHASE(10);  // consumer 10: the wait for a full stage
        const unsigned char* st = s_stage + s * stage_b;
        hopper::wgmma_fence();
#pragma unroll
        for (int m = 0; m < MPW; ++m) {
#pragma unroll
          for (int ks = 0; ks < WKS; ++ks) {
            if (ks >= ksn) break;
            if constexpr (!LOW) {
              const int asbo = weight_asbo(a.th);
              const uint64_t bh = hopper::desc(st + ks * 256, 128, asbo);
              const uint64_t bl =
                  hopper::desc(st + 8 * asbo + ks * 256, 128, asbo);
              hopper::wgmma_tf32_rs<64>(acc[j][m], gl[m][ks], bh, 1);
              hopper::wgmma_tf32_rs<64>(acc[j][m], gh[m][ks], bl, 1);
              hopper::wgmma_tf32_rs<64>(acc[j][m], gh[m][ks], bh, 1);
            } else {
              hopper::wgmma_bf16_rs<64, 1>(
                  acc[j][m], gh[m][ks],
                  hopper::desc(st + 2 * ks * A_LBO, A_LBO, 128), 1);
            }
          }
        }
        hopper::wgmma_commit();
        DCN_PHASE(11);  // consumer 11: issuing a product
        // the product done, its stage is free at once: a consumer holds
        // no stage while it waits, so the producers may fill the whole
        // ring ahead of it (the tensor cores run one product at a time)
        hopper::wgmma_wait_all();
        hopper::mbar_arrive(empty + s);
        DCN_PHASE(12);  // consumer 12: the wait for the product
      }
#pragma unroll
      for (int m = 0; m < MPW; ++m)
#pragma unroll
        for (int ks = 0; ks < WKS; ++ks) {
          hopper::fence_regs(gh[m][ks]);  // g^T's registers are free again
          hopper::fence_regs(gl[m][ks]);
        }
      DCN_PHASE(13);  // consumer 13: the tile's end
    }
#pragma unroll
    for (int j = 0; j < TPW; ++j)
#pragma unroll
      for (int m = 0; m < MPW; ++m) hopper::fence_acc(acc[j][m]);

    // epilogue from the fragments: rows (output channels) 16 warp + lane
    // / 4 (+ 8) of each M tile, columns (input channels) 8 jc + 2 (lane %
    // 4) (+ 1); grad w when the pixels are not split (bf16: rounded),
    // else this split's float32 partial
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      if (j >= ntaps) break;
      const int t = t0 + j;
#pragma unroll
      for (int m = 0; m < MPW; ++m) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int o =
              n0 + 64 * (m0 + m) + 16 * warp + (lane >> 2) + 8 * hh;
          if (o >= Cout) continue;
#pragma unroll
          for (int jc = 0; jc < 8; ++jc) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = c0 + 8 * jc + 2 * (lane & 3) + e;
              if (c >= Cin) continue;
              const int64_t idx = ((int64_t)t * Cin + c) * Cout + o;
              const float v = acc[j][m][4 * jc + 2 * hh + e];
              if (a.splits > 1)
                a.partial[(int64_t)split * 9 * Cin * Cout + idx] = v;
              else
                a.grad_w[idx] = from_f32<T>(v);
            }
          }
        }
      }
    }
    DCN_PHASE(14);  // consumer 14: the flush of the accumulators
    DCN_PHASES_END_IF(tid == 0);
  }
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

template <typename T, int NP_>
int launch_weight_kernel(const WeightArgs<T>& a, int chunks, int smem,
                         cudaStream_t s) {
  using R = WRoles<NP_>;
  static int smem_set = 0;  // the dynamic shared memory allowed so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dcn_exact_bwd_weight_kernel<T, NP_>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const dim3 grid(chunks * a.groups * a.col_tiles, a.splits);
  dcn_exact_bwd_weight_kernel<T, NP_>
      <<<grid, 128 * (R::NPROD + R::NCONS), smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_weight(WeightArgs<T> a, int B, int H, int W, int Cin, int Cout,
                  int tile_h, int tile_w, int chunk, int n_tile, int taps,
                  int window_slots, int box_capacity, int splits, int smem,
                  cudaStream_t s) {
  constexpr bool LOW = is_low<T>();
  const int widest = LOW ? 256 : 128;  // ops/dcn.EXACT_WEIGHT_MAX_N_TILE
  const int most = n_tile == 64    ? WRoles<64>::TPW
                   : n_tile == 128 ? WRoles<128>::TPW
                                   : WRoles<256>::TPW;
  const int tiles_x = (W + WTW - 1) / WTW;
  const int tiles_y = tile_h > 0 ? (H + tile_h - 1) / tile_h : 0;
  const int64_t tiles = (int64_t)B * tiles_y * tiles_x;
  if (Cin <= 0 || Cout <= 0 || tiles <= 0 || tiles > 0x7fffffff ||
      H > 32766 || W > 32766 || tile_w != WTW ||
      (tile_h != 4 && tile_h != 2 && tile_h != 1) ||
      tile_h * WTW > WKS * (LOW ? 16 : 8) || chunk != WCK ||
      (n_tile != 64 && n_tile != 128 && n_tile != 256) ||
      n_tile > widest || (n_tile < Cout && n_tile != widest) ||
      (n_tile > 64 && n_tile / 2 >= Cout) ||
      taps < 1 || taps > 9 || taps > most ||
      (window_slots != 1 && window_slots != 2) ||
      box_capacity < 1 || splits < 1 || splits > tiles || splits > 65535 ||
      smem != weight_smem_bytes<T>(n_tile, tile_h, taps, window_slots,
                                   box_capacity) ||
      smem > 232448 || (splits > 1 && a.partial == nullptr))
    return (int)cudaErrorInvalidValue;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  a.th = tile_h;
  a.taps = taps;
  a.ws = window_slots;
  a.cap = box_capacity;
  a.tiles_x = tiles_x;
  a.tiles_y = tiles_y;
  a.tiles = (int)tiles;
  a.groups = (9 + taps - 1) / taps;
  a.col_tiles = (Cout + n_tile - 1) / n_tile;
  a.splits = splits;
  const int chunks = (Cin + WCK - 1) / WCK;
  int err = n_tile == 64    ? launch_weight_kernel<T, 64>(a, chunks, smem, s)
            : n_tile == 128 ? launch_weight_kernel<T, 128>(a, chunks, smem, s)
                            : launch_weight_kernel<T, 256>(a, chunks, smem, s);
  if (err != 0 || splits == 1) return err;
  const int64_t count = (int64_t)9 * Cin * Cout;
  const int threads = 256;
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
// window tiles, gather tiles, added to) and a data launcher's `reductions`
// (1 64-bit int, added to) may be null. Any offset.

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
                                  int* route_counts,
                                  unsigned long long* reductions, int B,
                                  int H, int W, int Cin, int Cout,
                                  int tile_h, int tile_w,
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
  a.reductions = reductions;
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
    bf16* grad_mask, float* partial, int* route_counts,
    unsigned long long* reductions, int B, int H, int W,
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
  a.reductions = reductions;
  return launch_data(a, nullptr, grad_x, B, H, W, Cin, Cout, tile_h, tile_w,
                     chunk, warpgroups, k_tile, box_capacity, splits, smem,
                     (cudaStream_t)stream);
}

// The weight gradient at float32 (ops/dcn.exact_bwd_weight_fp32_plan):
// tile_h (2 or 1), tile_w, chunk, n_tile (64 or 128: the block's output
// channels, its M tiles x 64; past 128 in blocks of 128), taps (per
// block: at most 5 at n_tile 64, 3 at 128), window_slots (1 or 2),
// box_capacity, splits (of the pixel tiles) and the dynamic shared
// memory; the ring's stages are the kernel's (weight_stages). grad_w (3,
// 3, Cin, Cout) is fully written; `partial` holds splits * 9 * Cin * Cout
// floats when splits > 1 and may be null otherwise. H and W are at most
// 32766.
extern "C" int dcn_exact_bwd_weight(
    const float* x, const float* offset, const float* mask,
    const float* grad_out, float* grad_w, float* partial, int* route_counts,
    int B, int H, int W, int Cin, int Cout, int tile_h, int tile_w,
    int chunk, int n_tile, int taps, int window_slots,
    int box_capacity, int splits, int smem, void* stream) {
  WeightArgs<float> a{};
  a.x = x;
  a.offset = offset;
  a.mask = mask;
  a.grad_out = grad_out;
  a.grad_w = grad_w;
  a.partial = partial;
  a.route_counts = route_counts;
  return launch_weight(a, B, H, W, Cin, Cout, tile_h, tile_w, chunk, n_tile,
                       taps, window_slots, box_capacity, splits,
                       smem, (cudaStream_t)stream);
}

// The same at bfloat16 (ops/dcn.exact_bwd_weight_bf16_plan: tile_h 4, 2
// or 1; n_tile 256 with 1 tap past Cout 128); grad_w bf16, rounded once.
extern "C" int dcn_exact_bwd_weight_bf16(
    const bf16* x, const bf16* offset, const bf16* mask,
    const bf16* grad_out, bf16* grad_w, float* partial, int* route_counts,
    int B, int H, int W, int Cin, int Cout, int tile_h, int tile_w,
    int chunk, int n_tile, int taps, int window_slots,
    int box_capacity, int splits, int smem, void* stream) {
  WeightArgs<bf16> a{};
  a.x = x;
  a.offset = offset;
  a.mask = mask;
  a.grad_out = grad_out;
  a.grad_w = grad_w;
  a.partial = partial;
  a.route_counts = route_counts;
  return launch_weight(a, B, H, W, Cin, Cout, tile_h, tile_w, chunk, n_tile,
                       taps, window_slots, box_capacity, splits,
                       smem, (cudaStream_t)stream);
}
