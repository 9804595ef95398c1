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
//   and lo in place) once by cp.async. Once a tile it computes each of the
//   tile's 64 pixels x 9 taps' corners (dcn_exact.cuh grad_position) into
//   a corner table in shared memory, 17 bytes an entry: (fy, fx, m, the
//   top-left corner) and a byte of the needed corners and the clip's two
//   slope codes, from which every walk rebuilds the 12 weights in the
//   same arithmetic (grad_weights); the same pass finds the tile's data
//   box: the smallest rectangle holding every corner its 64 pixels x 9
//   taps need (`needed`: inside the map, one weight not 0; one row and
//   one column more than the forward's box of live corners at integer
//   positions). Where the box's area is at most the plan's capacity the
//   block takes its window route, else its gather route; the choice is
//   per block, on the device. Its K loop runs over steps (Cin chunk of CK
//   channels, tap), chunk-major. Each warpgroup owns NW = CK / NWG of a
//   chunk's channels and runs the loop on its own, one barrier of its
//   own a step:
//     - G_t = g w[t]^T (64 pixels x its NW channels) on the tensor cores,
//       3xTF32 at float32 in two wgmma a K step (g_product: a_hi [b_hi |
//       b_lo] at N 2 NW, then a_lo b_hi), bf16 wgmma m64n32k16 at bf16,
//       issued a step ahead: step s + 1's G runs into a second register
//       set during step s's walk, from the second of two weight slots,
//       issued at the loop turn's start and waited for at its end (the
//       kernel's FAST instance; a product in flight across the turn made
//       ptxas serialize every wgmma). Issuing a float32 product still
//       holds the warps for most of its length (small N): it overlaps
//       the other warpgroups' walks. The weights
//       are laid out for the slots once a call by a small kernel
//       (float32: split into TF32 hi and lo), so that a step's share
//       comes by one bulk copy, two steps ahead, completing on the slot's
//       mbarrier apart from the window's cp.async groups;
//     - window route: its channels of the chunk's box of x come by
//       cp.async, zero-filled past Cin; with two window slots the next
//       chunk's are copied at the chunk's first step and land during its
//       walks, with one the chunk's are copied at its first step;
//     - the corner walk: each thread takes two pixels and CPT channels,
//       straight from its accumulator fragment (the weight slots' columns
//       are permuted so that it holds runs of 4 consecutive channels,
//       fragment_column: a quad's reduction instruction then covers 64
//       contiguous bytes of a pixel's grad x, whole sectors, which made
//       the bf16 kernel 1.45x faster than runs of 8, half sectors per
//       lane), reads each tap's table entry and rebuilds its weights,
//       reads x of each
//       needed corner from the window (or global memory), sums d_k over
//       its channels against the three weights, and adds m hat_k G into
//       grad x (float32, or the float32 scratch at bf16) by global vector
//       reductions (red.global.add.v4.f32, native on sm_90), since two
//       pixels of a tile, and the halos of neighbouring tiles, may hit
//       one corner. A float32 grad-x tile in shared memory would need
//       atomics there, which sm_90 runs as compare-and-swap loops
//       (ATOMS.CAST.SPIN): such a tile made this kernel about twice as
//       slow (PERF.md). Summing grad x over the tile's box on the tensor
//       cores instead (S_t^T G_t in 3xTF32, flushed once a chunk) cut the
//       reductions 8x and made it slower at both dtypes (PERF.md).
//   Measured and dropped (PERF.md): issuing the next G in two
//   halves inside the walk (the issue moved into the walk), float32
//   chunks of 64 at Cout 64 (one block an SM: s4 slower), the table's
//   loads batched with the first window landing under the first G.
//   An output grad wider than 256 channels is contracted in pieces of
//   256, each piece's g and weights copied per step by the whole block
//   with block-wide barriers, serially (no model shape needs it).
//   grad offset and grad mask are summed over a thread's channels, then its
//   quad by shuffles, kept in registers over the block's steps in order
//   and added warpgroup 0 + warpgroup 1 at its end, a fixed order, so
//   they are the same bit for bit on every launch; grad x sums in an
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
// In practice the data kernel's walk (its reads and grad x's reductions,
// 50-79% of a block's cycles at s4) and, at float32, issuing the 3xTF32
// products (20-46%) decide its time; the weight kernel's stager and the
// latency of each tile's copies decide the weight kernel's.

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

// s += the 8 bf16 of `raw` * w, term by term without fused multiply-adds
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

// The wgmma N column that holds channel c (0..nw-1) of a warpgroup's nw
// channels: thread quad lane q holds columns 8 j + 2 q + e of its
// fragment, its i-th value (i = 2 j + e) at column 8 (i / 2) + 2 q + i % 2.
// Its cpt = nw / 4 channels come in groups of gc = min(cpt, 4)
// consecutive ones, group k of the quad's lanes side by side: value i of
// lane q is channel 4 gc (i / gc) + gc q + i % gc. So each lane holds
// runs of 16 bytes (float32) and a quad's lanes one 64-byte run of a
// pixel's grad x per run (a reduction instruction fills whole sectors).
__host__ __device__ __forceinline__ int fragment_column(int c, int nw) {
  const int gc = nw / 4 < 4 ? nw / 4 : 4;
  const int k = c / (4 * gc);
  const int r = c - k * 4 * gc;
  const int q = r / gc;
  const int i = k * gc + r % gc;
  return 8 * (i >> 1) + 2 * q + (i & 1);
}

// ---- the data kernels ---------------------------------------------------

constexpr int MAX_KC = 256;  // output channels of a G piece
constexpr int DBAR_B = 64;   // the weight slots' barriers ([2][2]) and the box
// bytes of a corner-table entry: a float4 (fy, fx, m, the top-left corner
// as two int16) and a byte (the needed corners' bits, the two clip-slope
// codes)
constexpr int DENT_B = 17;

// bytes of a window pixel (CK channels of x), padded by 16 so that
// neighbouring pixels start in other bank groups
template <typename T>
__host__ __device__ constexpr int x_pitch(int ck) {
  return ck * (int)sizeof(T) + 16;
}

// the barriers and the box, the g tile (float32: hi and lo), two weight
// slots (hi and lo), the corner table of the tile's 9 x 64 (tap, pixel)s
// (after the walks: the second warpgroup's grad offset and grad mask
// sums), `ws` window slots of `cap` pixels
template <typename T>
__host__ __device__ constexpr int data_smem_bytes(int kc, int ck, int ws,
                                                  int cap) {
  return DBAR_B + (is_low<T>() ? 1 : 2) * (TP + 2 * ck) * kc * (int)sizeof(T) +
         9 * TP * DENT_B + ws * cap * x_pitch<T>(ck);
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

// Registers a thread holds for one product of G (64 pixels x NW
// channels): its fragment, and at float32 a second half (g_product).
template <typename T, int NW>
__host__ __device__ constexpr int g_regs() {
  return is_low<T>() ? NW / 2 : NW;
}

// Gd = g w^T over the K of one output-grad piece (accumulate: added to
// Gd), for the warpgroup's NW channels: g at `sg` (float32: hi, then lo
// g_part bytes on), the warpgroup's weight share at `sw`, both K-major in
// core matrices; issued and committed, not waited for. bf16: one wgmma a
// K step, Gd the fragment. float32, 3xTF32 in two wgmma a K step: a_hi
// [b_hi | b_lo] (N = 2 NW: the share's hi and lo parts lie side by side,
// NW / 8 core-matrix groups each), then a_lo b_hi into the first half, so
// that G = the first half + the second (g_sum); three products of N NW
// a K step took a third more of the warps' time, the tensor cores taking
// about as long for a wgmma of N 8, 16 or 32. A free function, so that
// the accumulators stay registers wherever it is called.
template <typename T, int NW>
__device__ __forceinline__ void g_product(float (&Gd)[g_regs<T, NW>()],
                                          const unsigned char* sg,
                                          const unsigned char* sw,
                                          int g_part, int KC,
                                          int accumulate) {
  constexpr int KSTEP = is_low<T>() ? 16 : 8;  // K of one wgmma: 256 bytes
  const int SBO = KC * (int)sizeof(T) * 8;
  hopper::fence_acc(Gd);
  hopper::wgmma_fence();
  uint64_t dg = hopper::desc(sg, 128, SBO);
  uint64_t dw = hopper::desc(sw, 128, SBO);
  if constexpr (!is_low<T>()) {
    float(&half)[NW / 2] = *reinterpret_cast<float(*)[NW / 2]>(&Gd[0]);
    uint64_t dg_lo = hopper::desc(sg + g_part, 128, SBO);
    for (int ks = 0; ks < KC / KSTEP; ++ks) {
      hopper::wgmma_tf32<2 * NW>(Gd, dg, dw, accumulate || ks > 0);
      hopper::wgmma_tf32<NW>(half, dg_lo, dw, 1);
      dg += 16;
      dg_lo += 16;
      dw += 16;
    }
  } else {
    for (int ks = 0; ks < KC / KSTEP; ++ks) {
      hopper::wgmma_bf16<NW, 0, 0>(Gd, dg, dw, accumulate || ks > 0);
      dg += 16;
      dw += 16;
    }
  }
  hopper::wgmma_commit();
}

// G (the walk's NW / 2 fragment values) from a finished product's
// registers: at float32 the sum of its two halves
template <typename T, int NW>
__device__ __forceinline__ void g_sum(float (&G)[NW / 2],
                                      const float (&Gd)[g_regs<T, NW>()]) {
#pragma unroll
  for (int k = 0; k < NW / 2; ++k)
    G[k] = is_low<T>() ? Gd[k] : Gd[k] + Gd[g_regs<T, NW>() - NW / 2 + k];
}

template <typename T>
struct DataArgs {
  const T* x;
  const T* offset;
  const T* mask;
  const T* weight;
  const unsigned char* wlay;  // the weight slices in the slots' layout
  const T* grad_out;
  float* grad_acc;  // float32 grad x (float32), the scratch (bf16)
  T* grad_offset;
  T* grad_mask;
  float* partial;
  int* route_counts;
  unsigned long long* reductions;
  int64_t npix;
  int H, W, Cin, Cout, KC, pieces, KP;
  int tiles_x, tiles_y, nsteps, splits, ws, cap;
};

// The data kernel for chunks of CK input channels, NWG warpgroups, each
// with NW = CK / NWG of them (its wgmma N). The warpgroups share the
// tile's output grad and corner table and touch distinct channels of the
// rest: each copies and reads its own share of the window and weight
// slots, issues its own G and meets the other only at the tile's start
// and end. COUNT: add the reductions into grad x to a.reductions. FAST:
// the output grad is one G piece (a.pieces 1), each step's G issued a
// step ahead; else every G is computed serially, piece by piece.
template <typename T, int CK, int NWG, bool COUNT, bool FAST>
__global__ void __launch_bounds__(128 * NWG)
    dcn_exact_bwd_data_kernel(const DataArgs<T> a) {
  constexpr bool LOW = is_low<T>();
  constexpr int NT = 128 * NWG;
  constexpr int NW = CK / NWG;
  constexpr int CPT = NW / 4;  // channels per thread and pixel
  constexpr int GC = CPT < 4 ? CPT : 4;  // ... in runs of GC
  constexpr int EK = 16 / (int)sizeof(T);  // elements of a 16-byte piece
  constexpr int XP = x_pitch<T>(CK);
  constexpr int PER = (9 * TP + NT - 1) / NT;  // table entries per thread
  constexpr int PARTS = LOW ? 1 : 2;
  constexpr int NPW = NW * (int)sizeof(T) / 16;  // a warpgroup's pieces of
                                                 // a window pixel
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout, KC = a.KC;
  const int SBO = KC * (int)sizeof(T) * 8;  // g and weight slot: bytes
                                            // between 8-row groups
  const int g_part = TP * KC * (int)sizeof(T);
  const int wgb = PARTS * NW * KC * (int)sizeof(T);  // a warpgroup's share
                                                     // of a weight slot
  uint64_t* wfull = reinterpret_cast<uint64_t*>(smem);  // [wg][slot]
  int* s_box = reinterpret_cast<int*>(smem + 32);
  unsigned char* s_g = smem + DBAR_B;              // [part] TP x KC
  unsigned char* s_w = s_g + PARTS * g_part;       // [slot][wg] wgb
  float4* s_tab = reinterpret_cast<float4*>(s_w + 2 * NWG * wgb);  // [9][TP]
  unsigned char* s_flag = reinterpret_cast<unsigned char*>(s_tab + 9 * TP);
  unsigned char* s_win = s_flag + 9 * TP;  // [slot] cap x XP
  float* s_stage = reinterpret_cast<float*>(s_tab);  // after the walks

  const int tid = threadIdx.x;
  const int wg = tid >> 7;          // warpgroup: channels NW wg ..
  const int wt = tid & 127;         // its thread
  const int warp = (tid >> 5) & 3;  // tile row
  const int lane = tid & 31;
  const int l4 = lane & 3;
  const int tile = blockIdx.x;
  const int txi = tile % a.tiles_x;
  const int tyi = (tile / a.tiles_x) % a.tiles_y;
  const int b = tile / (a.tiles_x * a.tiles_y);
  const int y0 = tyi * TH;
  const int x0 = txi * TW;
  const int split = blockIdx.z;
  const int s_begin = (int)((int64_t)split * a.nsteps / a.splits);
  const int s_end = (int)((int64_t)(split + 1) * a.nsteps / a.splits);
  const int n = s_end - s_begin;  // steps of this block, at least 1
  const int c_first = s_begin / 9;
  const int c_last = (s_end - 1) / 9;
  constexpr bool fast = FAST;
  const bool x_al = Cin % EK == 0 && hopper::aligned16(a.x);
  const bool g_al = Cout % EK == 0 && hopper::aligned16(a.grad_out);
  const bool acc_al = Cin % 4 == 0 && hopper::aligned16(a.grad_acc);
  const T* img = a.x + (int64_t)b * H * W * Cin;
  float* acc_img = a.grad_acc + (int64_t)b * H * W * Cin;

  if (tid == 0) {
    for (int i = 0; i < 2 * NWG; ++i) hopper::mbar_init(wfull + i, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();  // the barriers initialised

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
      const int64_t nn = ((int64_t)b * H + y) * W + xx;
      copy_piece(s_g + (p >> 3) * SBO + q * 128 + (p & 7) * 16,
                 in ? a.grad_out + nn * Cout + o : a.grad_out,
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
  // this warpgroup's share of step s's weight slice of piece pc, as
  // dcn_exact_bwd_layout_kernel laid it out
  const auto w_src = [&](int s, int pc) {
    return a.wlay + (((int64_t)pc * (a.nsteps / 9) * 9 + s) * NWG + wg) * wgb;
  };
  uint64_t* my_full = wfull + 2 * wg;
  // step s (the block's r-th) into weight slot r & 1 by one bulk copy,
  // completing on the slot's barrier (issued by the warpgroup's thread 0)
  const auto load_w = [&](int s, int r) {
    hopper::mbar_arrive_expect_tx(my_full + (r & 1), wgb);
    hopper::bulk_copy(s_w + ((r & 1) * NWG + wg) * wgb, w_src(s, 0), wgb,
                      my_full + (r & 1));
  };

  DCN_PHASES_BEGIN;  // phase 0: the corner table and the box
  if (fast) {
    if (wt == 0) {
      load_w(s_begin, 0);
      if (n > 1) load_w(s_begin + 1, 1);
    }
    load_g(0);
    hopper::cp_async_commit();
  }

  // The corner table, (tap, pixel) e t * TP + p: each entry's corners
  // once a tile (grad_position, and grad_weights for `needed`), folded
  // into the tile's data box: every needed corner of its pixels' 9 taps.
  // Pixels past the map have no needed corner.
  int rmin = INT_MAX, rmax = INT_MIN, cmin = INT_MAX, cmax = INT_MIN;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = tid + NT * j;
    if (e >= 9 * TP) break;
    const int p = e / 9;  // consecutive threads: a pixel's taps
    const int t = e - 9 * p;
    const int y = y0 + p / TW;
    const int xx = x0 + p % TW;
    float4 ent = make_float4(0.f, 0.f, 0.f, 0.f);
    int fl = 0;
    if (y < H && xx < W) {
      const int64_t nn = ((int64_t)b * H + y) * W + xx;
      const float m = f32(a.mask[nn * 9 + t]);
      int iy, ix, sy, sx;
      float fy, fx, hat[4], gy[4], gx[4];
      dcn_exact::grad_position(y, xx, t, f32(a.offset[nn * 18 + 2 * t]),
                               f32(a.offset[nn * 18 + 2 * t + 1]), H, W, iy,
                               ix, fy, fx, sy, sx);
      dcn_exact::grad_weights(fy, fx, m, sy, sx, hat, gy, gx);
      const int needed = dcn_exact::grad_needed(iy, ix, H, W, hat, gy, gx);
      dcn_exact::fold_box(iy, ix, needed, rmin, rmax, cmin, cmax);
      const uint32_t iyx = ((uint32_t)iy & 0xffffu) | ((uint32_t)ix << 16);
      ent = make_float4(fy, fx, m, __int_as_float((int)iyx));
      fl = needed | sy << 4 | sx << 6;
    }
    s_tab[t * TP + p] = ent;
    s_flag[t * TP + p] = (unsigned char)fl;
  }
  // (its barriers publish the table)
  const dcn_exact::Box box =
      dcn_exact::block_box(rmin, rmax, cmin, cmax, s_box);
  const bool window = (int64_t)box.bh * box.bw <= a.cap;
  if (a.route_counts && tid == 0 && split == 0)
    atomicAdd(a.route_counts + (window ? 0 : 1), 1);
  DCN_PHASE(0);

  // this warpgroup's channels of a Cin chunk's box of x into window slot
  // `slot`: NPW pieces of EK channels a pixel
  const auto load_window = [&](int chunk, int slot) {
    unsigned char* dst = s_win + slot * a.cap * XP + wg * NW * (int)sizeof(T);
    const int chw = chunk * CK + wg * NW;
    const int np = box.bh * box.bw * NPW;
    for (int e = wt; e < np; e += 128) {
      const int pos = e / NPW;
      const int q = e - pos * NPW;
      const int wr = pos / box.bw;
      const int yy = box.r0 + wr;
      const int xc = box.c0 + (pos - wr * box.bw);
      const int ch = chw + EK * q;
      copy_piece(dst + pos * XP + 16 * q,
                 img + ((int64_t)yy * W + xc) * Cin + ch, Cin - ch, x_al);
    }
  };
  // piece pc of step s's output grad and this warpgroup's weight share
  // into the g tile and weight slot 0, by the whole block: the serial G
  // of an output grad wider than one piece (block-wide barriers)
  const auto stage_piece = [&](int s, int pc) {
    __syncthreads();  // the products before are done: the slots free
    load_g(pc);
    const unsigned char* src = w_src(s, pc);
    unsigned char* dst = s_w + wg * wgb;
    for (int e = wt; e < wgb / 16; e += 128)
      hopper::cp_async16(dst + 16 * e, src + 16 * e, 16);
    hopper::cp_async_commit();
    hopper::cp_async_wait_all();
    __syncthreads();
    split_g();
    hopper::fence_async_shared();
    __syncthreads();
  };
  if (window) load_window(c_first, 0);
  hopper::cp_async_commit();
  hopper::cp_async_wait_all();
  __syncthreads();  // the output grad and the first window in
  // G of the step being walked (Gc) and of the next (Gn, in flight
  // during the walk where the output grad is one piece). Each product
  // is issued and waited for in one turn of the step loop, and Gn is
  // cleared once copied into Gc: a product in flight across the loop's
  // turn, or linked by value to Gc, lets the compiler copy its
  // accumulators while it runs, and ptxas then serializes every wgmma.
  constexpr int GR = g_regs<T, NW>();
  float Gc[NW / 2], Gn[GR];
#pragma unroll
  for (int k = 0; k < GR; ++k) Gn[k] = 0.f;
  if (fast) {
    split_g();
    hopper::fence_async_shared();
    __syncthreads();  // the split output grad visible to wgmma
    hopper::mbar_wait(my_full, 0);
    g_product<T, NW>(Gn, s_g, s_w + wg * wgb, g_part, KC, 0);
    hopper::wgmma_wait_all();
    hopper::fence_acc(Gn);
  } else {
    for (int pc = 0; pc < a.pieces; ++pc) {
      stage_piece(s_begin, pc);
      g_product<T, NW>(Gn, s_g, s_w + wg * wgb, g_part, KC, pc > 0);
      hopper::wgmma_wait_all();
      hopper::fence_acc(Gn);
    }
  }
  g_sum<T, NW>(Gc, Gn);
#pragma unroll
  for (int k = 0; k < GR; ++k) Gn[k] = 0.f;
  DCN_PHASE(1);  // phase 1: the first copies, the split, the first G

  // The grad mask, dy and dx sums of this thread's two pixels: its quad
  // holds them alike after the shuffles; lane l4 keeps taps l4, l4 + 4,
  // l4 + 8, summed over the block's steps in order. The warpgroups' sums
  // meet at the end (warpgroup 0 + warpgroup 1): a fixed order.
  float sums[3][2][3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      sums[j][hh][0] = sums[j][hh][1] = sums[j][hh][2] = 0.f;
  int reduced = 0;  // floats this thread added into grad x

  // Step r of the block (s = s_begin + r: Cin chunk s / 9, tap s % 9),
  // its G in Gc; the next step's goes into Gn under the walk and into Gc
  // at the turn's end. One barrier of the warpgroup a step: its walk of
  // the step before done, this step's G done (so its weight slot is
  // free), the next step's weights in.
  for (int r = 0; r < n; ++r) {
    const int s = s_begin + r;
    const int chunk = s / 9;
    const int t = s - 9 * chunk;
    const bool opens = r == 0 || t == 0;  // the chunk's first step here
    const int wslot = a.ws == 2 ? (chunk - c_first) & 1 : 0;
    if (window && opens && r > 0 && a.ws == 2)
      hopper::cp_async_wait_all();  // the chunk's window, staged a chunk
                                    // ago
    if (fast && r + 1 < n)
      hopper::mbar_wait(my_full + ((r + 1) & 1), ((r + 1) >> 1) & 1);
    hopper::bar_sync(1 + wg, 128);
    DCN_PHASE(3);  // phase 3: the copies' waits and the barrier
    if (fast) {
      // step s + 1's G from weight slot (r + 1) & 1, under this step's
      // walk; at the block's last step a product whose result is never
      // read, so that no path merges Gn in flight with Gn at rest
      g_product<T, NW>(Gn, s_g, s_w + (((r + 1) & 1) * NWG + wg) * wgb,
                       g_part, KC, 0);
    } else if (r + 1 < n) {
      for (int pc = 0; pc < a.pieces; ++pc) {
        stage_piece(s + 1, pc);
        g_product<T, NW>(Gn, s_g, s_w + wg * wgb, g_part, KC, pc > 0);
        hopper::wgmma_wait_all();
        hopper::fence_acc(Gn);
      }
    }
    if (fast && r + 2 < n && wt == 0) load_w(s + 2, r + 2);
    if (window && opens) {
      if (a.ws == 2) {
        if (chunk < c_last) {
          load_window(chunk + 1, wslot ^ 1);  // lands during the chunk
          hopper::cp_async_commit();
        }
      } else if (r > 0) {
        load_window(chunk, 0);
        hopper::cp_async_commit();
        hopper::cp_async_wait_all();
        hopper::bar_sync(1 + wg, 128);
      }
    }
    DCN_PHASE(4);  // phase 4: issuing the next G and the copies

    // The corner walk. This thread holds G for two pixels (tile row
    // `warp`, columns lane / 4 and lane / 4 + 8) and, per pixel, the CPT
    // channels NW wg + 4 GC (i / GC) + GC l4 + i % GC (fragment_column):
    // Gc[4 (i / 2) + 2 hh + i % 2]. Each (pixel, tap)'s corners and
    // weights come from the table.
    const int cl = NW * wg + GC * l4;  // its first channel in the chunk
    const int ch0 = chunk * CK + cl;
    const unsigned char* win =
        s_win + wslot * a.cap * XP + cl * (int)sizeof(T);
    float v[2][3];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      v[hh][0] = v[hh][1] = v[hh][2] = 0.f;
      const int e = t * TP + 16 * warp + (lane >> 2) + 8 * hh;
      const int fl = s_flag[e];
      if (!(fl & 15)) continue;
      const float4 ent = s_tab[e];
      const float m = ent.z;
      float hat[4], gy[4], gx[4];
      dcn_exact::grad_weights(ent.x, ent.y, m, (fl >> 4) & 3, fl >> 6, hat,
                              gy, gx);
      const int iyx = __float_as_int(ent.w);
      const int iy = (int)(int16_t)(iyx & 0xffff);
      const int ix = iyx >> 16;
      const int wbase = (iy - box.r0) * box.bw + (ix - box.c0);
      const int gbase = iy * W + ix;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!(fl >> k & 1)) continue;
        const int gpos = gbase + (k >> 1) * W + (k & 1);
        float xv[CPT];
        if (window) {
          const T* src = reinterpret_cast<const T*>(
              win + (wbase + (k >> 1) * box.bw + (k & 1)) * XP);
#pragma unroll
          for (int i = 0; i < CPT; ++i)
            xv[i] = f32(src[4 * GC * (i / GC) + i % GC]);
        } else {
          const T* src = img + (int64_t)gpos * Cin + ch0;
#pragma unroll
          for (int i = 0; i < CPT; ++i) {
            const int c = 4 * GC * (i / GC) + i % GC;
            xv[i] = ch0 + c < Cin ? f32(src[c]) : 0.f;
          }
        }
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < CPT; ++i)
          d = fmaf(Gc[4 * (i >> 1) + 2 * hh + (i & 1)], xv[i], d);
        v[hh][0] = fmaf(hat[k], d, v[hh][0]);
        v[hh][1] = fmaf(gy[k], d, v[hh][1]);
        v[hh][2] = fmaf(gx[k], d, v[hh][2]);
        const float wk = __fmul_rn(hat[k], m);
        if (wk == 0.f) continue;
        float add[CPT / GC][GC];
#pragma unroll
        for (int i = 0; i < CPT; ++i)
          add[i / GC][i % GC] = wk * Gc[4 * (i >> 1) + 2 * hh + (i & 1)];
        DCN_PHASE(5);
#pragma unroll
        for (int j = 0; j < CPT / GC; ++j)
          scatter<GC>(acc_img + (int64_t)gpos * Cin + ch0 + 4 * GC * j,
                      add[j], Cin - ch0 - 4 * GC * j, acc_al);
        DCN_PHASE(6);  // phase 6: grad x's global reductions
        if constexpr (COUNT) {
#pragma unroll
          for (int j = 0; j < CPT / GC; ++j)
            reduced += min(max(Cin - ch0 - 4 * GC * j, 0), GC);
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int k = 1; k < 4; k <<= 1)
#pragma unroll
        for (int q = 0; q < 3; ++q)
          v[hh][q] += __shfl_xor_sync(0xffffffffu, v[hh][q], k);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (t == l4 + 4 * j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int q = 0; q < 3; ++q) sums[j][hh][q] += v[hh][q];
    DCN_PHASE(5);  // phase 5: the corner walk's reads and its sums
    hopper::wgmma_wait_all();
    hopper::fence_acc(Gn);
    g_sum<T, NW>(Gc, Gn);
#pragma unroll
    for (int k = 0; k < GR; ++k) Gn[k] = 0.f;
    DCN_PHASE(2);  // phase 2: the wait for the next step's G
  }

  if constexpr (COUNT) {
#pragma unroll
    for (int k = 16; k > 0; k >>= 1)
      reduced += __shfl_xor_sync(0xffffffffu, reduced, k);
    if (lane == 0 && reduced)
      atomicAdd(a.reductions, (unsigned long long)reduced);
  }
  __syncthreads();  // every walk done: the table's room takes the sums
  if (NWG == 2 && wg == 1) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int t = l4 + 4 * j;
      if (t >= 9) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = 16 * warp + (lane >> 2) + 8 * hh;
#pragma unroll
        for (int q = 0; q < 3; ++q)
          s_stage[(9 * q + t) * TP + p] = sums[j][hh][q];
      }
    }
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int t = l4 + 4 * j;
      if (t >= 9) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = 16 * warp + (lane >> 2) + 8 * hh;
        const int y = y0 + warp;
        const int xx = x0 + (lane >> 2) + 8 * hh;
        if (y >= H || xx >= W) continue;
        float g3[3];
#pragma unroll
        for (int q = 0; q < 3; ++q)
          g3[q] = NWG == 2 ? sums[j][hh][q] + s_stage[(9 * q + t) * TP + p]
                           : sums[j][hh][q];
        const int64_t nn = ((int64_t)b * H + y) * W + xx;
        if (a.splits > 1) {
          float* dst = a.partial + ((int64_t)split * a.npix + nn) * 27 + 3 * t;
          dst[0] = g3[1];
          dst[1] = g3[2];
          dst[2] = g3[0];
        } else {
          a.grad_offset[nn * 18 + 2 * t] = from_f32<T>(g3[1]);
          a.grad_offset[nn * 18 + 2 * t + 1] = from_f32<T>(g3[2]);
          a.grad_mask[nn * 9 + t] = from_f32<T>(g3[0]);
        }
      }
    }
  }
  DCN_PHASE(7);  // phase 7: the sums' flush
  DCN_PHASES_END;
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

// The weight slices in the data kernel's slot layout, so that a
// warpgroup takes its share of a step's slot by one bulk copy: per piece
// pc of the output grad, Cin chunk, tap t and warpgroup, NW columns (the
// warpgroup's input channels, channel c at fragment_column(c)) x KC
// (output channels of the piece), K-major in core matrices as the slot
// holds them; float32 the TF32 hi part, then the lo part; zeros past Cin
// and past Cout. One thread per element of w's padded copy.
template <typename T>
__global__ void dcn_exact_bwd_layout_kernel(const T* __restrict__ w,
                                            T* __restrict__ lay, int Cin,
                                            int Cout, int CK, int NW, int KC,
                                            int pieces, int nchunks) {
  constexpr int PARTS = is_low<T>() ? 1 : 2;
  constexpr int EK = 16 / (int)sizeof(T);
  const int KP = pieces * KC;
  const int CP = nchunks * CK;
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)PARTS * 9 * CP * KP) return;
  const int o = (int)(e % KP);
  int64_t rest = e / KP;
  const int cp = (int)(rest % CP);
  rest /= CP;
  const int t = (int)(rest % 9);
  const int part = (int)(rest / 9);
  const int chunk = cp / CK;
  const int c = cp - chunk * CK;
  const int wg = c / NW;
  const int cl = c - wg * NW;
  const int nl = fragment_column(cl, NW);
  const int pc = o / KC;
  const int k = o - pc * KC;
  const int64_t blob = (((int64_t)pc * nchunks + chunk) * 9 + t) * (CK / NW) +
                       wg;
  const int64_t at = blob * PARTS * NW * KC + (int64_t)part * NW * KC +
                     (nl >> 3) * KC * 8 + (k / EK) * EK * 8 + (nl & 7) * EK +
                     k % EK;
  const float v =
      cp < Cin && o < Cout ? f32(w[((int64_t)t * Cin + cp) * Cout + o]) : 0.f;
  if constexpr (is_low<T>()) {
    lay[at] = from_f32<T>(v);
  } else {
    const float hi = hopper::tf32_rna(v);
    lay[at] = part == 0 ? hi : hopper::tf32_rna(v - hi);
  }
}

// dst[e] = bf16(src[e])
__global__ void dcn_exact_round_kernel(const float* __restrict__ src,
                                       bf16* __restrict__ dst,
                                       int64_t count) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < count) dst[e] = __float2bfloat16_rn(src[e]);
}

template <typename T, int CK, int NWG, bool COUNT, bool FAST>
int launch_data_instance(const DataArgs<T>& a, dim3 grid, int smem,
                         cudaStream_t s) {
  static int smem_set = 0;  // the dynamic shared memory allowed so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dcn_exact_bwd_data_kernel<T, CK, NWG, COUNT, FAST>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  dcn_exact_bwd_data_kernel<T, CK, NWG, COUNT, FAST>
      <<<grid, 128 * NWG, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int CK, int NWG, bool COUNT>
int launch_data_counted(const DataArgs<T>& a, dim3 grid, int smem,
                        cudaStream_t s) {
  if (a.pieces == 1)
    return launch_data_instance<T, CK, NWG, COUNT, true>(a, grid, smem, s);
  return launch_data_instance<T, CK, NWG, COUNT, false>(a, grid, smem, s);
}

template <typename T, int CK, int NWG>
int launch_data_kernel(const DataArgs<T>& a, dim3 grid, int smem,
                       cudaStream_t s) {
  if (a.reductions)
    return launch_data_counted<T, CK, NWG, true>(a, grid, smem, s);
  return launch_data_counted<T, CK, NWG, false>(a, grid, smem, s);
}

// The plan's checks, the weight slices' layout, the launch, the split
// partials' sum and (bf16) grad x's rounding: see the extern "C"
// launchers below.
template <typename T>
int launch_data(DataArgs<T> a, T* wlay, T* grad_x, int B, int H, int W,
                int Cin, int Cout, int tile_h, int tile_w, int chunk,
                int warpgroups, int k_tile, int window_slots,
                int box_capacity, int splits, int smem, cudaStream_t s) {
  constexpr bool LOW = is_low<T>();
  const int64_t npix = (int64_t)B * H * W;
  if (B < 0 || H < 0 || W < 0 || Cin < 0 || Cout < 0 || npix > 0x7fffffff ||
      H > 32766 || W > 32766)
    return (int)cudaErrorInvalidValue;
  if (npix == 0 || Cin == 0) return (int)cudaSuccess;
  const int ka = LOW ? 16 : 8;  // the K of a G piece is a multiple of it
  const int want_kc = Cout == 0 ? ka
                      : Cout <= MAX_KC ? (Cout + ka - 1) / ka * ka
                                       : MAX_KC;
  const int nchunks = (Cin + chunk - 1) / (chunk > 0 ? chunk : 1);
  const int nsteps = 9 * nchunks;
  const bool plan_ok =
      LOW ? (chunk == 64 && warpgroups == 2) || (chunk == 32 && warpgroups == 1)
          : (chunk == 32 && warpgroups == 2) ||
                (chunk == 16 && warpgroups == 2) ||
                (chunk == 8 && warpgroups == 1);
  if (!plan_ok || tile_h != TH || tile_w != TW || k_tile != want_kc ||
      (window_slots != 1 && window_slots != 2) || box_capacity < 1 ||
      splits < 1 || splits > nsteps || splits > 65535 ||
      smem != data_smem_bytes<T>(k_tile, chunk, window_slots, box_capacity) ||
      smem > 232448 || wlay == nullptr ||
      (splits > 1 && a.partial == nullptr) || a.grad_acc == nullptr)
    return (int)cudaErrorInvalidValue;
  a.wlay = reinterpret_cast<const unsigned char*>(wlay);
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
  a.ws = window_slots;
  a.cap = box_capacity;
  const int threads = 256;
  const int64_t count = (LOW ? 1 : 2) * (int64_t)nsteps * chunk * a.KP;
  dcn_exact_bwd_layout_kernel<T>
      <<<(unsigned)((count + threads - 1) / threads), threads, 0, s>>>(
          a.weight, wlay, Cin, Cout, chunk, chunk / warpgroups, k_tile,
          a.pieces, nchunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
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
    const int64_t cells = npix * Cin;
    dcn_exact_round_kernel<<<(unsigned)((cells + threads - 1) / threads),
                             threads, 0, s>>>(a.grad_acc, grad_x, cells);
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
// window_slots (1 or 2), box_capacity, splits and the dynamic shared
// memory. grad_x must be zero-filled by the caller (the blocks add into
// it with atomics); `wlayout` holds the plan's weight_layout floats of
// scratch (the weight slices laid out for the slots, TF32 hi and lo);
// `partial` holds splits * B * H * W * 27 floats when splits > 1 and may
// be null otherwise; grad_offset (B, H, W, 18) and grad_mask (B, H, W, 9)
// are fully written. H and W are at most 32766.
extern "C" int dcn_exact_bwd_data(const float* x, const float* offset,
                                  const float* mask, const float* weight,
                                  const float* grad_out, float* grad_x,
                                  float* grad_offset, float* grad_mask,
                                  float* partial, float* wlayout,
                                  int* route_counts,
                                  unsigned long long* reductions, int B,
                                  int H, int W, int Cin, int Cout,
                                  int tile_h, int tile_w, int chunk,
                                  int warpgroups, int k_tile,
                                  int window_slots, int box_capacity,
                                  int splits, int smem, void* stream) {
  DataArgs<float> a{};
  a.x = x;
  a.offset = offset;
  a.mask = mask;
  a.weight = weight;
  a.grad_out = grad_out;
  a.grad_acc = grad_x;
  a.grad_offset = grad_offset;
  a.grad_mask = grad_mask;
  a.partial = partial;
  a.route_counts = route_counts;
  a.reductions = reductions;
  return launch_data(a, wlayout, grad_x, B, H, W, Cin, Cout, tile_h, tile_w,
                     chunk, warpgroups, k_tile, window_slots, box_capacity,
                     splits, smem, (cudaStream_t)stream);
}

// The same at bfloat16 (ops/dcn.exact_bwd_data_bf16_plan: chunk 64 and two
// warpgroups or 32 and one, k_tile Cout padded to 16 up to 256): grad x
// is summed in `grad_acc` (B * H * W * Cin floats, zero-filled by the
// caller) and rounded once into grad_x; `wlayout` holds the bf16 weight
// slices laid out for the slots (the plan's weight_layout floats).
extern "C" int dcn_exact_bwd_data_bf16(
    const bf16* x, const bf16* offset, const bf16* mask, const bf16* weight,
    const bf16* grad_out, float* grad_acc, bf16* grad_x, bf16* grad_offset,
    bf16* grad_mask, float* partial, bf16* wlayout, int* route_counts,
    unsigned long long* reductions, int B, int H, int W, int Cin, int Cout,
    int tile_h, int tile_w, int chunk, int warpgroups, int k_tile,
    int window_slots, int box_capacity, int splits, int smem, void* stream) {
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
  return launch_data(a, wlayout, grad_x, B, H, W, Cin, Cout, tile_h, tile_w,
                     chunk, warpgroups, k_tile, window_slots, box_capacity,
                     splits, smem, (cudaStream_t)stream);
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
