// Clamped-offset modulated 3x3 deformable convolution, forward, float32,
// with the contraction on the tensor cores in 3xTF32, for Hopper (sm_90a).
//
// Computes, for every output pixel p = (b, y, x) and output channel o,
//
//   out[p, o] = bias[o] + sum_t sum_c  m_t(p) * S_t(p, c) * w[t, c, o]
//
// where tap t = 3*i + j sits at (i - 1, j - 1), its offset (dy, dx) =
// offset[p, 2t], offset[p, 2t + 1] is clipped to [-R, R], m_t = mask[p, t],
// and S_t is the exact bilinear sample of x at
// (y + i - 1 + dy, x + j - 1 + dx), with zeros outside the map. Stride 1,
// dilation 1. Layouts are the JAX package's: x (B, H, W, Cin),
// offset (B, H, W, 18) interleaved (dy, dx) per tap with taps row-major,
// mask (B, H, W, 9), w (3, 3, Cin, Cout), out (B, H, W, Cout), all
// contiguous float32.
//
// Replaces the forward of the four Pallas TPU kernels that compute this
// function: centertrack_tpu/ops/dcn_pallas.py deform_conv2d_pallas,
// ops/dcn_pallas_grid.py deform_conv2d_pallas_grid,
// ops/dcn_pallas_shift.py deform_conv2d_local_pallas and
// ops/dcn_pallas_halo.py deform_conv2d_local_halo (whose haloed window
// this kernel keeps in shared memory). The backward is dcn_local_bwd.cu.
//
// Precision. The contraction runs on the tensor cores in TF32 three times
// ("3xTF32"): each operand v is split into hi = tf32(v) and lo =
// tf32(v - hi), and hi*hi + hi*lo + lo*hi is summed in float32, which
// keeps each product to ~2^-21 of its size, float32's own rounding; a
// single TF32 pass (~2^-11) would not hold float32 results. The samples
// are formed in float32 on the CUDA cores.
//
// What bounds it on the H100: the contraction, 2 * 9 * Cin * Cout
// operations per pixel three times at the dense TF32 tensor-core peak
// (494.7 TFLOP/s), and the sampling, about 8 * 9 * Cin float32
// operations per pixel at the float32 peak (67 TFLOP/s), against
// 4 * (Cin + 27 + Cout) bytes per pixel at 3.35 TB/s: at every DLA-34
// neck shape the operations take longer (chip_smoke.py
// dcn_bound_ms_3xtf32; dcn_bound_ms is the same work at the float32
// peak, the bound of a kernel on the CUDA cores). In practice the
// sampling's shared-memory traffic, the latency of its inputs and
// enough blocks to fill 132 SMs decide the time.
//
// What the design does about it. A block (two warpgroups, 256 threads)
// takes a 4 x 16 tile of output pixels of one image, the 64 rows of a
// wgmma M tile, and up to 256 output channels, half of them per
// warpgroup, so each sample is built once per pixel for all of Cout at
// the neck, by twice the warps one warpgroup would give to hide its
// latency. Its K loop runs over steps (Cin chunk of 32, tap),
// chunk-major, and is software-pipelined:
//   - the chunk's x window, the tile with a halo of R + 1 on every side
//     (every corner a clamped offset can reach), is copied global ->
//     shared by cp.async, zero-filled outside the map and past Cin: into
//     the second of two window slots a whole chunk ahead where shared
//     memory allows it without costing a resident block, else into the
//     one slot once the chunk's last A is built. The step's weight
//     slice, hi and lo, goes into one of two weight slots. The weight is
//     split and laid K-major once per call by a small kernel into a
//     scratch (`wsplit`, (2, 9, Cout padded, Cin padded)), since TF32
//     wgmma reads B K-major only and w is Cout-contiguous.
//   - the block builds A_s (64 pixels x 32 channels) in float32 from the
//     window, 4 channels of one pixel per thread and item, from a corner
//     table (window index, hat weight wy*wx times the mask) computed
//     once per block, and writes its hi and lo parts in the interleaved
//     wgmma layout into one of two A slots, while the product of step
//     s - 1 still runs on the tensor cores.
//   - three wgmma m64nNk8 per 8 channels and N tile (N = 32 or 64) of
//     each warpgroup accumulate in float32 registers; the block then
//     waits for the product of step s - 1 only, and refills its weight
//     slot with step s + 1's slice.
// Small maps split the K loop over blocks (`splits`, chosen by
// ops/dcn.fwd_fp32_plan for the fewest waves of blocks at two or more
// blocks per SM): each split writes a float32 partial tile, and a second
// kernel sums the partials in split order and adds the bias once. The
// window's 16-byte pieces are XOR-swizzled by window position, so the
// eight pixels a quarter-warp samples read eight bank groups.

#include "hopper.cuh"

namespace {

constexpr int TH = 4;          // tile rows
constexpr int TW = 16;         // tile columns
constexpr int TP = TH * TW;    // pixels per block: one wgmma M tile
constexpr int CK = 32;         // input channels per chunk
constexpr int NWG = 2;         // warpgroups
constexpr int NT = 128 * NWG;  // threads
constexpr int MAX_R = 8;       // the largest max_offset planned for
constexpr int PIX_B = CK * 4;  // bytes of one window pixel (8 pieces)
constexpr int A_BYTES = TP * CK * 4;   // one of A's hi and lo parts
constexpr int SBO = (CK / 4) * 128;    // A and B: bytes between 8-row
                                       // groups
constexpr int TABLE_BYTES = 9 * 4 * TP * 2 + 9 * 4 * TP * 4;

// one of the hi and lo parts of one weight slot
__host__ __device__ constexpr int b_bytes(int nb) { return CK * 64 * nb * 4; }

__host__ __device__ constexpr int window_bytes(int R) {
  return (TH + 2 * (R + 1)) * (TW + 2 * (R + 1)) * PIX_B;
}

// two A slots of hi and lo, two weight slots of hi and lo, the window
// slots, the corner table
__host__ __device__ constexpr int smem_bytes(int nb, int R, int slots) {
  return 4 * A_BYTES + 4 * b_bytes(nb) + slots * window_bytes(R) +
         TABLE_BYTES;
}

struct Args {
  const float* x;
  const float* offset;
  const float* mask;
  const float* wsplit;
  const float* bias;
  float* out;
  float* partial;
  int64_t npix;
  int H, W, Cin, Cout, R, CinP, CoutP;
  int tiles_x, tiles_y, nsteps, splits, slots;
};

template <int NB>
__global__ void __launch_bounds__(NT) dcn_local_fwd_kernel(const Args a) {
  constexpr int N = 64 * NB;  // output channels per block
  constexpr int NH = N / NWG;  // of each warpgroup
  constexpr int TWID = NH < 64 ? NH : 64;  // its wgmma N
  constexpr int NTW = NH / TWID;           // its wgmma N tiles
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* s_a = smem;                     // [slot][hi, lo]
  unsigned char* s_b = s_a + 4 * A_BYTES;        // [slot][hi, lo]
  unsigned char* s_win = s_b + 4 * b_bytes(NB);  // 1 or 2 slots
  const int h = a.R + 1;
  const int WH = TH + 2 * h;
  const int WW = TW + 2 * h;
  const int win_b = WH * WW * PIX_B;
  // the corner table: [9][4][TP] window indices and weights
  int16_t* t_idx = reinterpret_cast<int16_t*>(s_win + a.slots * win_b);
  float* t_w = reinterpret_cast<float*>(t_idx + 9 * 4 * TP);

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
  const bool x_al = Cin % 4 == 0 && hopper::aligned16(a.x);

  // the corner table of every (tap, pixel): window index of each corner
  // (clamped into the window; a corner past it has weight 0) and its
  // weight wy * wx * m; 0 for pixels past the map
  for (int e = tid; e < 9 * TP; e += NT) {
    const int t = e / TP;
    const int p = e - t * TP;
    const int py = p / TW;
    const int px = p - py * TW;
    const int y = y0 + py;
    const int xx = x0 + px;
    int idx[4] = {0, 0, 0, 0};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    if (y < H && xx < W) {
      const int64_t n = ((int64_t)b * H + y) * W + xx;
      const float* o = a.offset + n * 18;
      const float dy = fminf(fmaxf(o[2 * t], -R), R);
      const float dx = fminf(fmaxf(o[2 * t + 1], -R), R);
      const float m = a.mask[n * 9 + t];
      const float vy = (float)(t / 3 - 1) + dy;
      const float vx = (float)(t % 3 - 1) + dx;
      const float fy = floorf(vy);
      const float fx = floorf(vx);
      const float ly = vy - fy;
      const float lx = vx - fx;
      const float wy[2] = {1.f - ly, ly};
      const float wx[2] = {1.f - lx, lx};
      const int r0 = py + h + (int)fy;  // >= 0: fy >= -1 - R
      const int c0 = px + h + (int)fx;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          idx[2 * i + j] = min(r0 + i, WH - 1) * WW + min(c0 + j, WW - 1);
          wt[2 * i + j] = wy[i] * wx[j] * m;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      t_idx[(t * 4 + k) * TP + p] = (int16_t)idx[k];
      t_w[(t * 4 + k) * TP + p] = wt[k];
    }
  }

  // the x window of a Cin chunk into its window slot
  const auto load_window = [&](int chunk) {
    const int c0 = chunk * CK;
    unsigned char* dst = s_win + (a.slots == 2 ? (chunk & 1) * win_b : 0);
    for (int e = tid; e < WH * WW * 8; e += NT) {
      const int pos = e >> 3;
      const int q = e & 7;
      const int wr = pos / WW;
      const int yy = y0 - h + wr;
      const int xc = x0 - h + (pos - wr * WW);
      const int ch = c0 + 4 * q;
      const bool in = yy >= 0 && yy < H && xc >= 0 && xc < W;
      const float* src =
          in ? a.x + (((int64_t)b * H + yy) * W + xc) * Cin + ch : a.x;
      hopper::copy4(dst + pos * PIX_B + ((q ^ (pos & 7)) << 4), src,
                    in ? Cin - ch : 0, x_al);
    }
  };
  // step s's weight slice, hi and lo, K-major, into weight slot `slot`;
  // the padded split weight needs no bounds
  const auto load_weights = [&](int s, int slot) {
    const int chunk = s / 9;
    const int t = s - 9 * chunk;
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
  // The x window of the next chunk is copied as early as its slot is
  // free: at the first step of a chunk with two window slots, after the
  // last step's A with one.
#pragma unroll
  for (int nb = 0; nb < NTW; ++nb) hopper::fence_acc(acc[nb]);
  DCN_PHASES_BEGIN;  // phase 0: the chunk's window wait (one slot)
  load_window(s_begin / 9);
  load_weights(s_begin, 0);
  hopper::cp_async_commit();
  for (int s = s_begin; s < s_end; ++s) {
    const int i = s - s_begin;
    const int chunk = s / 9;
    const int t = s - 9 * chunk;
    const bool first = s == s_begin || t == 0;  // of its chunk here
    const bool next_window =
        (chunk + 1) * 9 < s_end && (a.slots == 2 ? first : t == 8);
    // the window was copied after step s - 1's A (one slot), or by this
    // split's first step (its chunk's only step here); else it was waited
    // for at a barrier before a product of the previous chunk
    if (s == s_begin || (first && (a.slots == 1 || s - 1 == s_begin))) {
      hopper::cp_async_wait_all();
      hopper::fence_async_shared();
      __syncthreads();  // the window (and the table) visible
    }
    DCN_PHASE(0);

    // A_s = m * S_t, 4 channels of one pixel per item, into A slot i & 1
    const unsigned char* win =
        s_win + (a.slots == 2 ? (chunk & 1) * win_b : 0);
    unsigned char* s_ai = s_a + (i & 1) * 2 * A_BYTES;
    const int p = tid & (TP - 1);
    int pos[4];
    float wk[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      pos[k] = t_idx[(t * 4 + k) * TP + p];
      wk[k] = t_w[(t * 4 + k) * TP + p];
    }
#pragma unroll
    for (int it = 0; it < TP * 8 / NT; ++it) {
      const int q = tid / TP + (NT / TP) * it;  // channel quartet
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 c = *reinterpret_cast<const float4*>(
            win + pos[k] * PIX_B + ((q ^ (pos[k] & 7)) << 4));
        v.x = fmaf(c.x, wk[k], v.x);
        v.y = fmaf(c.y, wk[k], v.y);
        v.z = fmaf(c.z, wk[k], v.z);
        v.w = fmaf(c.w, wk[k], v.w);
      }
      const float4 hi = hopper::tf32_hi(v);
      const int at = (p >> 3) * SBO + q * 128 + (p & 7) * 16;
      *reinterpret_cast<float4*>(s_ai + at) = hi;
      *reinterpret_cast<float4*>(s_ai + A_BYTES + at) =
          hopper::tf32_lo(v, hi);
    }
    DCN_PHASE(1);     // phase 1: building A_s
    hopper::cp_async_wait_all();
    hopper::fence_async_shared();
    __syncthreads();  // A_s and step s's weights visible
    DCN_PHASE(2);     // phase 2: copy wait and barrier

    // this warpgroup's NH columns of the weight slot; the accumulators
    // are touched by nothing but the products until the loop ends, so
    // product s queues behind product s - 1 without a wait
    const unsigned char* bslot =
        s_b + 2 * (i & 1) * b_bytes(NB) + wg * (NH / 8) * SBO;
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < CK / 8; ++ks) {
      const uint64_t a_hi = hopper::desc(s_ai + ks * 256, 128, SBO);
      const uint64_t a_lo = hopper::desc(s_ai + A_BYTES + ks * 256, 128, SBO);
#pragma unroll
      for (int nb = 0; nb < NTW; ++nb) {
        const unsigned char* bt = bslot + nb * (TWID / 8) * SBO + ks * 256;
        hopper::wgmma_3xtf32<TWID>(acc[nb], a_hi, a_lo,
                                   hopper::desc(bt, 128, SBO),
                                   hopper::desc(bt + b_bytes(NB), 128, SBO));
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
    DCN_PHASE(3);     // phase 3: the product issued, the last one waited
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
    const int p = 16 * warp + lane / 4 + 8 * hh;
    const int y = y0 + p / TW;
    const int xx = x0 + p % TW;
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
        float* dst;
        if (a.splits > 1) {
          // float32 partial of this split, summed by the reduce kernel
          dst = a.partial + ((int64_t)split * a.npix + n) * Cout + o;
        } else {
          if (a.bias) {
            v0 += a.bias[o];
            if (two) v1 += a.bias[o + 1];
          }
          dst = a.out + n * Cout + o;
        }
        if (two && pairs) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (two) dst[1] = v1;
        }
      }
    }
  }
}

// out[n, o] = sum over the splits of partial[s, n, o], in split order,
// + bias[o]
__global__ void dcn_local_fwd_reduce_kernel(const float* __restrict__ partial,
                                            const float* __restrict__ bias,
                                            float* __restrict__ out,
                                            int64_t count, int Cout,
                                            int splits) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float v = 0.f;
  for (int k = 0; k < splits; ++k) v += partial[(int64_t)k * count + e];
  if (bias) v += bias[e % Cout];
  out[e] = v;
}

// wsplit[hl][t][n][c] = the hi (hl = 0) or lo (1) TF32 part of w[t][c][n],
// 0 past Cin or Cout: w transposed to K-major by 32 x 32 tiles of shared
// memory, (CoutP, CinP) per tap
__global__ void dcn_local_fwd_split_weight_kernel(
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

template <int NB>
int launch(const Args& a, int B, int col_tiles, int smem,
           cudaStream_t stream) {
  static int smem_set = 0;  // the dynamic shared memory allowed so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        dcn_local_fwd_kernel<NB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const dim3 grid(B * a.tiles_y * a.tiles_x, col_tiles, a.splits);
  dcn_local_fwd_kernel<NB><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan (ops/dcn.fwd_fp32_plan) comes in as tile_h, tile_w, chunk,
// n_tile (output channels per block: 64, 128 or 256), window_slots (1 or
// 2), splits and the dynamic shared memory in bytes; each is checked
// against this file's constants and the shapes, and a mismatch returns
// cudaErrorInvalidValue before any launch; so does R past 8. `wsplit`
// holds 2 * 9 * CoutP * CinP floats of scratch (CinP = Cin rounded up to
// the chunk, CoutP = Cout rounded up to n_tile); `partial` holds
// splits * B * H * W * Cout floats when splits > 1 and may be null
// otherwise; `bias` may be null. Launches on `stream`, allocates nothing,
// does not synchronise, and returns cudaGetLastError() as an int.
extern "C" int dcn_local_fwd(const float* x, const float* offset,
                             const float* mask, const float* weight,
                             const float* bias, float* out, float* partial,
                             float* wsplit, int B, int H, int W, int Cin,
                             int Cout, int R, int tile_h, int tile_w,
                             int chunk, int n_tile, int window_slots,
                             int splits, int smem, void* stream) {
  const int npix = B * H * W;
  if (npix <= 0 || Cout <= 0) return (int)cudaSuccess;
  const int nb = n_tile / 64;
  const int nchunks = (Cin + CK - 1) / CK;
  const int nsteps = 9 * (nchunks > 0 ? nchunks : 1);
  if (tile_h != TH || tile_w != TW || chunk != CK || R < 1 || R > MAX_R ||
      (nb != 1 && nb != 2 && nb != 4) || n_tile != 64 * nb ||
      (window_slots != 1 && window_slots != 2) || splits < 1 ||
      splits > nsteps || smem != smem_bytes(nb, R, window_slots) ||
      wsplit == nullptr || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const int col_tiles = (Cout + n_tile - 1) / n_tile;
  const int CinP = (nsteps / 9) * CK;
  const int CoutP = col_tiles * n_tile;
  const cudaStream_t s = (cudaStream_t)stream;
  dcn_local_fwd_split_weight_kernel<<<dim3(CoutP / 32, CinP / 32, 9),
                                      dim3(32, 8), 0, s>>>(
      weight, wsplit, Cin, Cout, CinP, CoutP);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  Args a{x, offset, mask, wsplit, bias, out, partial, npix, H, W, Cin, Cout,
         R, CinP, CoutP, (W + TW - 1) / TW, (H + TH - 1) / TH, nsteps,
         splits, window_slots};
  err = nb == 1   ? launch<1>(a, B, col_tiles, smem, s)
        : nb == 2 ? launch<2>(a, B, col_tiles, smem, s)
                  : launch<4>(a, B, col_tiles, smem, s);
  if (err != 0 || splits == 1) return err;
  const int64_t count = (int64_t)npix * Cout;
  const int threads = 256;
  dcn_local_fwd_reduce_kernel<<<(unsigned)((count + threads - 1) / threads),
                                threads, 0, s>>>(partial, bias, out, count,
                                                 Cout, splits);
  return (int)cudaGetLastError();
}

// The gather route, `dcn_local_fwd_gather`: the planner's choice
// (ops/dcn.fwd_fp32_plan route "gather") where the window design above
// does not take the call, for max_offset past 8 (MAX_R). It is the first
// design of this kernel, from before the window design, and takes every
// R and every width. A block takes 64 consecutive output pixels by 64
// output channels and keeps the sum in registers (4 x 4 per thread, on
// the CUDA cores). The four corners of every (pixel, tap), their flat
// pixel index and their hat weight times the mask, are computed once per
// block into shared memory; for each tap and chunk of 32 input channels
// the block gathers the modulated sample of its pixels straight from x in
// global memory (32 consecutive channels of a corner pixel: coalesced)
// beside the tap's weight slice, and every thread runs 32 x 16 FMAs from
// shared memory. What bounds it is what bounds the window design (the
// operations: chip_smoke.py dcn_bound_ms_3xtf32, or dcn_bound_ms for the
// same work on the CUDA cores, where this route runs); in practice the
// corner gathers' latency and the CUDA cores' float32 rate decide its
// time (5.47 ms per 544 x 960 image at R=1 on an H100 when it was the
// path's kernel).
// No path launches it.
namespace {
namespace gather {

constexpr int TP = 64;    // output pixels per block
constexpr int TC = 64;    // output channels per block
constexpr int CK = 32;    // input channels per shared-memory chunk
constexpr int NT = 256;   // threads: 16 pixel rows x 16 channel columns

__global__ void __launch_bounds__(NT)
dcn_local_fwd_gather_kernel(const float* __restrict__ x,
                            const float* __restrict__ offset,
                            const float* __restrict__ mask,
                            const float* __restrict__ weight,
                            const float* __restrict__ bias,
                            float* __restrict__ out, int npix, int H, int W,
                            int Cin, int Cout, float R) {
  __shared__ int corner_idx[9][4][TP];    // flat pixel index of each corner
  __shared__ float corner_w[9][4][TP];    // hat weight x mask, 0 outside
  __shared__ float s_sample[CK][TP + 1];  // +1: conflict-free column writes
  __shared__ float s_weight[CK][TC];

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * TP;
  const int o0 = blockIdx.y * TC;
  const int HW = H * W;

  for (int e = tid; e < 9 * TP; e += NT) {
    const int t = e / TP;
    const int p = e - t * TP;
    const int n = p0 + p;
    int idx[4] = {0, 0, 0, 0};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    if (n < npix) {
      const int b = n / HW;
      const int rem = n - b * HW;
      const int y = rem / W;
      const int xx = rem - y * W;
      const float* o = offset + (int64_t)n * 18;
      const float dy = fminf(fmaxf(o[2 * t], -R), R);
      const float dx = fminf(fmaxf(o[2 * t + 1], -R), R);
      const float m = mask[(int64_t)n * 9 + t];
      // the tap-relative position and its hat weights, as the plain
      // version forms max(0, 1 - |(t + d) - a|)
      const float vy = (float)(t / 3 - 1) + dy;
      const float vx = (float)(t % 3 - 1) + dx;
      const float fy = floorf(vy);
      const float fx = floorf(vx);
      const float wy[2] = {1.f - fabsf(vy - fy), 1.f - fabsf(vy - (fy + 1.f))};
      const float wx[2] = {1.f - fabsf(vx - fx), 1.f - fabsf(vx - (fx + 1.f))};
      const int y0 = y + (int)fy;
      const int x0 = xx + (int)fx;
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
      corner_idx[t][k][p] = idx[k];
      corner_w[t][k][p] = wt[k];
    }
  }

  const int tx = tid % 16;  // output channels tx + 16 j
  const int ty = tid / 16;  // output pixels ty + 16 i
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int t = 0; t < 9; ++t) {
    const float* wtap = weight + (int64_t)t * Cin * Cout;
    for (int c0 = 0; c0 < Cin; c0 += CK) {
      __syncthreads();  // previous chunk fully consumed (and corners ready)
      for (int e = tid; e < CK * TP; e += NT) {
        const int c = e % CK;
        const int p = e / CK;
        float v = 0.f;
        if (c0 + c < Cin) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float wk = corner_w[t][k][p];
            if (wk != 0.f)
              v = fmaf(wk, x[(int64_t)corner_idx[t][k][p] * Cin + c0 + c], v);
          }
        }
        s_sample[c][p] = v;
      }
      for (int e = tid; e < CK * TC; e += NT) {
        const int o = e % TC;
        const int c = e / TC;
        s_weight[c][o] = (c0 + c < Cin && o0 + o < Cout)
                             ? wtap[(int64_t)(c0 + c) * Cout + o0 + o]
                             : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < CK; ++c) {
        float a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s_sample[c][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = s_weight[c][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = p0 + ty + 16 * i;
    if (n >= npix) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx + 16 * j;
      if (o < Cout)
        out[(int64_t)n * Cout + o] = acc[i][j] + (bias ? bias[o] : 0.f);
    }
  }
}

}  // namespace gather
}  // namespace

// The gather route: any R >= 1 and any Cin, Cout; out (B, H, W, Cout) is
// fully written; `bias` may be null. Launches on `stream`, allocates
// nothing, does not synchronise, and returns cudaGetLastError() as an
// int; R < 1 or a map past 2^31 pixels returns cudaErrorInvalidValue.
extern "C" int dcn_local_fwd_gather(const float* x, const float* offset,
                                    const float* mask, const float* weight,
                                    const float* bias, float* out, int B,
                                    int H, int W, int Cin, int Cout, int R,
                                    void* stream) {
  const int64_t npix = (int64_t)B * H * W;
  if (npix <= 0 || Cout <= 0) return (int)cudaSuccess;
  if (R < 1 || Cin < 0 || npix > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((npix + gather::TP - 1) / gather::TP),
                  (Cout + gather::TC - 1) / gather::TC);
  gather::dcn_local_fwd_gather_kernel<<<grid, gather::NT, 0,
                                        (cudaStream_t)stream>>>(
      x, offset, mask, weight, bias, out, (int)npix, H, W, Cin, Cout,
      (float)R);
  return (int)cudaGetLastError();
}
