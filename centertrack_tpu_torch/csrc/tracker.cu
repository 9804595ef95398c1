// The serving step's two tracker kernels for Hopper (sm_90a), with a
// leading stream axis. Neither has a Pallas counterpart: the JAX package
// runs both as XLA loops inside its one compiled frame program. The port
// needs a kernel for each so that a frame reads nothing back to the host
// and the whole step can be captured in one CUDA graph.
//
//   greedy_assign  the row-ordered greedy argmin of JAX
//                  engine/device_tracker.greedy_assign (a K-step
//                  lax.fori_loop): dist (S, K, T) float32, invalid
//                  entries >= 1e18 -> match (S, K) int32, -1 for none.
//   splat_pre_hm   the max-composited gaussian splats of JAX
//                  ops/gaussian.render_pre_hm(compact=True) on maps past
//                  128 x 128 (a lax.while_loop over the live slots):
//                  cts (S, T, 2) int32, radii (S, T) int32, ks (S, T)
//                  float32, valid (S, T) bool -> canvas (S, H, W) float32.
//
// greedy_assign. Row i takes the first minimal column among the columns
// no earlier row took (a taken column reads as 1e18), if that minimum is
// below 1e16; a NaN among its untaken columns wins JAX's argmin, so such
// a row matches nothing and takes nothing. It moves 4 * S * K * T bytes
// (100 KB a frame at K = 100, T = 256), 0.03 us at 3.35 TB/s, but its
// rows are a chain (a row may take the column the next row wanted), so
// the chain's latency bounds it: one dependent step per live row. Most
// rows cannot match (a detection under the output threshold has a row of
// 1e18) and most live rows find their best column free, so the design
// takes everything that does not depend on the chain off it. One block
// per stream, which first copies the stream's rows into shared memory
// by cp.async, every copy in flight at once (one latency, not one per
// row), then:
//   1. parallel pass: the block's warps split the rows; a warp reads a
//      row (lane l takes columns l + 32 c) and writes to shared memory
//      whether the row is live (an entry below 1e16, or a NaN), how many
//      entries it has below 1e16, whether it holds a NaN, and its first
//      C = 4 candidate columns in (value, column) order among the entries
//      below 1e16 (C rounds of two warp min-reductions on an
//      order-preserving integer key of the value and on the column). A
//      dead row (every entry >= 1e16: most rows) costs one test, 16 bytes
//      a lane, gets -1 at once and is never visited again.
//   2. serial pass: one warp takes the live rows 32 at a time (lane l,
//      row 32 g + l), the taken columns a bit mask in shared memory. A
//      row's match is its first candidate not taken, and one round
//      settles many rows at once: every pending row proposes its first
//      free candidate, and the rows before the first one whose proposal
//      an earlier row of the round also made, or that needs a rescan,
//      are settled together (distinct proposals, each its row's first
//      free candidate, are what the rows one by one would take). The
//      path's ~10 live rows take a round or two, not a chain of 10
//      warp reductions. When every candidate is taken and the row has
//      more than C entries below 1e16, or when it holds a NaN (a NaN in
//      a taken column does not count), the warp rescans the row, from
//      shared memory, against the taken columns, as one warp per stream
//      did for every row before (the first design of this kernel).
//   Rows go through the copy and both passes in chunks of as many rows
//   as 200 KB of shared memory holds (all 100 at T = 256, 49 at T =
//   1024; at most 1024), so any K fits; the taken mask carries over.
//   Nothing is allocated; the result is JAX's, bit for bit, by
//   construction (the same lexicographic order).
//
// splat_pre_hm writes the canvas once (2 MB a frame at 544 x 960): bound
// by bytes, 0.6 us. A block owns a 16 x 128 tile of one stream's canvas:
// it reads that stream's slots into shared memory, keeps those that are
// valid and whose clipped box meets the tile (with each slot's sigma term
// and k), and each thread writes each of its 8 pixels once, the max over
// the kept slots of k * exp(-q / (2 sigma^2 + 1e-12)) or 0, four pixels
// a 16-byte store where the row allows it. No memset and no atomics: one
// graph node per call, and a max is exact in any order, so the canvas is
// deterministic by construction.
//
// Arithmetic follows the JAX formulas operation by operation in float32
// (explicitly rounded, so the compiler fuses nothing into an FMA); exp is
// CUDA's expf, within 2 ulps of the CPU's. Each launcher takes device
// pointers and the stream, allocates nothing, does not synchronise, and
// returns cudaGetLastError() as an int (0 = ok); shapes the kernels do
// not take return cudaErrorInvalidValue before any launch.

#include <cuda_runtime.h>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kMatch = 1e16f;  // a row matches below this
constexpr int kCands = 4;        // candidate columns kept per row (2^n)
constexpr unsigned kNoKey = 0xffffffffu;

// An unsigned key whose order is the float order of v (v not NaN), with
// -0 read as +0 as a float comparison reads it.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v == 0.f ? 0.f : v);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

// Lane l's columns l + 32 c of one row (0 past T).
template <int COLS>
__device__ __forceinline__ void load_row(const float* row, int T, int lane,
                                         float (&v)[COLS]) {
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int j = lane + 32 * c;
    v[c] = j < T ? row[j] : 0.f;
  }
}

// The least key of k[c] over c, and its c (ties to the smaller c, the
// smaller column): a tree of depth log2(COLS) rather than a chain.
template <int COLS>
__device__ __forceinline__ void lane_min(const unsigned (&k)[COLS],
                                         unsigned& key, int& at) {
  unsigned kk[COLS];
  int cc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    kk[c] = k[c];
    cc[c] = c;
  }
#pragma unroll
  for (int w = 1; w < COLS; w *= 2) {
#pragma unroll
    for (int c = 0; c + w < COLS; c += 2 * w) {
      if (kk[c + w] < kk[c]) {
        kk[c] = kk[c + w];
        cc[c] = cc[c + w];
      }
    }
  }
  key = kk[0];
  at = cc[0];
}

// The JAX argmin of one row (lane l holding columns l + 32 c in v)
// against the taken bits (bit c of lane l: column l + 32 c), for the
// warp: the first minimal untaken column if that minimum is below 1e16
// and no untaken column holds a NaN, else -1.
template <int COLS>
__device__ int rescan_row(const float (&v)[COLS], int T, unsigned taken,
                          int lane) {
  unsigned key[COLS];
  bool nan = false;
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const bool open = lane + 32 * c < T && !((taken >> c) & 1u);
    nan |= open && v[c] != v[c];
    key[c] = open && v[c] < kMatch ? order_key(v[c]) : kNoKey;
  }
  if (__any_sync(kFull, nan)) return -1;
  unsigned best;
  int at;
  lane_min<COLS>(key, best, at);
  const unsigned least = __reduce_min_sync(kFull, best);
  if (least == kNoKey) return -1;
  return (int)__reduce_min_sync(
      kFull, best == least ? (unsigned)(lane + 32 * at) : kNoKey);
}

// The warp rescans one row (in shared memory) against the taken columns
// (bit b of word w: column 32 w + b), writes its match to *out and takes
// the column.
template <int COLS>
__device__ __forceinline__ void rescan_into(const float* row, int T,
                                            unsigned* s_taken, int lane,
                                            int* out) {
  float v[COLS];
  load_row<COLS>(row, T, lane, v);
  unsigned taken = 0;  // bit c: column lane + 32 c
#pragma unroll
  for (int c = 0; c < COLS; ++c) taken |= ((s_taken[c] >> lane) & 1u) << c;
  const int col = rescan_row<COLS>(v, T, taken, lane);
  if (lane == 0) {
    *out = col;
    if (col >= 0) s_taken[col >> 5] |= 1u << (col & 31);
  }
  __syncwarp();
}

// 4 bytes global -> shared (hopper::cp_async16 for aligned rows)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   hopper::smem_addr(dst)),
               "l"(src));
}

// Dynamic shared memory of a chunk of `rows` rows: the rows (float32),
// then per row its state (kDead, kNanRow, or its count of entries below
// 1e16) and its candidates.
constexpr int kDead = -1;    // nothing below 1e16 and no NaN
constexpr int kNanRow = -2;  // holds a NaN: rescanned
__host__ __device__ constexpr size_t greedy_smem(int rows, int T) {
  return (size_t)rows * (4 * T + 4 * (1 + kCands));
}

// One block of NT threads per stream; lane l of a warp owns columns
// l + 32 c, c < COLS (T <= 32 * COLS). The stream's rows go through both
// passes `chunk` rows at a time, each chunk staged in shared memory.
template <int COLS, int NT>
__global__ void __launch_bounds__(NT)
    greedy_assign_kernel(const float* __restrict__ dist,
                         int* __restrict__ match, int K, int T, int chunk) {
  constexpr int NW = NT / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_rows = reinterpret_cast<float*>(smem);
  int* s_cnt = reinterpret_cast<int*>(s_rows + (size_t)chunk * T);
  int* s_cand = s_cnt + chunk;  // kCands a row
  // the taken columns: bit b of word w is column 32 w + b
  __shared__ unsigned s_taken[32];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* d = dist + (size_t)blockIdx.x * K * T;
  int* m = match + (size_t)blockIdx.x * K;
  const bool vec = (T & 3) == 0 && hopper::aligned16(dist);
  if (tid < 32) s_taken[tid] = 0;

  for (int row0 = 0; row0 < K; row0 += chunk) {
    const int rows = min(chunk, K - row0);
    if (row0 > 0) __syncthreads();  // the serial pass is done with s_*

    // the chunk's rows, global -> shared, every copy in flight at once
    const float* src = d + (size_t)row0 * T;
    const int n = rows * T;
    if (vec) {
      for (int e = 4 * tid; e < n; e += 4 * NT)
        hopper::cp_async16(s_rows + e, src + e, 16);
    } else {
      for (int e = tid; e < n; e += NT) cp_async4(s_rows + e, src + e);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait_all();
    __syncthreads();

    // 1. parallel pass
    for (int i = warp; i < rows; i += NW) {
      const float* row = s_rows + (size_t)i * T;
      // most rows are dead: nothing below 1e16 and no NaN, i.e. every
      // entry >= 1e16; they cost this test alone, read 16 bytes a lane
      // where the row allows it
      bool maybe = false;
      if (COLS >= 4 && (T & 3) == 0) {
#pragma unroll
        for (int h = 0; h < COLS / 4; ++h) {
          const int j = 4 * lane + 128 * h;
          if (j < T) {
            const float4 q = *reinterpret_cast<const float4*>(row + j);
            maybe |= !(q.x >= kMatch) || !(q.y >= kMatch) ||
                     !(q.z >= kMatch) || !(q.w >= kMatch);
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          const int j = lane + 32 * c;
          maybe |= j < T && !(row[j] >= kMatch);
        }
      }
      if (!__any_sync(kFull, maybe)) {
        if (lane == 0) {
          s_cnt[i] = kDead;
          m[row0 + i] = -1;
        }
        continue;
      }
      float v[COLS];
      load_row<COLS>(row, T, lane, v);
      unsigned key[COLS];
      int count = 0;
      bool nan = false;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const bool in = lane + 32 * c < T;
        nan |= in && v[c] != v[c];
        const bool ok = in && v[c] < kMatch;
        key[c] = ok ? order_key(v[c]) : kNoKey;
        count += ok;
      }
      nan = __any_sync(kFull, nan);
      count = (int)__reduce_add_sync(kFull, (unsigned)count);
      if (lane == 0) s_cnt[i] = nan ? kNanRow : count;
      if (nan) continue;  // the serial pass rescans it
      const int want = min(count, kCands);
      for (int k = 0; k < want; ++k) {
        unsigned lk;
        int lc;
        lane_min<COLS>(key, lk, lc);
        const unsigned least = __reduce_min_sync(kFull, lk);
        const unsigned col = __reduce_min_sync(
            kFull, lk == least ? (unsigned)(lane + 32 * lc) : kNoKey);
        // the candidate's key leaves its owner's set
        if ((int)(col & 31) == lane) {
#pragma unroll
          for (int c = 0; c < COLS; ++c)
            if (c == (int)(col >> 5)) key[c] = kNoKey;
        }
        if (lane == 0) s_cand[kCands * i + k] = (int)col;
      }
    }
    __syncthreads();

    // 2. serial pass over the live rows, in order, by one warp, 32 rows
    // (a group) at a time, lane l on row 32 g + l. A round settles a
    // prefix of the group's pending rows at once: each proposes its
    // first candidate not yet taken; the rows before the first one whose
    // proposal an earlier row of the round also made, or that needs a
    // rescan, are settled (distinct proposals, each a row's first free
    // candidate, give what the rows one by one give). A row that needs
    // its rescan is then rescanned alone against the taken columns.
    if (warp == 0) {
      const unsigned below = (1u << lane) - 1;  // the lanes before this
      for (int base = 0; base < rows; base += 32) {
        const int r = base + lane;
        const int state = r < rows ? s_cnt[r] : kDead;
        int cand[kCands];
#pragma unroll
        for (int k = 0; k < kCands; ++k)
          cand[k] = k < state ? s_cand[kCands * r + k] : -1;
        unsigned pending = __ballot_sync(kFull, state != kDead);
        while (pending) {
          const bool mine = (pending >> lane) & 1u;
          int prop = -1;  // the first candidate not taken
          bool rescan = state == kNanRow;
          if (mine && !rescan) {
#pragma unroll
            for (int k = kCands - 1; k >= 0; --k) {
              const int j = cand[k];
              if (j >= 0 && !((s_taken[j >> 5] >> (j & 31)) & 1u)) prop = j;
            }
            rescan = prop < 0 && state > kCands;
          }
          // the first pending row needs its rescan: nothing to settle
          // before it
          const int first = __ffs(pending) - 1;
          if (__shfl_sync(kFull, rescan, first)) {
            rescan_into<COLS>(s_rows + (size_t)(base + first) * T, T,
                              s_taken, lane, m + row0 + base + first);
            pending &= pending - 1;
            continue;
          }
          // a proposal an earlier pending row of the round also made: the
          // lanes whose proposal agrees with this one on every bit, one
          // ballot a bit (T <= 32 COLS: 5 + log2(COLS) bits)
          const bool proposes = mine && prop >= 0;
          unsigned same = __ballot_sync(kFull, proposes);
#pragma unroll
          for (int b = 0; (1 << b) < 32 * COLS; ++b) {
            const bool bit = (prop >> b) & 1;
            const unsigned on = __ballot_sync(kFull, proposes && bit);
            same &= bit ? on : ~on;
          }
          const bool stop = mine && (rescan || (proposes && (same & below)));
          const unsigned stops = __ballot_sync(kFull, stop);
          const unsigned settled =
              pending & (stops ? (1u << (__ffs(stops) - 1)) - 1 : kFull);
          if ((settled >> lane) & 1u) {
            m[row0 + r] = prop;
            if (prop >= 0) atomicOr(&s_taken[prop >> 5], 1u << (prop & 31));
          }
          pending &= ~settled;
          __syncwarp();
          if (!stops) break;
          const int at = __ffs(stops) - 1;
          if (__shfl_sync(kFull, rescan, at)) {
            rescan_into<COLS>(s_rows + (size_t)(base + at) * T, T, s_taken,
                              lane, m + row0 + base + at);
            pending &= ~(1u << at);
          }
        }
      }
    }
  }
}

// shared memory a greedy_assign block may use for its chunk of rows
constexpr size_t kGreedySmem = 200 * 1024;

template <int COLS>
int launch_greedy(const float* dist, int* match, int S, int K, int T,
                  cudaStream_t stream) {
  // as many warps as registers allow: 64 a thread at 1024 threads
  constexpr int NT = COLS <= 8 ? 1024 : 512;
  static size_t smem_set = 48 * 1024;  // the dynamic shared memory allowed
  // at most 32 groups of 32 rows a chunk, and what shared memory holds
  const int chunk = (int)min((size_t)min(K, 1024),
                             kGreedySmem / greedy_smem(1, T));
  const size_t smem = greedy_smem(chunk, T);
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        greedy_assign_kernel<COLS, NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kGreedySmem);
    if (err != cudaSuccess) return (int)err;
    smem_set = kGreedySmem;
  }
  greedy_assign_kernel<COLS, NT><<<S, NT, smem, stream>>>(dist, match, K, T,
                                                          chunk);
  return (int)cudaGetLastError();
}

constexpr int kSplatThreads = 256;
constexpr int kTileRows = 16;
constexpr int kTileCols = 128;  // 32 threads x 4 pixels
constexpr int kRowsPerPass = kSplatThreads / (kTileCols / 4);

struct Splat {
  int cx, cy, x0, x1, y0, y1;
  float denom, k;
};

__global__ void __launch_bounds__(kSplatThreads)
    splat_pre_hm_kernel(const int* __restrict__ cts,
                        const int* __restrict__ radii,
                        const float* __restrict__ ks,
                        const unsigned char* __restrict__ valid,
                        float* __restrict__ canvas, int T, int H, int W,
                        int tiles_x, int max_radius) {
  __shared__ Splat s_slot[kSplatThreads];
  __shared__ int s_kept;

  const int stream = blockIdx.y;
  const int tx0 = (blockIdx.x % tiles_x) * kTileCols;
  const int ty0 = (blockIdx.x / tiles_x) * kTileRows;
  const int tid = threadIdx.x;
  const int px = tx0 + 4 * (tid % (kTileCols / 4));  // first of 4 pixels
  const int py = ty0 + tid / (kTileCols / 4);         // rows py + 8 q
  float val[kTileRows / kRowsPerPass][4];
#pragma unroll
  for (int q = 0; q < kTileRows / kRowsPerPass; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) val[q][e] = 0.f;
  }

  for (int s0 = 0; s0 < T; s0 += kSplatThreads) {
    if (tid == 0) s_kept = 0;
    __syncthreads();
    // keep the valid slots whose clipped box meets the tile (the slot's
    // fields loaded together, not behind its valid flag)
    const int slot = stream * T + s0 + tid;
    const bool in = s0 + tid < T;
    const bool live = in && valid[slot];
    const int r = in ? min(radii[slot], max_radius) : -1;
    const int cx = in ? cts[2 * slot] : 0, cy = in ? cts[2 * slot + 1] : 0;
    const float k = in ? ks[slot] : 0.f;
    if (live) {
      const int x0 = max(max(cx - r, 0), tx0);
      const int x1 = min(min(cx + r, W - 1), tx0 + kTileCols - 1);
      const int y0 = max(max(cy - r, 0), ty0);
      const int y1 = min(min(cy + r, H - 1), ty0 + kTileRows - 1);
      if (r >= 0 && x0 <= x1 && y0 <= y1) {
        // sigma = (2 r + 1) / 6; exp(-(dx^2 + dy^2) / (2 sigma^2 + 1e-12))
        const float rf = (float)r;
        const float sigma =
            __fdiv_rn(__fadd_rn(__fmul_rn(2.f, rf), 1.f), 6.f);
        const float denom =
            __fadd_rn(__fmul_rn(__fmul_rn(2.f, sigma), sigma), 1e-12f);
        s_slot[atomicAdd(&s_kept, 1)] =
            Splat{cx, cy, x0, x1, y0, y1, denom, k};
      }
    }
    __syncthreads();
    const int kept = s_kept;
    for (int k = 0; k < kept; ++k) {
      const Splat sp = s_slot[k];
#pragma unroll
      for (int q = 0; q < kTileRows / kRowsPerPass; ++q) {
        const int y = py + kRowsPerPass * q;
        if (y < sp.y0 || y > sp.y1) continue;
        const float dy = (float)(y - sp.cy);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = px + e;
          if (x < sp.x0 || x > sp.x1) continue;
          const float dx = (float)(x - sp.cx);
          const float qd = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          const float g = __fmul_rn(expf(__fdiv_rn(-qd, sp.denom)), sp.k);
          // the canvas starts at 0: only a larger value raises a pixel (a
          // NaN never does)
          if (g > val[q][e]) val[q][e] = g;
        }
      }
    }
    __syncthreads();  // s_slot and s_kept are read before the next batch
  }

  float* out = canvas + (size_t)stream * H * W;
  const bool vec = (W & 3) == 0 && hopper::aligned16(canvas);
#pragma unroll
  for (int q = 0; q < kTileRows / kRowsPerPass; ++q) {
    const int y = py + kRowsPerPass * q;
    if (y >= H || px >= W) continue;
    float* row = out + (size_t)y * W;
    if (vec) {  // px + 3 < W: W and px are multiples of 4
      *reinterpret_cast<float4*>(row + px) =
          make_float4(val[q][0], val[q][1], val[q][2], val[q][3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (px + e < W) row[px + e] = val[q][e];
    }
  }
}

}  // namespace

// dist (S, K, T) float32 -> match (S, K) int32. T up to 1024 (32
// columns a lane); K any.
extern "C" int greedy_assign(const float* dist, int* match, int S, int K,
                             int T, void* stream) {
  if (S <= 0 || K <= 0) return (int)cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 0 || T > 1024) return (int)cudaErrorInvalidValue;
  if (T <= 32) return launch_greedy<1>(dist, match, S, K, T, st);
  if (T <= 64) return launch_greedy<2>(dist, match, S, K, T, st);
  if (T <= 128) return launch_greedy<4>(dist, match, S, K, T, st);
  if (T <= 256) return launch_greedy<8>(dist, match, S, K, T, st);
  if (T <= 512) return launch_greedy<16>(dist, match, S, K, T, st);
  return launch_greedy<32>(dist, match, S, K, T, st);
}

// canvas (S, H, W) float32, every pixel written: the max over the valid
// slots of (S, T) of their splats, radius capped at max_radius, or 0.
extern "C" int splat_pre_hm(const int* cts, const int* radii,
                            const float* ks, const unsigned char* valid,
                            float* canvas, int S, int T, int H, int W,
                            int max_radius, void* stream) {
  if (S <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  if (T < 0 || S > 65535) return (int)cudaErrorInvalidValue;
  const int tiles_x = (W + kTileCols - 1) / kTileCols;
  const int tiles = tiles_x * ((H + kTileRows - 1) / kTileRows);
  splat_pre_hm_kernel<<<dim3(tiles, S), kSplatThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      cts, radii, ks, valid, canvas, T, H, W, tiles_x, max_radius);
  return (int)cudaGetLastError();
}
