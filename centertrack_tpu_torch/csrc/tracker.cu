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
// What bounds them on the H100. greedy_assign moves 4 * S * K * T bytes
// (100 KB a frame at K = 100, T = 256), 0.03 us at 3.35 TB/s; its K rows
// are a chain (a row may take a column the next row wanted), so it is
// bound by the latency of K dependent warp reductions. Design: one warp
// per stream, lane l holds columns l, l + 32, ... of a row in registers
// and a bit per column for "taken"; the next row's loads are in flight
// while a row is reduced, and a row costs a few dozen instructions and
// ten shuffles, no block barrier. splat_pre_hm writes the canvas once
// (2 MB a frame at 544 x 960): bound by bytes, 0.6 us. Design: the
// canvas is zeroed on the stream, then one block per (slot, stream), a
// dead slot returning at once, each thread taking pixels of the slot's
// clipped window; values are >= 0, so the max is an integer atomicMax on
// the float's bits, exact and independent of the order of the slots.
//
// Arithmetic follows the JAX formulas operation by operation in float32
// (explicitly rounded, so the compiler fuses nothing into an FMA); exp is
// CUDA's expf, within 2 ulps of the CPU's. Each launcher takes device
// pointers and the stream, allocates nothing, does not synchronise, and
// returns cudaGetLastError() as an int (0 = ok); shapes the kernels do
// not take return cudaErrorInvalidValue before any launch.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kInvalid = 1e18f;  // a taken column reads as this
constexpr float kMatch = 1e16f;    // a row matches below this
constexpr int kSplatThreads = 256;

// Lane l owns columns j = l + 32 c, c < COLS (T <= 32 * COLS).
template <int COLS>
__global__ void __launch_bounds__(32)
    greedy_assign_kernel(const float* __restrict__ dist,
                         int* __restrict__ match, int K, int T) {
  const int lane = threadIdx.x;
  const float* d = dist + (size_t)blockIdx.x * K * T;
  int* m = match + (size_t)blockIdx.x * K;
  unsigned taken = 0;  // bit c: column lane + 32 c
  float next[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int j = lane + 32 * c;
    next[c] = j < T ? d[j] : kInvalid;
  }
  for (int i = 0; i < K; ++i) {
    float cur[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) cur[c] = next[c];
    if (i + 1 < K) {
      const float* row = d + (size_t)(i + 1) * T;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int j = lane + 32 * c;
        next[c] = j < T ? row[j] : kInvalid;
      }
    }
    // jnp.argmin over the row with taken columns at 1e18: the first
    // minimal column, and a NaN wins (then the row matches nothing)
    float best = __int_as_float(0x7f800000);  // +inf
    int col = INT_MAX;
    bool nan = false;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int j = lane + 32 * c;
      if (j < T) {
        const float v = (taken >> c) & 1u ? kInvalid : cur[c];
        if (v != v) {
          nan = true;
        } else if (v < best) {
          best = v;
          col = j;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, off);
      const int oc = __shfl_xor_sync(kFull, col, off);
      if (ob < best || (ob == best && oc < col)) {
        best = ob;
        col = oc;
      }
    }
    nan = __any_sync(kFull, nan);
    const int j = (!nan && best < kMatch) ? col : -1;
    if (lane == 0) m[i] = j;
    if (j >= 0 && (j & 31) == lane) taken |= 1u << (j >> 5);
  }
}

template <int COLS>
int launch_greedy(const float* dist, int* match, int S, int K, int T,
                  cudaStream_t stream) {
  greedy_assign_kernel<COLS><<<S, 32, 0, stream>>>(dist, match, K, T);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(kSplatThreads)
    splat_pre_hm_kernel(const int* __restrict__ cts,
                        const int* __restrict__ radii,
                        const float* __restrict__ ks,
                        const unsigned char* __restrict__ valid,
                        float* __restrict__ canvas, int T, int H, int W,
                        int max_radius) {
  const int slot = blockIdx.y * T + blockIdx.x;
  if (!valid[slot]) return;
  const int r = min(radii[slot], max_radius);
  const int cx = cts[2 * slot], cy = cts[2 * slot + 1];
  const int x0 = max(cx - r, 0), x1 = min(cx + r, W - 1);
  const int y0 = max(cy - r, 0), y1 = min(cy + r, H - 1);
  if (r < 0 || x0 > x1 || y0 > y1) return;
  const float k = ks[slot];
  const float rf = (float)r;
  // sigma = (2 r + 1) / 6; exp(-(dx^2 + dy^2) / (2 sigma^2 + 1e-12))
  const float sigma = __fdiv_rn(__fadd_rn(__fmul_rn(2.f, rf), 1.f), 6.f);
  const float denom =
      __fadd_rn(__fmul_rn(__fmul_rn(2.f, sigma), sigma), 1e-12f);
  const int ww = x1 - x0 + 1;
  const int n = ww * (y1 - y0 + 1);
  int* out = reinterpret_cast<int*>(canvas) + (size_t)blockIdx.y * H * W;
  for (int p = threadIdx.x; p < n; p += kSplatThreads) {
    const int y = y0 + p / ww, x = x0 + p % ww;
    const float dx = (float)(x - cx), dy = (float)(y - cy);
    const float q = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    const float g = __fmul_rn(expf(__fdiv_rn(-q, denom)), k);
    // the canvas starts at +0.0: only a positive value can raise it, and
    // for those the int order of the bits is the float order
    if (g > 0.f) atomicMax(out + (size_t)y * W + x, __float_as_int(g));
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

// Zeroes canvas (S, H, W) float32 on the stream, then max-splats every
// valid slot of (S, T) into it, radius capped at max_radius.
extern "C" int splat_pre_hm(const int* cts, const int* radii,
                            const float* ks, const unsigned char* valid,
                            float* canvas, int S, int T, int H, int W,
                            int max_radius, void* stream) {
  if (S <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T < 0 || S > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      canvas, 0, sizeof(float) * (size_t)S * H * W, st);
  if (err != cudaSuccess) return (int)err;
  if (T == 0) return (int)cudaSuccess;
  splat_pre_hm_kernel<<<dim3(T, S), kSplatThreads, 0, st>>>(
      cts, radii, ks, valid, canvas, T, H, W, max_radius);
  return (int)cudaGetLastError();
}
