// The Mosaic toolchain probes of the JAX package, as small kernels for
// Hopper (sm_90a). Each isolates one construct that the DCN kernels
// depend on, on the probe's own shapes, dtypes and arithmetic:
//
//   P0   x * 2 on f32 (16, 128)         tools/pallas_probe.py p0_copy
//   P1   12 / 30 FMAs of the (16, 128)  pallas_probe.py _fma(12), _fma(30)
//   P2   slabs of a bf16 (8, 16, 128)   (_fma_kernel)
//        block by f32 scalars w[0, i % 8], in order from zero, then a
//        product by the 128x128 identity in f32
//   P3   the R=1 local-DCN tap loop on  pallas_probe.py p3_tap_loop
//        a pre-shifted bf16 (25, 8, 128, 64) stack
//   P4   x[1:9] + x[3:11], f32          pallas_probe.py p4_sublane_slice
//        (16, 128, 8)
//   P5   x[:, 3:131] + x[:, 5:133],     pallas_probe.py p5_lane_slice
//        f32 (16, 256)
//   P6   take(table, idx, axis=0),      pallas_probe.py p6_gather
//        bf16 (512, 128) table, 256 int32 indices
//   P10  a DMA window, then offset      tools/pallas_probe2.py
//   ..   loads: sums of shifted         p10_aligned .. p15_dynamic_leading
//   P15  (8, 240, 64) bf16 slices of it
//        in f32, rounded to bf16
//
// They replace those pl.pallas_call sites, which run on the TPU only
// (ops/probes.py has each probe's plain version). Every one is tiny: its
// bound on the H100 (bytes at 3.35 TB/s or float32 operations at
// 67 TFLOP/s, chip_smoke.py probe_bound_ms) is under 2 us, and one
// kernel launch costs about as much, so the launch bounds them all. The
// design is simple and right first: enough blocks for the work,
// coalesced 16-byte accesses where the layout allows, float32 SIMT
// arithmetic (no tensor cores: P1's identity product must stay exact),
// and the JAX probe's order of every float32 sum, so that each kernel
// equals its plain version bit for bit (P3 may not: its contractions
// need not sum in cuBLAS's order).
//
// Each launcher takes the inputs' and the output's device pointers and
// the stream, launches, and returns cudaGetLastError() as an int (0 =
// ok). Nothing is allocated and nothing synchronises; the shapes are the
// probes' and fixed here, and ops/probes.py checks them before a launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// ---- P0: x * 2 --------------------------------------------------------
// 2048 floats as 512 float4, one per thread: 16 KB moved.
__global__ void p0_copy_kernel(const float4* __restrict__ x,
                               float4* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float4 v = x[i];
  v.x *= 2.0f;
  v.y *= 2.0f;
  v.z *= 2.0f;
  v.w *= 2.0f;
  out[i] = v;
}

// ---- P1, P2: N FMAs, then @ I_128 ---------------------------------------
// Block r holds row r of the (16, 128) accumulator, thread j its column:
//   acc = sum_{i < N} f32(x[i % 8, r, j]) * w[0, i % 8]
// multiplied and added with one rounding each, in order from zero, as
// the JAX probe's acc = acc + x * w. The row goes to shared memory and
// is multiplied by the 128x128 identity, built here as the probe builds
// it in its kernel (jnp.eye): 128 float32 FMAs per output, exact.
template <int N>
__global__ void fma_kernel(const bf16* __restrict__ x,
                           const float* __restrict__ w,
                           float* __restrict__ out) {
  __shared__ float row[128];
  const int r = blockIdx.x, j = threadIdx.x;
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int k = i % 8;
    acc = __fadd_rn(acc, __fmul_rn(__bfloat162float(x[(k * 16 + r) * 128 + j]),
                                   w[k]));
  }
  row[j] = acc;
  __syncthreads();
  float o = 0.0f;
  for (int k = 0; k < 128; ++k)
    o = __fmaf_rn(row[k], k == j ? 1.0f : 0.0f, o);
  out[r * 128 + j] = o;
}

// ---- P3: the tap loop on a pre-shifted stack ----------------------------
// For each of the 9 taps t = (ty, tx) and each pixel p of the (8, 128)
// tile and channel c:
//   S_t(p, c) = m[t, p] * sum_{a, b} f32(xs[s(t, a, b), p, c])
//                                     * (hy[t, a, p] * hx[t, b, p])
//   out[p, o] = bf16( sum_t sum_c S_t(p, c) * f32(w[t, c, o]) )
// with s = min((ty + a) * 5 + (tx + b) + 12, 24). The JAX probe's index
// reaches 30 on a stack of 25 slabs; on the CPU (Pallas interpret mode)
// it is clamped to 24, and so it is here. S_t is built with the plain
// version's roundings (no fused multiply-adds, a then b); the
// contraction runs in float32 FMAs, each tap's product summed over c
// and then added to the accumulator.
//
// Bound: 2 * 9 * 64 * 64 + 9 * 19 * 64 float32 operations per pixel,
// about 87 MFLOP in all, 1.3 us at 67 TFLOP/s, above its 3.7 MB of
// bytes. Design: 8 pixels per block (128 blocks); per tap the block
// converts w[t] to float32 in shared memory (16 KB) and builds S_t for
// its 8 pixels (2 KB), each thread two channels; then each thread forms
// two outputs of the 8 x 64 tile from them.
constexpr int P3_TP = 8;          // pixels per block
constexpr int P3_NPIX = 8 * 128;  // pixels of the tile
constexpr int P3_C = 64;          // input and output channels

__global__ void __launch_bounds__(256)
p3_tap_loop_kernel(const bf16* __restrict__ xs, const float* __restrict__ hy,
                   const float* __restrict__ hx, const float* __restrict__ m,
                   const bf16* __restrict__ w, bf16* __restrict__ out) {
  __shared__ float ws[P3_C][P3_C];
  __shared__ float sampled[P3_TP][P3_C];
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * P3_TP;
  // sampling: pixel sp, channels sc, sc + 1; contraction: pixel sp,
  // output channels sc, sc + 1
  const int sp = tid / 32, sc = 2 * (tid % 32);
  const int pix = p0 + sp;
  float acc0 = 0.0f, acc1 = 0.0f;
  for (int t = 0; t < 9; ++t) {
    const int ty = t / 3 - 1, tx = t % 3 - 1;
    for (int e = tid; e < P3_C * P3_C; e += blockDim.x)
      ws[e / P3_C][e % P3_C] = __bfloat162float(w[t * P3_C * P3_C + e]);
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const int s = min((ty + a) * 5 + (tx + b) + 12, 24);
        const float wgt = __fmul_rn(hy[(t * 3 + a) * P3_NPIX + pix],
                                    hx[(t * 3 + b) * P3_NPIX + pix]);
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
            xs + ((int64_t)s * P3_NPIX + pix) * P3_C + sc);
        s0 = __fadd_rn(s0, __fmul_rn(__low2float(v), wgt));
        s1 = __fadd_rn(s1, __fmul_rn(__high2float(v), wgt));
      }
    }
    const float mt = m[t * P3_NPIX + pix];
    sampled[sp][sc] = __fmul_rn(s0, mt);
    sampled[sp][sc + 1] = __fmul_rn(s1, mt);
    __syncthreads();
    float d0 = 0.0f, d1 = 0.0f;
#pragma unroll 8
    for (int c = 0; c < P3_C; ++c) {
      const float v = sampled[sp][c];
      d0 = __fmaf_rn(v, ws[c][sc], d0);
      d1 = __fmaf_rn(v, ws[c][sc + 1], d1);
    }
    acc0 = __fadd_rn(acc0, d0);
    acc1 = __fadd_rn(acc1, d1);
    __syncthreads();
  }
  *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)pix * P3_C + sc) =
      __floats2bfloat162_rn(acc0, acc1);
}

// ---- P4, P5: unaligned slices -------------------------------------------
// P4: out[i] = x[1024 + i] + x[3072 + i] over 8192 floats (rows of 1024).
__global__ void p4_sublane_slice_kernel(const float* __restrict__ x,
                                        float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = x[1024 + i] + x[3072 + i];
}

// P5: out[r, j] = x[r, 3 + j] + x[r, 5 + j] on rows of 256 floats.
__global__ void p5_lane_slice_kernel(const float* __restrict__ x,
                                     float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = i / 128, j = i % 128;
  out[i] = x[r * 256 + 3 + j] + x[r * 256 + 5 + j];
}

// ---- P6: gather -----------------------------------------------------------
// One thread per 16-byte chunk (8 bf16) of an output row. jnp.take's
// default mode: an index in [-512, -1] counts from the end, any other
// outside [0, 512) gives a row of NaN (bf16 0x7FC0).
__global__ void p6_gather_kernel(const uint4* __restrict__ table,
                                 const int* __restrict__ idx,
                                 uint4* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = e / 16, q = e % 16;
  int i = idx[row];
  if (i < 0) i += 512;
  uint4 v;
  if (i >= 0 && i < 512) {
    v = table[i * 16 + q];
  } else {
    const unsigned nan2 = 0x7FC07FC0u;
    v = make_uint4(nan2, nan2, nan2, nan2);
  }
  out[e] = v;
}

// ---- P10-P15: a window copied to shared memory, then offset reads --------
// The JAX probes DMA a whole (rows, 240 or 242, 64) bf16 window into
// VMEM and read shifted (8, 240, 64) slices of it. The windows (up to
// 1.5 MB) do not fit in one block's 227 KB, so the output is tiled: a
// block makes output row r, columns c0 .. c0 + 15 (15 x 8 blocks, and
// one grid plane per P15 program), copies the part of the window those
// outputs read, halo rows and columns included, with cp.async 16-byte
// copies global -> shared, waits, and reads its terms at their offsets
// from shared memory. Each thread makes 8 channels (16 bytes) of one
// column: the terms in the JAX probe's order, summed in float32 from
// zero, rounded to bf16 once (P10: one term times 2).
//
// Bound: the bytes, the input window read once and the (8, 240, 64)
// output written once: 0.56 MB (P10-P13) to 1.78 MB (P14), 0.17-0.53 us.
constexpr int WT = 16;       // output columns per block
constexpr int WC_CH = 64;    // channels
constexpr int WQ = WC_CH / 8;  // 16-byte chunks per (row, column)
constexpr int W_RT = 8, W_CT = 240;

// S slabs, SH rows and SW columns of the source (after its leading 1);
// WR rows and WC columns of the block's window; NTERM terms; T programs
template <int PROBE> struct Window;
template <> struct Window<10> {
  static constexpr int S = 1, SH = 10, SW = 242, WR = 1, WC = WT, NTERM = 1,
                       T = 1;
};
template <> struct Window<11> {
  static constexpr int S = 1, SH = 10, SW = 242, WR = 3, WC = WT, NTERM = 3,
                       T = 1;
};
template <> struct Window<12> {
  static constexpr int S = 1, SH = 10, SW = 242, WR = 1, WC = WT + 2,
                       NTERM = 3, T = 1;
};
template <> struct Window<13> {
  static constexpr int S = 1, SH = 10, SW = 242, WR = 3, WC = WT + 2,
                       NTERM = 3, T = 1;
};
template <> struct Window<14> {
  static constexpr int S = 5, SH = 10, SW = 240, WR = 3, WC = WT, NTERM = 15,
                       T = 1;
};
template <> struct Window<15> {
  static constexpr int S = 1, SH = 12, SW = 240, WR = 3, WC = WT, NTERM = 3,
                       T = 2;
};

// Term i of a probe, in the JAX probe's order: slab s, row and column
// offsets into the window.
template <int PROBE>
__device__ __forceinline__ void window_term(int i, int& s, int& dr, int& dc) {
  s = 0;
  dr = 0;
  dc = 0;
  if (PROBE == 11 || PROBE == 15) dr = i;                  // scr[a:a+8]
  if (PROBE == 12) dc = i;                                 // scr[:8, b:b+240]
  if (PROBE == 13) dr = dc = i;                            // (a, a)
  if (PROBE == 14) { s = i / 3; dr = i % 3; }              // s outer, a inner
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int PROBE>
__global__ void __launch_bounds__(WT * WQ)
window_kernel(const bf16* __restrict__ x, bf16* __restrict__ out) {
  using P = Window<PROBE>;
  __shared__ __align__(16) bf16 win[P::S][P::WR][P::WC][WC_CH];
  const int c0 = blockIdx.x * WT, r = blockIdx.y, t = blockIdx.z;
  const int row0 = r + t;  // P15: program t's leading offset; else t = 0
  constexpr int NCHUNK = P::S * P::WR * P::WC * WQ;
  for (int e = threadIdx.x; e < NCHUNK; e += blockDim.x) {
    const int q = e % WQ;
    const int wc = (e / WQ) % P::WC;
    const int wr = (e / (WQ * P::WC)) % P::WR;
    const int s = e / (WQ * P::WC * P::WR);
    const bf16* src =
        x + (((int64_t)s * P::SH + row0 + wr) * P::SW + c0 + wc) * WC_CH +
        8 * q;
    cp_async16(&win[s][wr][wc][8 * q], src);
  }
  cp_async_wait_all();
  __syncthreads();

  const int j = threadIdx.x / WQ, q = threadIdx.x % WQ;
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.0f;
#pragma unroll
  for (int i = 0; i < P::NTERM; ++i) {
    int s, dr, dc;
    window_term<PROBE>(i, s, dr, dc);
    const uint4 v =
        *reinterpret_cast<const uint4*>(&win[s][dr][j + dc][8 * q]);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      if (PROBE == 10) {
        acc[2 * k] = __fmul_rn(f.x, 2.0f);
        acc[2 * k + 1] = __fmul_rn(f.y, 2.0f);
      } else {
        acc[2 * k] = __fadd_rn(acc[2 * k], f.x);
        acc[2 * k + 1] = __fadd_rn(acc[2 * k + 1], f.y);
      }
    }
  }
  uint4 o;
  __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    oh[k] = __floats2bfloat162_rn(acc[2 * k], acc[2 * k + 1]);
  *reinterpret_cast<uint4*>(
      out + (((int64_t)t * W_RT + r) * W_CT + c0 + j) * WC_CH + 8 * q) = o;
}

template <int PROBE>
int launch_window(const bf16* x, bf16* out, void* stream) {
  const dim3 grid(W_CT / WT, W_RT, Window<PROBE>::T);
  window_kernel<PROBE><<<grid, WT * WQ, 0, (cudaStream_t)stream>>>(x, out);
  return (int)cudaGetLastError();
}

__global__ void empty_kernel() {}

}  // namespace

#define PROBE_STREAM (cudaStream_t) stream

extern "C" int probe_p0_copy(const float* x, float* out, void* stream) {
  p0_copy_kernel<<<4, 128, 0, PROBE_STREAM>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

extern "C" int probe_p1_fma12(const bf16* x, const float* w, float* out,
                              void* stream) {
  fma_kernel<12><<<16, 128, 0, PROBE_STREAM>>>(x, w, out);
  return (int)cudaGetLastError();
}

extern "C" int probe_p2_fma30(const bf16* x, const float* w, float* out,
                              void* stream) {
  fma_kernel<30><<<16, 128, 0, PROBE_STREAM>>>(x, w, out);
  return (int)cudaGetLastError();
}

extern "C" int probe_p3_tap_loop(const bf16* xs, const float* hy,
                                 const float* hx, const float* m,
                                 const bf16* w, bf16* out, void* stream) {
  p3_tap_loop_kernel<<<P3_NPIX / P3_TP, 256, 0, PROBE_STREAM>>>(xs, hy, hx, m,
                                                                 w, out);
  return (int)cudaGetLastError();
}

extern "C" int probe_p4_sublane_slice(const float* x, float* out,
                                      void* stream) {
  p4_sublane_slice_kernel<<<32, 256, 0, PROBE_STREAM>>>(x, out);
  return (int)cudaGetLastError();
}

extern "C" int probe_p5_lane_slice(const float* x, float* out, void* stream) {
  p5_lane_slice_kernel<<<8, 256, 0, PROBE_STREAM>>>(x, out);
  return (int)cudaGetLastError();
}

extern "C" int probe_p6_gather(const bf16* table, const int* idx, bf16* out,
                               void* stream) {
  p6_gather_kernel<<<32, 128, 0, PROBE_STREAM>>>(
      reinterpret_cast<const uint4*>(table), idx,
      reinterpret_cast<uint4*>(out));
  return (int)cudaGetLastError();
}

extern "C" int probe_p10_aligned(const bf16* x, bf16* out, void* stream) {
  return launch_window<10>(x, out, stream);
}

extern "C" int probe_p11_leading_offset(const bf16* x, bf16* out,
                                        void* stream) {
  return launch_window<11>(x, out, stream);
}

extern "C" int probe_p12_sublane_offset(const bf16* x, bf16* out,
                                        void* stream) {
  return launch_window<12>(x, out, stream);
}

extern "C" int probe_p13_value_slice(const bf16* x, bf16* out, void* stream) {
  return launch_window<13>(x, out, stream);
}

extern "C" int probe_p14_4d_leading(const bf16* x, bf16* out, void* stream) {
  return launch_window<14>(x, out, stream);
}

// out is the (2, 8, 240, 64) scratch, one slot per program
extern "C" int probe_p15_dynamic_leading(const bf16* x, bf16* out,
                                         void* stream) {
  return launch_window<15>(x, out, stream);
}

extern "C" int probe_empty(void* stream) {
  empty_kernel<<<1, 32, 0, PROBE_STREAM>>>();
  return (int)cudaGetLastError();
}
