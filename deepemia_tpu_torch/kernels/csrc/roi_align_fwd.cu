// Multilevel RoIAlign forward (aligned=True) for Hopper (sm_90a).
//
// Replaces deepemia_tpu/kernels/roi_align_pallas.py:roi_align_pallas, the
// Pallas TPU kernel of the JAX package, and computes the function of its
// plain counterpart deepemia_tpu_torch/models/roi_align.py:
// multilevel_roi_align: per-RoI FPN level (chosen by the wrapper and passed
// in), half-pixel offsets, a sampling_ratio^2 bilinear sub-grid per output
// bin that collapses per axis under adaptive_ratio, zero weight for
// samples outside [-1, size], clamped corners, zeros for invalid rows.
//
// Bound: memory. Each output element costs at most 16 corner reads and ~50
// flops, far below the card's ~295 flops per byte balance point. A 16-tile
// serving batch (16000 RoIs at 7x7, C = 256, bf16) writes 401 MB and reads
// every feature row its samples touch once; invalid RoIs (about half of
// the padded proposal set) write zeros and read nothing.
//
// What held the first design back (one block per RoI and output row, two
// channels per thread, geometry and a division per sample): instructions,
// not bytes. With every feature load removed it kept two thirds of its time
// (deepemia_tpu_torch/tools/roi_align_ablation.py on the H100).
//
// Design: one block per RoI. Its threads first compute the RoI's P = out*s
// taps per axis into shared memory (roi_geom::fill_taps, shared with the
// backward kernel) and, for s = 2, each bin row's and column's corner
// window: the at most 3 cells its samples touch, with summed weights.
// After that no thread divides. Features are NHWC, so a cell is one
// contiguous row of C values. A warp owns output rows of the RoI, a lane 8
// channels (one 16-byte bf16 load per cell). A bin whose samples lie within
// a cell of each other (or on a collapsed axis) is the separable sum over
// its 2x2 to 3x3 window, each cell read once; a sparser bin reads the 4
// corners of each sample (16 loads). A bin's loads are in flight together,
// then one 16-byte streaming store per lane. All bins of a RoI run on one
// SM, so the cells neighbouring bins share come from L1 and each cell of
// the footprint crosses from L2 about once per RoI, as a shared-memory
// staged footprint would; no staging copy is made. What remains is
// reading the features from device memory (PERF.md).
// Template instances for s = 2 and out in {7, 14} unroll everything, at
// most 73 registers for 4 blocks an SM; a generic instance takes other
// values. An invalid RoI is zeroed with 16-byte stores and no geometry.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "roi_align_geom.cuh"

namespace {

using roi_geom::Tap;

struct Level {
  const void* data;
  int h;
  int w;
};

struct Pyramid {
  Level lv[4];
};

// Eight channels of one feature row as loaded (bf16: one 16-byte load,
// float32: two), widened to float32 when used.
template <typename T>
struct Raw;

template <>
struct Raw<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) { u = __ldg(reinterpret_cast<const uint4*>(p)); }
  __device__ __forceinline__ void fma(float w, float (&acc)[8]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      acc[2 * k] += f.x * w;
      acc[2 * k + 1] += f.y * w;
    }
  }
};

template <>
struct Raw<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void fma(float w, float (&acc)[8]) const {
    acc[0] += a.x * w, acc[1] += a.y * w, acc[2] += a.z * w, acc[3] += a.w * w;
    acc[4] += b.x * w, acc[5] += b.y * w, acc[6] += b.z * w, acc[7] += b.w * w;
  }
};

// The output is written once and not read here: streaming stores
// (evict-first) leave L2 to the feature rows.
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  __stcs(reinterpret_cast<uint4*>(p), u);
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(v[4], v[5], v[6], v[7]));
}

// Adds the samples [q0, q0 + G) of a bin, NX of them per row (q = sy *
// nx + sx), into acc: all G * 4 corner loads are in flight before the first
// multiply. ty and tx point at the bin's first tap.
template <typename T, int G, int NX>
__device__ __forceinline__ void add_samples(const T* feat, int w, int c, const Tap* ty, const Tap* tx,
                                            int nx_rt, int q0, float (&acc)[8]) {
  const int nx = NX > 0 ? NX : nx_rt;
  Raw<T> r[G][4];
  float wt[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const Tap a = ty[(q0 + g) / nx], b = tx[(q0 + g) % nx];
    const size_t ra = (size_t)a.lo * w, rb = (size_t)a.hi * w;
    r[g][0].load(feat + (ra + b.lo) * c);
    r[g][1].load(feat + (ra + b.hi) * c);
    r[g][2].load(feat + (rb + b.lo) * c);
    r[g][3].load(feat + (rb + b.hi) * c);
    wt[g][0] = __fmul_rn(a.w_lo, b.w_lo);
    wt[g][1] = __fmul_rn(a.w_lo, b.w_hi);
    wt[g][2] = __fmul_rn(a.w_hi, b.w_lo);
    wt[g][3] = __fmul_rn(a.w_hi, b.w_hi);
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int k = 0; k < 4; ++k) r[g][k].fma(wt[g][k], acc);
}

// The corner rows (or columns) that the S samples of one bin row (or
// column) touch, when they fit in a window of 3 cells from `base`, with
// the summed weight of each: a bin is then the separable sum over at most
// 3 x 3 cells, each read once (S = 2 samples spaced by at most a cell, or
// a collapsed axis, share corners). base < 0: the taps span more cells.
struct __align__(16) Window {
  int base;
  float w[3];
};

template <int S>
__device__ __forceinline__ Window bin_window(const Tap* t) {
  int lo = 1 << 30, hi = -1;
#pragma unroll
  for (int k = 0; k < S; ++k)
    if (roi_geom::tap_valid(t[k])) lo = min(lo, t[k].lo), hi = max(hi, t[k].hi);
  Window win{0, {0.f, 0.f, 0.f}};
  if (hi < 0) return win;  // every sample outside the level: all weights zero
  if (hi - lo > 2) {
    win.base = -1;
    return win;
  }
  win.base = lo;
#pragma unroll
  for (int k = 0; k < S; ++k)
#pragma unroll
    for (int d = 0; d < 3; ++d)
      win.w[d] += (t[k].lo - lo == d ? t[k].w_lo : 0.f) + (t[k].hi - lo == d ? t[k].w_hi : 0.f);
  return win;
}

// A bin as the separable sum over RY x RX cells of the windows a (rows)
// and b (columns); bf16 has every load in flight at once, float32 a row
// at a time. Cells past the level edge carry zero weight and are clamped.
template <typename T, int RY, int RX>
__device__ __forceinline__ void add_window(const T* feat, int h, int w, int c, const Window& a,
                                           const Window& b, float (&acc)[8]) {
  constexpr int GR = sizeof(T) == 2 ? RY : 1;
#pragma unroll
  for (int y0 = 0; y0 < RY; y0 += GR) {
    Raw<T> r[GR][RX];
#pragma unroll
    for (int y = 0; y < GR; ++y)
#pragma unroll
      for (int x = 0; x < RX; ++x)
        r[y][x].load(feat + ((size_t)min(a.base + y0 + y, h - 1) * w + min(b.base + x, w - 1)) * c);
#pragma unroll
    for (int y = 0; y < GR; ++y)
#pragma unroll
      for (int x = 0; x < RX; ++x) r[y][x].fma(__fmul_rn(a.w[y0 + y], b.w[x]), acc);
  }
}

// The bins of one RoI: a warp owns output rows, a lane 8 channels. With
// S > 0 a bin whose rows and columns fit in 3-cell windows reads 4 to 9
// cells; any other bin (samples more than a cell apart), and every bin of
// the generic instance, reads the 4 corners of each of its s x s samples.
template <typename T, typename OutT, int S, int OUT>
__device__ __forceinline__ void pool_bins(const T* feat, int h, int w, int c, const Tap* ty, const Tap* tx,
                                          const Window* wy, const Window* wx, int s_rt, int out_rt,
                                          OutT* out_roi) {
  const int s = S > 0 ? S : s_rt;
  const int out_size = OUT > 0 ? OUT : out_rt;
  const float inv = __fdiv_rn(1.0f, (float)(s * s));
  // bf16 has every corner load of a bin in flight at once (16 for 2x2 samples);
  // float32 (twice the registers per load) a row of samples at a time
  constexpr int G = S == 0 ? 1 : (sizeof(T) == 2 ? S * S : S);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int i = warp; i < out_size; i += warps) {
    for (int j = 0; j < out_size; ++j) {
      OutT* dst = out_roi + ((size_t)i * out_size + j) * c;
      for (int c0 = lane * 8; c0 < c; c0 += 256) {
        float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        const T* f = feat + c0;
        if constexpr (S > 0) {
          const Window a = wy[i], b = wx[j];
          if (a.base >= 0 && b.base >= 0) {
            if (a.w[2] == 0.f && b.w[2] == 0.f)
              add_window<T, 2, 2>(f, h, w, c, a, b, acc);
            else if (a.w[2] == 0.f)
              add_window<T, 2, 3>(f, h, w, c, a, b, acc);
            else if (b.w[2] == 0.f)
              add_window<T, 3, 2>(f, h, w, c, a, b, acc);
            else
              add_window<T, 3, 3>(f, h, w, c, a, b, acc);
          } else {
#pragma unroll
            for (int q0 = 0; q0 < S * S; q0 += G) add_samples<T, G, S>(f, w, c, ty + i * s, tx + j * s, s, q0, acc);
          }
        } else {
          for (int q = 0; q < s * s; ++q) add_samples<T, 1, 0>(f, w, c, ty + i * s, tx + j * s, s, q, acc);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] *= inv;
        store8(dst + c0, acc);
      }
    }
  }
}

// S, OUT > 0: compile-time sampling ratio and output size; 0: the runtime
// values s_rt, out_rt.
template <typename T, typename OutT, int S, int OUT>
__global__ void __launch_bounds__(224, 4) roi_align_fwd_kernel(
    Pyramid pyr, const float* __restrict__ boxes, const int* __restrict__ levels,
    const int* __restrict__ batch_idx, const uint8_t* __restrict__ valid, OutT* __restrict__ out, int c,
    int out_rt, int s_rt, int adaptive) {
  const int s = S > 0 ? S : s_rt;
  const int out_size = OUT > 0 ? OUT : out_rt;
  const int roi = blockIdx.x;
  OutT* out_roi = out + (size_t)roi * out_size * out_size * c;

  if (valid != nullptr && valid[roi] == 0) {
    const size_t n16 = (size_t)out_size * out_size * c * sizeof(OutT) / 16;
    for (size_t k = threadIdx.x; k < n16; k += blockDim.x)
      __stcs(reinterpret_cast<uint4*>(out_roi) + k, make_uint4(0u, 0u, 0u, 0u));
    return;
  }

  __shared__ Tap ty[roi_geom::MAX_TAPS], tx[roi_geom::MAX_TAPS];
  __shared__ Window wy[OUT > 0 ? OUT : 1], wx[OUT > 0 ? OUT : 1];
  const int l = levels[roi];
  const Level lev = pyr.lv[l];
  roi_geom::fill_taps(roi_geom::roi_frame(boxes, roi, l, out_size, adaptive), out_size, s, lev.h, lev.w, ty, tx);
  __syncthreads();
  if constexpr (S > 0) {
    for (int k = threadIdx.x; k < 2 * OUT; k += blockDim.x) {
      if (k < OUT)
        wy[k] = bin_window<S>(ty + k * S);
      else
        wx[k - OUT] = bin_window<S>(tx + (k - OUT) * S);
    }
    __syncthreads();
  }

  const T* feat = reinterpret_cast<const T*>(lev.data) + (size_t)batch_idx[roi] * lev.h * lev.w * c;
  pool_bins<T, OutT, S, OUT>(feat, lev.h, lev.w, c, ty, tx, wy, wx, s, out_size, out_roi);
}

template <typename T, typename OutT>
int launch(const Pyramid& pyr, const float* boxes, const int* levels, const int* batch_idx,
           const uint8_t* valid, void* out, int n, int c, int out_size, int s, int adaptive,
           cudaStream_t stream) {
  const int threads = 32 * (out_size < 7 ? out_size : 7);
  OutT* o = reinterpret_cast<OutT*>(out);
  if (s == 2 && out_size == 7)
    roi_align_fwd_kernel<T, OutT, 2, 7><<<n, threads, 0, stream>>>(pyr, boxes, levels, batch_idx, valid, o, c,
                                                                   out_size, s, adaptive);
  else if (s == 2 && out_size == 14)
    roi_align_fwd_kernel<T, OutT, 2, 14><<<n, threads, 0, stream>>>(pyr, boxes, levels, batch_idx, valid, o, c,
                                                                    out_size, s, adaptive);
  else
    roi_align_fwd_kernel<T, OutT, 0, 0><<<n, threads, 0, stream>>>(pyr, boxes, levels, batch_idx, valid, o, c,
                                                                   out_size, s, adaptive);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Takes C % 8 == 0, 16-byte
// aligned feature levels and out_size * sampling_ratio <= 64 (the wrapper
// checks). Returns cudaGetLastError() after the launch (0 on success); an
// empty RoI set launches nothing.
extern "C" int roi_align_fwd(const void* p2, const void* p3, const void* p4,
                             const void* p5, int h2, int w2, int h3, int w3,
                             int h4, int w4, int h5, int w5, const void* boxes,
                             const void* levels, const void* batch_idx,
                             const void* valid, void* out, int n, int c,
                             int out_size, int sampling_ratio, int adaptive,
                             int in_dtype, int out_dtype, void* stream) {
  if (n == 0) return 0;
  if (c % 8 != 0 || out_size * sampling_ratio > roi_geom::MAX_TAPS || out_size < 1 || sampling_ratio < 1)
    return (int)cudaErrorInvalidValue;
  Pyramid pyr{{{p2, h2, w2}, {p3, h3, w3}, {p4, h4, w4}, {p5, h5, w5}}};
  const float* b = reinterpret_cast<const float*>(boxes);
  const int* lv = reinterpret_cast<const int*>(levels);
  const int* bi = reinterpret_cast<const int*>(batch_idx);
  const uint8_t* v = reinterpret_cast<const uint8_t*>(valid);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch<float, float>(pyr, b, lv, bi, v, out, n, c, out_size, sampling_ratio, adaptive, st);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(pyr, b, lv, bi, v, out, n, c, out_size, sampling_ratio, adaptive, st);
  if (in_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(pyr, b, lv, bi, v, out, n, c, out_size, sampling_ratio, adaptive, st);
  if (in_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(pyr, b, lv, bi, v, out, n, c, out_size, sampling_ratio, adaptive, st);
  return (int)cudaErrorInvalidValue;
}
