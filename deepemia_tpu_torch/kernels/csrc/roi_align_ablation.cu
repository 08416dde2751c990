// Ablations of the first RoIAlign kernels (one block per RoI and output
// row, two channels per thread, geometry per sample, scalar float32
// atomics in the backward), kept to measure what held them back. Not on
// any path of the package: deepemia_tpu_torch/tools/roi_align_ablation.py
// builds this file, times each mode beside the package's kernels and
// prints the readings.
//
// Forward modes: 0 the first design as it was; 1 every feature load
// replaced by a value made from its address (what remains is geometry,
// instructions and the output write); 2 the sample geometry hoisted into
// shared-memory tap tables, once per block; 3 one block per RoI, looping
// over its output rows. Backward modes: 0 as it was; 1 every atomic
// replaced by a register sum and one plain store per thread; 2 float2
// vector atomics (half the atomic operations).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "roi_align_geom.cuh"

namespace {

__device__ __forceinline__ float2 load2(const float* p, size_t i) {
  return reinterpret_cast<const float2*>(p)[i];
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p, size_t i) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[i]);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, size_t i, float a, float b) {
  reinterpret_cast<__nv_bfloat162*>(p)[i] = __floats2bfloat162_rn(a, b);
}

struct Level {
  const void* data;
  int h, w;
};

struct Pyramid {
  Level lv[4];
};

template <int MODE>
__device__ __forceinline__ float2 corner(const __nv_bfloat16* feat, size_t row, int c, int c2) {
  if (MODE == 1) return make_float2((float)row, (float)c2);
  return load2(feat + row * c, c2);
}

// bf16 in, bf16 out, as on the serving path
template <int MODE>
__global__ void fwd_kernel(Pyramid pyr, const float* __restrict__ boxes, const int* __restrict__ levels,
                           const int* __restrict__ batch_idx, const uint8_t* __restrict__ valid,
                           __nv_bfloat16* __restrict__ out, int c, int out_size, int s, int adaptive) {
  const int roi = blockIdx.x;
  const int c2n = c / 2;
  const int rows_here = MODE == 3 ? out_size : 1;
  if (valid != nullptr && valid[roi] == 0) {
    for (int r = 0; r < rows_here; ++r) {
      const int i = MODE == 3 ? r : blockIdx.y;
      __nv_bfloat16* out_row = out + ((size_t)roi * out_size + i) * out_size * c;
      for (int j = 0; j < out_size; ++j)
        for (int c2 = threadIdx.x; c2 < c2n; c2 += blockDim.x) store2(out_row + (size_t)j * c, c2, 0.f, 0.f);
    }
    return;
  }
  const int l = levels[roi];
  const Level lev = pyr.lv[l];
  const roi_geom::Frame fr = roi_geom::roi_frame(boxes, roi, l, out_size, adaptive);
  const __nv_bfloat16* feat =
      reinterpret_cast<const __nv_bfloat16*>(lev.data) + (size_t)batch_idx[roi] * lev.h * lev.w * c;
  const float inv = __fdiv_rn(1.0f, (float)(s * s));

  // MODE 2: the block's taps, y for its row and x for all columns
  __shared__ roi_geom::Tap tx_s[64], ty_s[8];
  __shared__ bool okx_s[64], oky_s[8];
  if (MODE == 2) {
    const int p = out_size * s;
    for (int k = threadIdx.x; k < p; k += blockDim.x) {
      const float x = roi_geom::sample_coord(fr.x0, fr.bw, k, out_size, s, fr.coll_x);
      okx_s[k] = roi_geom::axis_tap(x, lev.w, &tx_s[k]);
    }
    for (int k = threadIdx.x; k < s; k += blockDim.x) {
      const float y = roi_geom::sample_coord(fr.y0, fr.bh, blockIdx.y * s + k, out_size, s, fr.coll_y);
      oky_s[k] = roi_geom::axis_tap(y, lev.h, &ty_s[k]);
    }
    __syncthreads();
  }

  for (int r = 0; r < rows_here; ++r) {
    const int i = MODE == 3 ? r : blockIdx.y;
    __nv_bfloat16* out_row = out + ((size_t)roi * out_size + i) * out_size * c;
    for (int j = 0; j < out_size; ++j) {
      for (int c2 = threadIdx.x; c2 < c2n; c2 += blockDim.x) {
        float acc0 = 0.f, acc1 = 0.f;
        for (int sy = 0; sy < s; ++sy) {
          roi_geom::Tap ty;
          if (MODE == 2) {
            if (!oky_s[sy]) continue;
            ty = ty_s[sy];
          } else {
            const float y = roi_geom::sample_coord(fr.y0, fr.bh, i * s + sy, out_size, s, fr.coll_y);
            if (!roi_geom::axis_tap(y, lev.h, &ty)) continue;
          }
          for (int sx = 0; sx < s; ++sx) {
            roi_geom::Tap tx;
            if (MODE == 2) {
              if (!okx_s[j * s + sx]) continue;
              tx = tx_s[j * s + sx];
            } else {
              const float x = roi_geom::sample_coord(fr.x0, fr.bw, j * s + sx, out_size, s, fr.coll_x);
              if (!roi_geom::axis_tap(x, lev.w, &tx)) continue;
            }
            const size_t ra = (size_t)ty.lo * lev.w, rb = (size_t)ty.hi * lev.w;
            const float2 f00 = corner<MODE>(feat, ra + tx.lo, c, c2);
            const float2 f01 = corner<MODE>(feat, ra + tx.hi, c, c2);
            const float2 f10 = corner<MODE>(feat, rb + tx.lo, c, c2);
            const float2 f11 = corner<MODE>(feat, rb + tx.hi, c, c2);
            const float w00 = __fmul_rn(ty.w_lo, tx.w_lo), w01 = __fmul_rn(ty.w_lo, tx.w_hi);
            const float w10 = __fmul_rn(ty.w_hi, tx.w_lo), w11 = __fmul_rn(ty.w_hi, tx.w_hi);
            acc0 += f00.x * w00 + f01.x * w01 + f10.x * w10 + f11.x * w11;
            acc1 += f00.y * w00 + f01.y * w01 + f10.y * w10 + f11.y * w11;
          }
        }
        store2(out_row + (size_t)j * c, c2, acc0 * inv, acc1 * inv);
      }
    }
  }
}

struct AccLevel {
  float* data;
  int h, w;
};

struct AccPyramid {
  AccLevel lv[4];
};

template <int MODE>
__device__ __forceinline__ void add2(float* row, int c2, float gx, float gy, float w, float2* sink) {
  if (MODE == 1) {
    sink->x += __fmul_rn(w, gx) + (float)(size_t)row;
    sink->y += __fmul_rn(w, gy);
  } else if (MODE == 2) {
    atomicAdd(reinterpret_cast<float2*>(row) + c2, make_float2(__fmul_rn(w, gx), __fmul_rn(w, gy)));
  } else {
    atomicAdd(row + 2 * c2, __fmul_rn(w, gx));
    atomicAdd(row + 2 * c2 + 1, __fmul_rn(w, gy));
  }
}

// bf16 cotangent into float32 accumulators, as on the training path
template <int MODE>
__global__ void bwd_kernel(AccPyramid pyr, const __nv_bfloat16* __restrict__ g, const float* __restrict__ boxes,
                           const int* __restrict__ levels, const int* __restrict__ batch_idx, int c,
                           int out_size, int s, int adaptive, float2* __restrict__ sink) {
  const int roi = blockIdx.x;
  const int i = blockIdx.y;
  const int c2n = c / 2;
  const __nv_bfloat16* g_row = g + ((size_t)roi * out_size + i) * out_size * c;
  const int l = levels[roi];
  const AccLevel lev = pyr.lv[l];
  const roi_geom::Frame fr = roi_geom::roi_frame(boxes, roi, l, out_size, adaptive);
  float* acc = lev.data + (size_t)batch_idx[roi] * lev.h * lev.w * c;
  const float inv = __fdiv_rn(1.0f, (float)(s * s));
  float2 mine = make_float2(0.f, 0.f);
  for (int j = 0; j < out_size; ++j) {
    for (int c2 = threadIdx.x; c2 < c2n; c2 += blockDim.x) {
      const float2 gv = load2(g_row + (size_t)j * c, c2);
      const float gx = __fmul_rn(gv.x, inv), gy = __fmul_rn(gv.y, inv);
      for (int sy = 0; sy < s; ++sy) {
        roi_geom::Tap ty;
        const float y = roi_geom::sample_coord(fr.y0, fr.bh, i * s + sy, out_size, s, fr.coll_y);
        if (!roi_geom::axis_tap(y, lev.h, &ty)) continue;
        for (int sx = 0; sx < s; ++sx) {
          roi_geom::Tap tx;
          const float x = roi_geom::sample_coord(fr.x0, fr.bw, j * s + sx, out_size, s, fr.coll_x);
          if (!roi_geom::axis_tap(x, lev.w, &tx)) continue;
          float* ra = acc + (size_t)ty.lo * lev.w * c;
          float* rb = acc + (size_t)ty.hi * lev.w * c;
          add2<MODE>(ra + (size_t)tx.lo * c, c2, gx, gy, __fmul_rn(ty.w_lo, tx.w_lo), &mine);
          add2<MODE>(ra + (size_t)tx.hi * c, c2, gx, gy, __fmul_rn(ty.w_lo, tx.w_hi), &mine);
          add2<MODE>(rb + (size_t)tx.lo * c, c2, gx, gy, __fmul_rn(ty.w_hi, tx.w_lo), &mine);
          add2<MODE>(rb + (size_t)tx.hi * c, c2, gx, gy, __fmul_rn(ty.w_hi, tx.w_hi), &mine);
        }
      }
    }
  }
  if (MODE == 1) sink[((size_t)roi * out_size + i) * blockDim.x + threadIdx.x] = mine;
}

}  // namespace

// The first forward design, bf16 -> bf16, in ablation mode `mode`.
extern "C" int ablate_fwd(int mode, const void* p2, const void* p3, const void* p4, const void* p5, int h2,
                          int w2, int h3, int w3, int h4, int w4, int h5, int w5, const void* boxes,
                          const void* levels, const void* batch_idx, const void* valid, void* out, int n, int c,
                          int out_size, int s, int adaptive, void* stream) {
  if (n == 0) return 0;
  Pyramid pyr{{{p2, h2, w2}, {p3, h3, w3}, {p4, h4, w4}, {p5, h5, w5}}};
  const float* b = reinterpret_cast<const float*>(boxes);
  const int* lv = reinterpret_cast<const int*>(levels);
  const int* bi = reinterpret_cast<const int*>(batch_idx);
  const uint8_t* v = reinterpret_cast<const uint8_t*>(valid);
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int threads = ((c / 2 + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const dim3 grid(n, mode == 3 ? 1 : out_size);
  if (out_size * s > 64 || s > 8) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case 0: fwd_kernel<0><<<grid, threads, 0, st>>>(pyr, b, lv, bi, v, o, c, out_size, s, adaptive); break;
    case 1: fwd_kernel<1><<<grid, threads, 0, st>>>(pyr, b, lv, bi, v, o, c, out_size, s, adaptive); break;
    case 2: fwd_kernel<2><<<grid, threads, 0, st>>>(pyr, b, lv, bi, v, o, c, out_size, s, adaptive); break;
    case 3: fwd_kernel<3><<<grid, threads, 0, st>>>(pyr, b, lv, bi, v, o, c, out_size, s, adaptive); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The first backward design's scatter, bf16 cotangent into float32
// accumulators (zeroed here), in ablation mode `mode`; `sink` takes mode
// 1's per-thread sums (n * out * threads float2).
extern "C" int ablate_bwd(int mode, const void* g, const void* boxes, const void* levels, const void* batch_idx,
                          void* acc, int b, int h2, int w2, int h3, int w3, int h4, int w4, int h5, int w5, int n,
                          int c, int out_size, int s, int adaptive, void* sink, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int hs[4] = {h2, h3, h4, h5}, ws[4] = {w2, w3, w4, w5};
  AccPyramid pyr;
  size_t total = 0;
  for (int l = 0; l < 4; ++l) {
    pyr.lv[l] = AccLevel{reinterpret_cast<float*>(acc) + total, hs[l], ws[l]};
    total += (size_t)b * hs[l] * ws[l] * c;
  }
  cudaError_t err = cudaMemsetAsync(acc, 0, total * sizeof(float), st);
  if (err != cudaSuccess || n == 0) return (int)err;
  int threads = ((c / 2 + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const dim3 grid(n, out_size);
  const __nv_bfloat16* gg = reinterpret_cast<const __nv_bfloat16*>(g);
  const float* bx = reinterpret_cast<const float*>(boxes);
  const int* lv = reinterpret_cast<const int*>(levels);
  const int* bi = reinterpret_cast<const int*>(batch_idx);
  float2* sk = reinterpret_cast<float2*>(sink);
  switch (mode) {
    case 0: bwd_kernel<0><<<grid, threads, 0, st>>>(pyr, gg, bx, lv, bi, c, out_size, s, adaptive, sk); break;
    case 1: bwd_kernel<1><<<grid, threads, 0, st>>>(pyr, gg, bx, lv, bi, c, out_size, s, adaptive, sk); break;
    case 2: bwd_kernel<2><<<grid, threads, 0, st>>>(pyr, gg, bx, lv, bi, c, out_size, s, adaptive, sk); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
