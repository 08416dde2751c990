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
// Bound: memory. Each output element costs 16 corner reads and ~50 flops,
// far below the card's ~295 flops per byte balance point. At one 1024^2
// serving tile (C = 256): the box stage writes 1000*7*7*256*4 B = 50 MB of
// f32 (half that in bf16), the mask stage 100*14*14*256*4 B = 20 MB, and
// the p2..p5 pyramid it reads is (256^2+128^2+64^2+32^2)*256*2 B = 45 MB of
// bf16, counting each input byte once. Invalid RoIs (about half of the
// padded proposal set) write zeros and read nothing.
//
// Design: features are NHWC ([B,H,W,C], what channels_last convs emit), so
// each bilinear corner is one contiguous row of C values: 512 B for C=256
// in bf16, read fully coalesced. One block per (RoI, output row); its
// threads run over channel pairs (float2 / __nv_bfloat162 loads), loop over
// the row's bins and their samples, and accumulate in f32. The sample
// coordinates are evaluated with the same f32 expressions as the plain
// version, with explicit round-to-nearest intrinsics so that no fused
// multiply-add changes a floor() at a cell boundary.
// A TMA / shared-memory staged design is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Level {
  const void* data;
  int h;
  int w;
};

struct Pyramid {
  Level lv[4];
};

__device__ __forceinline__ float2 load2(const float* p, size_t i) {
  return reinterpret_cast<const float2*>(p)[i];
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p, size_t i) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[i]);
}

__device__ __forceinline__ void store2(float* p, size_t i, float a, float b) {
  reinterpret_cast<float2*>(p)[i] = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, size_t i, float a, float b) {
  reinterpret_cast<__nv_bfloat162*>(p)[i] = __floats2bfloat162_rn(a, b);
}

// Sample coordinate k (0 <= k < out*s) along one axis, in level cells:
// origin + grid_k * extent, grid_k = (k + 0.5) / P, or the bin centre
// (floor(k / s) + 0.5) / out when the axis collapses.
__device__ __forceinline__ float sample_coord(float origin, float extent, int k,
                                              int out, int s, bool collapse) {
  const float kf = (float)k;
  const float g = collapse ? __fdiv_rn(__fadd_rn(floorf(__fdiv_rn(kf, (float)s)), 0.5f), (float)out)
                           : __fdiv_rn(__fadd_rn(kf, 0.5f), (float)(out * s));
  return __fadd_rn(origin, __fmul_rn(g, extent));
}

template <typename T, typename OutT>
__global__ void roi_align_fwd_kernel(Pyramid pyr, const float* __restrict__ boxes,
                                     const int* __restrict__ levels,
                                     const int* __restrict__ batch_idx,
                                     const uint8_t* __restrict__ valid,
                                     OutT* __restrict__ out, int c, int out_size,
                                     int s, int adaptive) {
  const int roi = blockIdx.x;
  const int i = blockIdx.y;  // output row
  const int c2n = c / 2;
  OutT* out_row = out + ((size_t)roi * out_size + i) * out_size * c;

  if (valid != nullptr && valid[roi] == 0) {
    for (int j = 0; j < out_size; ++j)
      for (int c2 = threadIdx.x; c2 < c2n; c2 += blockDim.x)
        store2(out_row + (size_t)j * c, c2, 0.f, 0.f);
    return;
  }

  const int l = levels[roi];
  const Level lev = pyr.lv[l];
  const float scale = __fdiv_rn(1.0f, (float)(4 << l));
  const float b0 = boxes[roi * 4 + 0], b1 = boxes[roi * 4 + 1];
  const float b2 = boxes[roi * 4 + 2], b3 = boxes[roi * 4 + 3];
  const float x0 = __fsub_rn(__fmul_rn(b0, scale), 0.5f);
  const float y0 = __fsub_rn(__fmul_rn(b1, scale), 0.5f);
  const float bw = __fmul_rn(__fsub_rn(b2, b0), scale);
  const float bh = __fmul_rn(__fsub_rn(b3, b1), scale);
  const bool coll_x = adaptive && bw <= (float)out_size;
  const bool coll_y = adaptive && bh <= (float)out_size;

  const T* feat = reinterpret_cast<const T*>(lev.data) +
                  (size_t)batch_idx[roi] * lev.h * lev.w * c;
  const float inv = __fdiv_rn(1.0f, (float)(s * s));

  for (int j = 0; j < out_size; ++j) {
    for (int c2 = threadIdx.x; c2 < c2n; c2 += blockDim.x) {
      float acc0 = 0.f, acc1 = 0.f;
      for (int sy = 0; sy < s; ++sy) {
        const float y = sample_coord(y0, bh, i * s + sy, out_size, s, coll_y);
        if (!(y >= -1.0f && y <= (float)lev.h)) continue;
        const float yf = floorf(y);
        const int yi = (int)yf;
        const float fy = __fsub_rn(y, yf);
        const int ya = min(max(yi, 0), lev.h - 1);
        const int yb = min(max(yi + 1, 0), lev.h - 1);
        const float wy0 = __fsub_rn(1.0f, fy);
        for (int sx = 0; sx < s; ++sx) {
          const float x = sample_coord(x0, bw, j * s + sx, out_size, s, coll_x);
          if (!(x >= -1.0f && x <= (float)lev.w)) continue;
          const float xf = floorf(x);
          const int xi = (int)xf;
          const float fx = __fsub_rn(x, xf);
          const int xa = min(max(xi, 0), lev.w - 1);
          const int xb = min(max(xi + 1, 0), lev.w - 1);
          const float wx0 = __fsub_rn(1.0f, fx);
          const size_t ra = (size_t)ya * lev.w, rb = (size_t)yb * lev.w;
          const float2 f00 = load2(feat + (ra + xa) * c, c2);
          const float2 f01 = load2(feat + (ra + xb) * c, c2);
          const float2 f10 = load2(feat + (rb + xa) * c, c2);
          const float2 f11 = load2(feat + (rb + xb) * c, c2);
          const float w00 = __fmul_rn(wy0, wx0), w01 = __fmul_rn(wy0, fx);
          const float w10 = __fmul_rn(fy, wx0), w11 = __fmul_rn(fy, fx);
          acc0 += f00.x * w00 + f01.x * w01 + f10.x * w10 + f11.x * w11;
          acc1 += f00.y * w00 + f01.y * w01 + f10.y * w10 + f11.y * w11;
        }
      }
      store2(out_row + (size_t)j * c, c2, acc0 * inv, acc1 * inv);
    }
  }
}

template <typename T, typename OutT>
void launch(const Pyramid& pyr, const float* boxes, const int* levels,
            const int* batch_idx, const uint8_t* valid, void* out, int n, int c,
            int out_size, int s, int adaptive, cudaStream_t stream) {
  int threads = c / 2;
  threads = ((threads + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  dim3 grid(n, out_size);
  roi_align_fwd_kernel<T, OutT><<<grid, threads, 0, stream>>>(
      pyr, boxes, levels, batch_idx, valid, reinterpret_cast<OutT*>(out), c,
      out_size, s, adaptive);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after
// the launch (0 on success); an empty RoI set launches nothing.
extern "C" int roi_align_fwd(const void* p2, const void* p3, const void* p4,
                             const void* p5, int h2, int w2, int h3, int w3,
                             int h4, int w4, int h5, int w5, const void* boxes,
                             const void* levels, const void* batch_idx,
                             const void* valid, void* out, int n, int c,
                             int out_size, int sampling_ratio, int adaptive,
                             int in_dtype, int out_dtype, void* stream) {
  if (n == 0) return 0;
  Pyramid pyr{{{p2, h2, w2}, {p3, h3, w3}, {p4, h4, w4}, {p5, h5, w5}}};
  const float* b = reinterpret_cast<const float*>(boxes);
  const int* lv = reinterpret_cast<const int*>(levels);
  const int* bi = reinterpret_cast<const int*>(batch_idx);
  const uint8_t* v = reinterpret_cast<const uint8_t*>(valid);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    launch<float, float>(pyr, b, lv, bi, v, out, n, c, out_size, sampling_ratio, adaptive, st);
  else if (in_dtype == 1 && out_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(pyr, b, lv, bi, v, out, n, c, out_size, sampling_ratio, adaptive, st);
  else if (in_dtype == 1 && out_dtype == 0)
    launch<__nv_bfloat16, float>(pyr, b, lv, bi, v, out, n, c, out_size, sampling_ratio, adaptive, st);
  else if (in_dtype == 0 && out_dtype == 1)
    launch<float, __nv_bfloat16>(pyr, b, lv, bi, v, out, n, c, out_size, sampling_ratio, adaptive, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
