// Multilevel RoIAlign backward (the adjoint of roi_align_fwd.cu) for Hopper
// (sm_90a).
//
// Replaces deepemia_tpu/kernels/roi_align_pallas.py:roi_align_backward_pallas
// (its _bwd_kernel), the Pallas TPU kernel of the JAX package, and computes
// the function of its plain counterpart
// deepemia_tpu_torch/models/roi_align.py:multilevel_roi_align_backward: for
// RoI n on level l of image b and each sample (iy, jx) of its P x P grid
// (P = out * s), every channel c adds w_corner * g[n, iy/s, jx/s, c] / s^2
// into dF_l[b, y, x, c] at the sample's 4 clamped bilinear corners.
// Samples outside [-1, size] weigh zero; coincident clamped corners add both
// weights; the box gradient is zero (it is not computed). The geometry is
// the forward's (roi_align_geom.cuh), so the pair is an exact adjoint up to
// float32 summation order.
//
// Bound: memory. The result is the gradient of the whole p2..p5 pyramid:
// at two 512^2 training images (C = 256) that is 2 * (128^2 + 64^2 + 32^2 +
// 16^2) * 256 floats = 45 MB of float32 accumulators, zeroed, accumulated
// and (for bf16 features) read back and written as 22 MB of bf16, against
// a cotangent of 1024 * 7*7*256 * 2 B = 26 MB (box stage, bf16) that is read
// once. The work, 4 corner updates of 2 flops per sample and channel, sits
// far below the card's flops-per-byte balance point.
//
// Design: one block per (RoI, output row), threads over channel pairs, as in
// the forward. Each thread reads its g pair once per bin and adds it into
// the 4 corner rows of every sample with float32 atomicAdd whose result is
// unused (compiled to RED, fire and forget). Accumulators are NHWC, so the
// block's updates to one corner row are contiguous and coalesced. RoIs that
// overlap (proposals around one object, and the appended ground-truth boxes)
// add into the same rows; the atomics make that correct at the cost of
// contention, and make the summation order vary from run to run. The entry
// zeroes the accumulators (cudaMemsetAsync) and, for bf16 features, casts
// them into the bf16 output with a second kernel, all on the caller's
// stream. No shared-memory window staging or vector atomics yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "roi_align_geom.cuh"

namespace {

using roi_geom::load2;

struct AccLevel {
  float* data;
  int h;
  int w;
};

struct AccPyramid {
  AccLevel lv[4];
};

__device__ __forceinline__ void add2(float* row, int c2, float gx, float gy, float w) {
  atomicAdd(row + 2 * c2, __fmul_rn(w, gx));
  atomicAdd(row + 2 * c2 + 1, __fmul_rn(w, gy));
}

template <typename GT>
__global__ void roi_align_bwd_kernel(AccPyramid pyr, const GT* __restrict__ g,
                                     const float* __restrict__ boxes,
                                     const int* __restrict__ levels,
                                     const int* __restrict__ batch_idx, int c,
                                     int out_size, int s, int adaptive) {
  const int roi = blockIdx.x;
  const int i = blockIdx.y;  // output row
  const int c2n = c / 2;
  const GT* g_row = g + ((size_t)roi * out_size + i) * out_size * c;

  const int l = levels[roi];
  const AccLevel lev = pyr.lv[l];
  const roi_geom::Frame fr = roi_geom::roi_frame(boxes, roi, l, out_size, adaptive);
  float* acc = lev.data + (size_t)batch_idx[roi] * lev.h * lev.w * c;
  const float inv = __fdiv_rn(1.0f, (float)(s * s));

  for (int j = 0; j < out_size; ++j) {
    for (int c2 = threadIdx.x; c2 < c2n; c2 += blockDim.x) {
      const float2 gv = load2(g_row + (size_t)j * c, c2);
      // every sub-sample of the bin carries g / s^2
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
          add2(ra + (size_t)tx.lo * c, c2, gx, gy, __fmul_rn(ty.w_lo, tx.w_lo));
          add2(ra + (size_t)tx.hi * c, c2, gx, gy, __fmul_rn(ty.w_lo, tx.w_hi));
          add2(rb + (size_t)tx.lo * c, c2, gx, gy, __fmul_rn(ty.w_hi, tx.w_lo));
          add2(rb + (size_t)tx.hi * c, c2, gx, gy, __fmul_rn(ty.w_hi, tx.w_hi));
        }
      }
    }
  }
}

// float32 accumulators -> bfloat16 result, two elements per thread step
__global__ void cast_bf16_kernel(const float* __restrict__ in, __nv_bfloat16* __restrict__ out,
                                 size_t pairs) {
  for (size_t k = blockIdx.x * (size_t)blockDim.x + threadIdx.x; k < pairs;
       k += (size_t)gridDim.x * blockDim.x) {
    const float2 v = reinterpret_cast<const float2*>(in)[k];
    reinterpret_cast<__nv_bfloat162*>(out)[k] = __floats2bfloat162_rn(v.x, v.y);
  }
}

}  // namespace

// acc: one float32 buffer holding the 4 levels' [B,H,W,C] accumulators
// back to back (p2 first); out: the same layout in the output dtype (for
// float32 output it is acc itself, and no cast runs). dtype codes: 0 =
// float32, 1 = bfloat16. Zeroes acc, scatters, casts; returns the first
// CUDA error (0 on success). An empty RoI set still zeroes the result.
extern "C" int roi_align_bwd(const void* g, const void* boxes, const void* levels,
                             const void* batch_idx, void* acc, void* out, int b,
                             int h2, int w2, int h3, int w3, int h4, int w4, int h5,
                             int w5, int n, int c, int out_size, int sampling_ratio,
                             int adaptive, int g_dtype, int out_dtype, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int hs[4] = {h2, h3, h4, h5}, ws[4] = {w2, w3, w4, w5};
  AccPyramid pyr;
  size_t total = 0;
  for (int l = 0; l < 4; ++l) {
    pyr.lv[l] = AccLevel{reinterpret_cast<float*>(acc) + total, hs[l], ws[l]};
    total += (size_t)b * hs[l] * ws[l] * c;
  }
  cudaError_t err = cudaMemsetAsync(acc, 0, total * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    int threads = ((c / 2 + 31) / 32) * 32;
    if (threads > 256) threads = 256;
    const dim3 grid(n, out_size);
    const float* bx = reinterpret_cast<const float*>(boxes);
    const int* lv = reinterpret_cast<const int*>(levels);
    const int* bi = reinterpret_cast<const int*>(batch_idx);
    if (g_dtype == 0)
      roi_align_bwd_kernel<float><<<grid, threads, 0, st>>>(
          pyr, reinterpret_cast<const float*>(g), bx, lv, bi, c, out_size, sampling_ratio, adaptive);
    else if (g_dtype == 1)
      roi_align_bwd_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
          pyr, reinterpret_cast<const __nv_bfloat16*>(g), bx, lv, bi, c, out_size, sampling_ratio,
          adaptive);
    else
      return (int)cudaErrorInvalidValue;
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (out_dtype == 1) {
    const size_t pairs = total / 2;
    const int threads = 256;
    const int blocks = (int)((pairs + threads - 1) / threads < 4096 ? (pairs + threads - 1) / threads : 4096);
    if (blocks > 0)
      cast_bf16_kernel<<<blocks, threads, 0, st>>>(reinterpret_cast<const float*>(acc),
                                                   reinterpret_cast<__nv_bfloat16*>(out), pairs);
  } else if (out_dtype != 0 || out != acc) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
