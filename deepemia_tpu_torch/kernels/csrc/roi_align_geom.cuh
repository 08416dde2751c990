// Sample geometry shared by the RoIAlign forward (roi_align_fwd.cu) and
// backward (roi_align_bwd.cu) kernels, so the pair is an exact adjoint up
// to float32 summation order. The expressions are those of the plain
// version (deepemia_tpu_torch/models/roi_align.py:sample_grid and _taps),
// evaluated with explicit round-to-nearest intrinsics so that no fused
// multiply-add moves a floor() at a cell boundary.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace roi_geom {

// Samples per axis a kernel's shared-memory tap tables hold: out * s is
// at most this (the wrappers refuse more).
constexpr int MAX_TAPS = 64;

// A RoI on its level (0 = p2, stride 4 << level), in level cells: the
// origin of the half-pixel-offset box, its extent, and whether each axis
// collapses its sub-samples onto the bin centre (adaptive_ratio).
struct Frame {
  float x0, y0, bw, bh;
  bool coll_x, coll_y;
};

__device__ __forceinline__ Frame roi_frame(const float* boxes, int roi, int level,
                                           int out_size, int adaptive) {
  const float scale = __fdiv_rn(1.0f, (float)(4 << level));
  const float b0 = boxes[roi * 4 + 0], b1 = boxes[roi * 4 + 1];
  const float b2 = boxes[roi * 4 + 2], b3 = boxes[roi * 4 + 3];
  Frame f;
  f.x0 = __fsub_rn(__fmul_rn(b0, scale), 0.5f);
  f.y0 = __fsub_rn(__fmul_rn(b1, scale), 0.5f);
  f.bw = __fmul_rn(__fsub_rn(b2, b0), scale);
  f.bh = __fmul_rn(__fsub_rn(b3, b1), scale);
  f.coll_x = adaptive && f.bw <= (float)out_size;
  f.coll_y = adaptive && f.bh <= (float)out_size;
  return f;
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

// Bilinear taps of one sample along one axis of `size` cells: the clamped
// low and high corners and the weights (1 - frac, frac). Returns false for
// a sample outside [-1, size], which weighs zero.
struct __align__(16) Tap {
  int lo, hi;
  float w_lo, w_hi;
};

__device__ __forceinline__ bool axis_tap(float v, int size, Tap* t) {
  if (!(v >= -1.0f && v <= (float)size)) return false;
  const float vf = floorf(v);
  const int vi = (int)vf;
  const float frac = __fsub_rn(v, vf);
  t->lo = min(max(vi, 0), size - 1);
  t->hi = min(max(vi + 1, 0), size - 1);
  t->w_lo = __fsub_rn(1.0f, frac);
  t->w_hi = frac;
  return true;
}

// A sample inside [-1, size] has w_lo + w_hi = 1, so at least one nonzero
// weight; fill_taps gives every other sample two zeros.
__device__ __forceinline__ bool tap_valid(const Tap& t) { return t.w_lo != 0.f || t.w_hi != 0.f; }

// The RoI's tap tables, computed once per block into shared memory: ty[k]
// and tx[k] for the k < P = out * s samples of each axis of an h x w level.
// A sample outside [-1, size] gets zero weights on cell 0, so the loops
// over taps need no branch: they read a cell that exists and add nothing.
// Every thread of the block calls it; the caller synchronises.
__device__ __forceinline__ void fill_taps(const Frame& f, int out, int s, int h, int w,
                                          Tap* ty, Tap* tx) {
  const int p = out * s;
  for (int k = threadIdx.x; k < 2 * p; k += blockDim.x) {
    const bool is_x = k >= p;
    const int i = is_x ? k - p : k;
    const float v = is_x ? sample_coord(f.x0, f.bw, i, out, s, f.coll_x)
                         : sample_coord(f.y0, f.bh, i, out, s, f.coll_y);
    Tap t;
    if (!axis_tap(v, is_x ? w : h, &t)) t = Tap{0, 0, 0.f, 0.f};
    (is_x ? tx : ty)[i] = t;
  }
}

}  // namespace roi_geom
