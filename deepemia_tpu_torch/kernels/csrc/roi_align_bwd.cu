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
// weights; the box gradient is zero (it is not computed). The tap tables
// are the forward's (roi_geom::fill_taps), so the pair is an exact adjoint
// up to float32 summation order.
//
// Bound: memory. The result is the gradient of the whole p2..p5 pyramid,
// written once in its dtype, against a cotangent read once; the work, 4
// corner updates of 2 flops per sample and channel, sits far below the
// card's flops-per-byte balance point.
//
// What held the first design back (every sample added into its 4 corner
// rows with scalar float32 atomics, ~2e8 per launch at the training
// shapes): the atomic operations. With the atomics replaced by register
// sums it took 16-18 % of its time; float2 atomics halved it
// (deepemia_tpu_torch/tools/roi_align_ablation.py on the H100).
//
// Design: one block per RoI. The block computes the RoI's taps, then its
// footprint: the distinct rows and columns that valid samples touch, in
// order (a product set, so every cell of the compressed [rows, cols] tile
// receives some sample and no untouched cell is pushed). A warp takes one
// compressed row and 128 channels at a time (a lane owns 4): it sums the
// cotangent of every bin column over the sample rows that land in that row
// (in registers), spreads the sums over the row's cells with the column
// weights in a float32 row buffer in shared memory that only the lane's
// channels touch (no shared-memory atomics), and pushes each cell to the
// level's float32 accumulators with one bulk reduction
// (cp.reduce.async.bulk .add.f32, 512 bytes). That replaces 16 scalar
// atomics per sample and channel pair by one reduction per footprint cell
// and 128 channels. A row buffer holds 16 cells; wider rows go through it
// in strips. Overlapping RoIs still meet in the accumulators, so the
// summation order varies from run to run. The entry zeroes the
// accumulators (cudaMemsetAsync) and, for bf16 features, casts them into
// the bf16 output with a second kernel, all on the caller's stream. The 8
// row buffers of a block take 64 KB of dynamic shared memory, above the 48
// KB default, hence cudaFuncSetAttribute before the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "roi_align_geom.cuh"

namespace {

using roi_geom::MAX_TAPS;
using roi_geom::Tap;

constexpr int CHANNELS_PER_PASS = 128;  // 32 lanes x 4
constexpr int STRIP = 16;               // compressed cells a warp's row buffer holds
constexpr int WARPS = 8;

struct AccLevel {
  float* data;
  int h;
  int w;
};

struct AccPyramid {
  AccLevel lv[4];
};

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void add_scaled(float4* cell, float w, const float4& g) {
  float4 v = *cell;
  v.x += __fmul_rn(w, g.x);
  v.y += __fmul_rn(w, g.y);
  v.z += __fmul_rn(w, g.z);
  v.w += __fmul_rn(w, g.w);
  *cell = v;
}

// S, OUT > 0: compile-time sampling ratio and output size (the per-bin
// sums h stay in registers); 0: the runtime values s_rt, out_rt.
template <typename GT, int S, int OUT>
__global__ void __launch_bounds__(32 * WARPS) roi_align_bwd_kernel(
    AccPyramid pyr, const GT* __restrict__ g, const float* __restrict__ boxes,
    const int* __restrict__ levels, const int* __restrict__ batch_idx, int c, int out_rt, int s_rt,
    int adaptive) {
  extern __shared__ float4 row_buf[];  // per warp: STRIP cells x 32 lanes
  __shared__ Tap ty[MAX_TAPS], tx[MAX_TAPS];
  // per axis (0 = y, 1 = x), for u < 2P (tap u / 2, corner u % 2): the
  // cell it touches (-1 for a sample outside the level), whether it is
  // the first of its value, its index among the distinct cells, and the
  // distinct cells in order
  __shared__ int cand[2][2 * MAX_TAPS], rank[2][2 * MAX_TAPS], cells[2][2 * MAX_TAPS];
  __shared__ bool first[2][2 * MAX_TAPS];
  __shared__ int count[2];

  const int s = S > 0 ? S : s_rt;
  const int out_size = OUT > 0 ? OUT : out_rt;
  const int roi = blockIdx.x;
  const int l = levels[roi];
  const AccLevel lev = pyr.lv[l];
  const int p = out_size * s;
  roi_geom::fill_taps(roi_geom::roi_frame(boxes, roi, l, out_size, adaptive), out_size, s, lev.h, lev.w, ty, tx);
  __syncthreads();
  for (int k = threadIdx.x; k < 4 * p; k += blockDim.x) {
    const int a = k / (2 * p), u = k % (2 * p);
    const Tap t = (a ? tx : ty)[u / 2];
    cand[a][u] = roi_geom::tap_valid(t) ? (u % 2 ? t.hi : t.lo) : -1;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < 4 * p; k += blockDim.x) {
    const int a = k / (2 * p), u = k % (2 * p);
    const int v = cand[a][u];
    bool f = v >= 0;
    for (int u2 = 0; u2 < u && f; ++u2) f = cand[a][u2] != v;
    first[a][u] = f;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < 4 * p; k += blockDim.x) {
    const int a = k / (2 * p), u = k % (2 * p);
    const int v = cand[a][u];
    int r = 0, n = 0;
    for (int u2 = 0; u2 < 2 * p; ++u2) {
      r += first[a][u2] && cand[a][u2] < v;
      n += first[a][u2];
    }
    rank[a][u] = r;
    if (first[a][u]) cells[a][r] = v;
    if (u == 0) count[a] = n;
  }
  __syncthreads();
  const int nr = count[0], nc = count[1];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  float4* buf = row_buf + (size_t)warp * STRIP * 32;  // [STRIP cells][32 lanes]
  const int passes = (c + CHANNELS_PER_PASS - 1) / CHANNELS_PER_PASS;
  const float inv = __fdiv_rn(1.0f, (float)(s * s));
  const GT* g_roi = g + (size_t)roi * out_size * out_size * c;
  float* acc = lev.data + (size_t)batch_idx[roi] * lev.h * lev.w * c;

  for (int item = warp; item < nr * passes; item += warps) {
    const int r = item / passes;
    const int c0 = (item % passes) * CHANNELS_PER_PASS;
    const int width = min(CHANNELS_PER_PASS, c - c0);  // channels of this pass
    const bool active = lane * 4 < width;
    // h[j]: the cotangent of bin column j summed over the sample rows
    // that land in compressed row r, times their row weight
    float4 h[OUT > 0 ? OUT : MAX_TAPS];
#pragma unroll
    for (int j = 0; j < (OUT > 0 ? OUT : out_size); ++j) h[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int iy = 0; iy < p; ++iy) {
      const Tap a = ty[iy];
      // both corners of a sample clamped onto one row add both weights
      const float wy = (rank[0][2 * iy] == r ? a.w_lo : 0.f) + (rank[0][2 * iy + 1] == r ? a.w_hi : 0.f);
      if (wy == 0.f || !active) continue;
      const GT* g_row = g_roi + (size_t)(iy / s) * out_size * c + c0 + lane * 4;
#pragma unroll
      for (int j = 0; j < (OUT > 0 ? OUT : out_size); ++j) {
        const float4 gv = load4(g_row + (size_t)j * c);
        h[j].x += wy * gv.x, h[j].y += wy * gv.y, h[j].z += wy * gv.z, h[j].w += wy * gv.w;
      }
    }
    float* row = acc + (size_t)cells[0][r] * lev.w * c + c0;
    // the row's compressed cells, STRIP at a time through the buffer
    for (int q0 = 0; q0 < nc; q0 += STRIP) {
      const int qn = min(STRIP, nc - q0);
      for (int q = 0; q < qn; ++q) buf[q * 32 + lane] = make_float4(0.f, 0.f, 0.f, 0.f);
      // every sub-sample of a bin carries g / s^2
#pragma unroll
      for (int jx = 0; jx < (OUT > 0 ? OUT * S : p); ++jx) {
        const Tap b = tx[jx];
        if (!roi_geom::tap_valid(b)) continue;
        const float4 hv = h[jx / s];
        const unsigned ql = rank[1][2 * jx] - q0, qh = rank[1][2 * jx + 1] - q0;
        if (ql < STRIP) add_scaled(buf + ql * 32 + lane, __fmul_rn(b.w_lo, inv), hv);
        if (qh < STRIP) add_scaled(buf + qh * 32 + lane, __fmul_rn(b.w_hi, inv), hv);
      }
      // one bulk reduction (cp.reduce.async.bulk .add.f32) per cell: the
      // buffer's writes are made visible to the async proxy first, and
      // the buffer is reused only once the bulk reads are done
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      if (lane < qn) {
        const unsigned src = (unsigned)__cvta_generic_to_shared(buf + lane * 32);
        asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;"
                     :: "l"(row + (size_t)cells[1][q0 + lane] * c), "r"(src), "r"(width * 4) : "memory");
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      __syncwarp();
    }
  }
}

// float32 accumulators -> bfloat16 result, 8 elements (one 16-byte store)
// per thread step
__global__ void cast_bf16_kernel(const float* __restrict__ in, __nv_bfloat16* __restrict__ out, size_t eights) {
  for (size_t k = blockIdx.x * (size_t)blockDim.x + threadIdx.x; k < eights; k += (size_t)gridDim.x * blockDim.x) {
    const float4 a = reinterpret_cast<const float4*>(in)[2 * k];
    const float4 b = reinterpret_cast<const float4*>(in)[2 * k + 1];
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
    h[0] = __floats2bfloat162_rn(a.x, a.y);
    h[1] = __floats2bfloat162_rn(a.z, a.w);
    h[2] = __floats2bfloat162_rn(b.x, b.y);
    h[3] = __floats2bfloat162_rn(b.z, b.w);
    reinterpret_cast<uint4*>(out)[k] = u;
  }
}

template <typename GT, int S, int OUT>
cudaError_t launch_one(const AccPyramid& pyr, const void* g, const float* boxes, const int* levels,
                       const int* batch_idx, int n, int c, int out_size, int s, int adaptive, cudaStream_t st) {
  // WARPS row buffers of STRIP cells x 512 bytes: 64 KB, above the 48 KB a
  // block gets without asking
  const size_t smem = (size_t)WARPS * STRIP * 32 * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(roi_align_bwd_kernel<GT, S, OUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  roi_align_bwd_kernel<GT, S, OUT><<<n, 32 * WARPS, smem, st>>>(pyr, reinterpret_cast<const GT*>(g), boxes,
                                                              levels, batch_idx, c, out_size, s, adaptive);
  return cudaGetLastError();
}

template <typename GT>
cudaError_t launch(const AccPyramid& pyr, const void* g, const float* boxes, const int* levels,
                   const int* batch_idx, int n, int c, int out_size, int s, int adaptive, cudaStream_t st) {
  if (s == 2 && out_size == 7)
    return launch_one<GT, 2, 7>(pyr, g, boxes, levels, batch_idx, n, c, out_size, s, adaptive, st);
  if (s == 2 && out_size == 14)
    return launch_one<GT, 2, 14>(pyr, g, boxes, levels, batch_idx, n, c, out_size, s, adaptive, st);
  return launch_one<GT, 0, 0>(pyr, g, boxes, levels, batch_idx, n, c, out_size, s, adaptive, st);
}

}  // namespace

// acc: one float32 buffer holding the 4 levels' [B,H,W,C] accumulators
// back to back (p2 first); out: the same layout in the output dtype (for
// float32 output it is acc itself, and no cast runs). dtype codes: 0 =
// float32, 1 = bfloat16. Takes C % 8 == 0, a 16-byte aligned g and
// out_size * sampling_ratio <= 64 (the wrapper checks). Zeroes acc,
// scatters, casts; returns the first CUDA error (0 on success). An empty
// RoI set still zeroes the result.
extern "C" int roi_align_bwd(const void* g, const void* boxes, const void* levels,
                             const void* batch_idx, void* acc, void* out, int b,
                             int h2, int w2, int h3, int w3, int h4, int w4, int h5,
                             int w5, int n, int c, int out_size, int sampling_ratio,
                             int adaptive, int g_dtype, int out_dtype, void* stream) {
  if (c % 8 != 0 || out_size * sampling_ratio > MAX_TAPS || out_size < 1 || sampling_ratio < 1 ||
      (g_dtype != 0 && g_dtype != 1) || (out_dtype == 0 && out != acc) || (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
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
    const float* bx = reinterpret_cast<const float*>(boxes);
    const int* lv = reinterpret_cast<const int*>(levels);
    const int* bi = reinterpret_cast<const int*>(batch_idx);
    err = g_dtype == 0 ? launch<float>(pyr, g, bx, lv, bi, n, c, out_size, sampling_ratio, adaptive, st)
                       : launch<__nv_bfloat16>(pyr, g, bx, lv, bi, n, c, out_size, sampling_ratio, adaptive, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (out_dtype == 1) {
    const size_t eights = total / 8;
    const int threads = 256;
    const size_t blocks = (eights + threads - 1) / threads < 4096 ? (eights + threads - 1) / threads : 4096;
    if (blocks > 0)
      cast_bf16_kernel<<<(int)blocks, threads, 0, st>>>(reinterpret_cast<const float*>(acc),
                                                        reinterpret_cast<__nv_bfloat16*>(out), eights);
  }
  return (int)cudaGetLastError();
}
