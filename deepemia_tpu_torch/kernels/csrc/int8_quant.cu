// Activation quantizer for Hopper (sm_90a), K5: float32 or bfloat16 NHWC
// activations -> int8 in the layout K4 reads and the per-image floored
// max |x|.
//
// Replaces what XLA fuses for the JAX package's quantize_activation
// (deepemia_tpu/models/quant.py:53-64): no Pallas kernel, like K4. Its plain
// counterpart is deepemia_tpu_torch/models/quant.py:_quantize_activation
// (aminmax, a float32 division, round, clamp and a cast, ~29 bytes of
// traffic per element as torch ops; kernels/int8_quant.py adds the
// layouts).
//
// One launch per quantized input whose producer took its max (K4's
// epilogue: every conv1, conv2 and block output of the int8 trunk): the
// quantize pass below alone, which reads the [N] floored maxima once a
// block and x once. Two launches for the others (the stem's image and the
// max-pool output, and the FPN's top-down sums):
//   1. amax_kernel: blocks over (slice, image) take max |x| of their slice
//      as the bits of a non-negative float (which order as unsigned
//      integers, so the result is exact and independent of the order),
//      four 16-byte loads in flight a thread, and write one partial per
//      block. Partials, not atomics into [N]: no zeroed buffer (one launch
//      fewer) and no ordering to reason about.
//   2. quant_kernel: each block reduces its image's partials (or, as
//      quant_producer_max_kernel, reads the producer's max) to
//      a = max(amax, 1e-12), s = a * float32(1/127) (XLA's division by the
//      constant 127), then writes q = clamp(rint(x / s), -127, 127) with an
//      IEEE division (__fdiv_rn, as torch divides by a tensor), 16 output
//      channels (16 bytes) a thread, in one of two layouts (Layout
//      below): x's own, or the stem's 2x2 blocks of pixels as 16
//      channels. It multiplies by 1 / s and divides only where the product
//      lies too near a half to round as the quotient.
//
// Bound: bytes, x read once and the int8 output written once (3 bytes per
// bf16 element). The two passes read x twice, so they can reach at most
// ~60 % of that bound; the one pass reads it once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "device_state.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlices = 1024;  // partials per image; the wrapper allocates N * kMaxSlices
constexpr float kInv127 = 1.0f / 127.0f;  // float32(1/127), rounded at compile time

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t abs_bits(float v) { return __float_as_uint(v) & 0x7FFFFFFFu; }

// max |x| over the 16 bytes at p (8 bf16 or 4 float32)
__device__ __forceinline__ uint32_t vec_max(const float* p) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  return max(max(abs_bits(v.x), abs_bits(v.y)), max(abs_bits(v.z), abs_bits(v.w)));
}

__device__ __forceinline__ uint32_t vec_max(const __nv_bfloat16* p) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  // a bf16 is the top half of its float32: shift it up, drop the sign
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) m = max(m, max((w[i] << 16) & 0x7FFFFFFFu, w[i] & 0x7FFF0000u));
  return m;
}

__device__ __forceinline__ uint32_t block_max(uint32_t v) {
  __shared__ uint32_t warp_max[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = v;
  __syncthreads();
  v = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0u;
  if (threadIdx.x < 32) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  }
  return v;  // valid in thread 0
}

// partial[n * slices + s] = max |x| over slice s of image n (per_image elements a image)
template <typename T>
__global__ void __launch_bounds__(kThreads) amax_kernel(const T* __restrict__ x, long long per_image, int slices,
                                                       uint32_t* __restrict__ partial) {
  constexpr int kVec = 16 / sizeof(T);
  const int n = blockIdx.y, s = blockIdx.x;
  const long long start = (long long)n * per_image + per_image * s / slices;
  const long long end = (long long)n * per_image + per_image * (s + 1) / slices;
  // 16-byte loads over the aligned middle (x is 16-byte aligned), single elements at the ends
  const long long a0 = min(end, (start + kVec - 1) / kVec * kVec);
  const long long a1 = max(a0, end / kVec * kVec);
  uint32_t m = 0;
  for (long long j = start + threadIdx.x; j < a0; j += kThreads) m = max(m, abs_bits(to_float(x[j])));
  for (long long j = a1 + threadIdx.x; j < end; j += kThreads) m = max(m, abs_bits(to_float(x[j])));
  // four 16-byte loads in flight a thread before their maxima are taken
  const long long step = (long long)kThreads * kVec;
  long long i = a0 + (long long)threadIdx.x * kVec;
  for (; i + 3 * step < a1; i += 4 * step) {
    uint32_t v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = vec_max(x + i + u * step);
    m = max(m, max(max(v[0], v[1]), max(v[2], v[3])));
  }
  for (; i < a1; i += step) m = max(m, vec_max(x + i));
  m = block_max(m);
  if (threadIdx.x == 0) partial[(long long)n * slices + s] = m;
}

// clamp(rint(v / s), -127, 127) with the IEEE quotient, as torch divides.
// v * (1 / s) lies within 2 ulp of the rounded quotient (< 2e-5 where it
// is below 128 in magnitude), so its nearest integer is the quotient's
// unless it lies within that of a half: only then (a few in 1e4 values)
// divide. No division for zeros either, whose IEEE division takes the
// slow path (half of a ReLU's output).
__device__ __forceinline__ int8_t quantize(float v, float s, float inv_s) {
  float q = rintf(v * inv_s);
  if (fabsf(v * inv_s - q) > 0.4999f) q = rintf(__fdiv_rn(v, s));
  return (int8_t)(int)fminf(fmaxf(q, -127.f), 127.f);
}

// The quantize pass's output layouts: kDense, x's own (C % 16 == 0);
// kSpaceToDepth, the 2x2 blocks of x's pixels as one pixel of 16 channels,
// (dy, dx, c) of the block in that order and zeros after (4 C <= 16): the
// stem's input, read by K4 as a 4x4 stride-1 conv.
enum Layout { kDense = 0, kSpaceToDepth = 1 };

// q[n] = clamp(rint(x[n] / s), -127, 127), int8, in `layout`, 16 output
// channels (16 bytes) a thread, n = blockIdx.y; x[n] is [h, w, c]
template <typename T, int kLayout>
__device__ __forceinline__ void quantize_image(const T* __restrict__ x, int8_t* __restrict__ q, float s_scale, int h,
                                               int w, int c) {
  const int n = blockIdx.y;
  const float s = s_scale, inv_s = __fdiv_rn(1.f, s_scale);
  const int w2 = (w + 1) / 2;
  const long long out_pixels = kLayout == kSpaceToDepth ? (long long)((h + 1) / 2) * w2 : (long long)h * w;
  const int cq = kLayout == kSpaceToDepth ? 16 : c;  // channels an output pixel
  const long long chunks = out_pixels * (cq / 16);
  const T* xn = x + (long long)n * h * w * c;
  uint4* qn = reinterpret_cast<uint4*>(q + n * out_pixels * cq);
  const long long step = (long long)gridDim.x * kThreads;
  if constexpr (kLayout == kDense) {
    // two chunks a thread, both loaded before either is quantized
    constexpr int kLoads = sizeof(T);  // 16-byte loads a chunk of 16 elements
    for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < chunks; i += 2 * step) {
      const bool second = i + step < chunks;
      uint4 raw[2][kLoads];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == 0 || second) {
#pragma unroll
          for (int l = 0; l < kLoads; ++l) {
            raw[u][l] = __ldg(reinterpret_cast<const uint4*>(xn + (i + u * step) * 16) + l);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == 1 && !second) break;
        const uint32_t* wd = reinterpret_cast<const uint32_t*>(raw[u]);
        uint32_t out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          float v;
          if constexpr (sizeof(T) == 4) {
            v = __uint_as_float(wd[j]);
          } else {  // a bf16 is the top half of its float32
            v = __uint_as_float(j % 2 ? wd[j / 2] & 0xFFFF0000u : wd[j / 2] << 16);
          }
          out[j / 4] |= (uint32_t)(uint8_t)quantize(v, s, inv_s) << (8 * (j % 4));
        }
        qn[i + u * step] = make_uint4(out[0], out[1], out[2], out[3]);
      }
    }
    return;
  }
  const int inv_c = (65536 + c - 1) / c;  // j / c == (j * inv_c) >> 16 for j < 16
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < chunks; i += step) {
    float v[16];
    bool valid[16];  // a pixel and channel of x (the others stay 0, with no division)
    const int yo = (int)(i / w2), xo = (int)(i - (long long)(i / w2) * w2);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int quad = (j * inv_c) >> 16, ch = j - quad * c;  // j = (2 dy + dx) c + ch
      const int y = 2 * yo + (quad >> 1), xx = 2 * xo + (quad & 1);
      valid[j] = quad < 4 && y < h && xx < w;
      v[j] = valid[j] ? to_float(xn[((long long)y * w + xx) * c + ch]) : 0.f;
    }
    uint32_t out[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (valid[j]) out[j / 4] |= (uint32_t)(uint8_t)quantize(v[j], s, inv_s) << (8 * (j % 4));
    }
    qn[i] = make_uint4(out[0], out[1], out[2], out[3]);
  }
}

// the quantize pass after the max pass: s[n] from its partials, whose
// floored max it also writes to amax_out
template <typename T, int kLayout>
__global__ void __launch_bounds__(kThreads) quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                                                        const uint32_t* __restrict__ partial, int slices,
                                                        float* __restrict__ amax_out, int h, int w, int c) {
  const int n = blockIdx.y;
  __shared__ float s_scale;
  if (threadIdx.x < 32) {
    uint32_t m = 0;
    for (int i = threadIdx.x; i < slices; i += 32) m = max(m, partial[(long long)n * slices + i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
    if (threadIdx.x == 0) {
      const float a = fmaxf(__uint_as_float(m), 1e-12f);  // models/quant.py:_floor
      s_scale = __fmul_rn(a, kInv127);
      if (blockIdx.x == 0) amax_out[n] = a;
    }
  }
  __syncthreads();
  quantize_image<T, kLayout>(x, q, s_scale, h, w, c);
}

// the one pass: s[n] from the producer's floored max amax_in[n], read once a block
template <typename T, int kLayout>
__global__ void __launch_bounds__(kThreads) quant_producer_max_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                                                                     const float* __restrict__ amax_in, int h, int w,
                                                                     int c) {
  __shared__ float s_scale;
  if (threadIdx.x == 0) s_scale = __fmul_rn(fmaxf(amax_in[blockIdx.y], 1e-12f), kInv127);
  __syncthreads();
  quantize_image<T, kLayout>(x, q, s_scale, h, w, c);
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

template <typename T>
int launch(const void* x, void* q, const float* amax_in, uint32_t* partial, float* amax, int n, int h, int w, int c,
           int layout, int dev, cudaStream_t stream) {
  const int sms = device_state::num_sms(dev);
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const long long per_image = (long long)h * w * c;
  // ~8 blocks a SM over the batch, at least 4K elements a block
  const long long slices = std::max(1LL, std::min<long long>({(long long)kMaxSlices, ceil_div(8LL * sms, n),
                                                              ceil_div(per_image, 4096)}));
  if (amax_in == nullptr) {
    amax_kernel<T><<<dim3((unsigned)slices, n), kThreads, 0, stream>>>(static_cast<const T*>(x), per_image,
                                                                        (int)slices, partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long out_pixels = layout == kSpaceToDepth ? (long long)((h + 1) / 2) * ((w + 1) / 2) : (long long)h * w;
  const long long chunks = layout == kSpaceToDepth ? out_pixels : out_pixels * (c / 16);
  const long long blocks = std::max(1LL, std::min(ceil_div(chunks, kThreads), ceil_div(8LL * sms, n)));
  const dim3 grid((unsigned)blocks, n);
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  if (amax_in != nullptr) {
    if (layout == kDense) {
      quant_producer_max_kernel<T, kDense><<<grid, kThreads, 0, stream>>>(xt, qt, amax_in, h, w, c);
    } else {
      quant_producer_max_kernel<T, kSpaceToDepth><<<grid, kThreads, 0, stream>>>(xt, qt, amax_in, h, w, c);
    }
  } else if (layout == kDense) {
    quant_kernel<T, kDense><<<grid, kThreads, 0, stream>>>(xt, qt, partial, (int)slices, amax, h, w, c);
  } else {
    quant_kernel<T, kSpaceToDepth><<<grid, kThreads, 0, stream>>>(xt, qt, partial, (int)slices, amax, h, w, c);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x [n, h, w, c] (NHWC, 16-byte aligned) float32 (dtype_code 0) or
// bfloat16 (1) -> q int8 (16-byte aligned). amax_in: the producer's
// floored per-image max [n] float32 (one pass; partial and amax unused,
// may be null), or null: then the max pass writes partial, n * 1024 uint32
// of scratch, and the quantize pass the floored max to amax [n] float32.
// space_to_depth 0: q is [n, h, w, c] (c % 16 == 0); 1: q is
// [n, ceil(h / 2), ceil(w / 2), 16] (4 c <= 16). Returns
// cudaGetLastError() after the launches, cudaErrorInvalidValue for
// arguments it does not take, or cudaErrorInvalidDevice when x does not lie
// on the thread's current device.
extern "C" int int8_quant(const void* x, void* q, const void* amax_in, void* partial, void* amax, int n, int h,
                          int w, int c, int space_to_depth, int dtype_code, void* stream) {
  const int layout = space_to_depth ? kSpaceToDepth : kDense;
  if (n < 1 || n > 65535 || h < 1 || w < 1 || c < 1 || (long long)h * w > 0x7fffffffLL ||
      (space_to_depth ? 4 * c > 16 : c % 16 != 0) || ((uintptr_t)x % 16) != 0 || ((uintptr_t)q % 16) != 0 ||
      ((uintptr_t)amax_in % 4) != 0 || (amax_in == nullptr && (partial == nullptr || amax == nullptr)) ||
      (dtype_code != 0 && dtype_code != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int dev = device_state::launch_device(x);
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a_in = static_cast<const float*>(amax_in);
  uint32_t* part = static_cast<uint32_t*>(partial);
  float* a = static_cast<float*>(amax);
  return dtype_code == 0 ? launch<float>(x, q, a_in, part, a, n, h, w, c, layout, dev, s)
                         : launch<__nv_bfloat16>(x, q, a_in, part, a, n, h, w, c, layout, dev, s);
}
