// Windowed f32 sum for Hopper (sm_90a): the float32 sum of the window
// feat[0:rows, 0:cols, :] of a row-major [H, W, C] feature map (bf16 or
// f32), written to a [1, 1] float32 output.
//
// Replaces the Pallas TPU kernel ``consume`` of tools/bench_decouple.py
// (the JAX package's layout micro-benchmark), which DMAs the [8, 16, C]
// window of its operand into VMEM and sums it; its plain counterpart is
// deepemia_tpu_torch/kernels/window_sum.py:window_sum_plain.
//
// Bound: memory, and in practice launch latency. At the benchmark's shape
// (8 x 16 x 256 bf16) the window is 64 KiB, about 0.02 us at the card's
// 3.35 TB/s, far below the few microseconds any launch costs; the 32768
// adds are nothing beside it.
//
// Design: one block of 256 threads. Each of the window's ``rows`` rows is
// one contiguous run of cols*C elements of the row-major operand, so thread
// t reads elements t, t+256, ... of every run (coalesced) into one f32
// partial sum; a shared-memory tree then adds the 256 partials. The order
// of every addition is fixed, so the result is the same on every run. The
// wrapper hands the kernel a row-major operand: a transposed or flipped
// producer pays for a copy there, the GPU form of the TPU kernel's operand
// layout constraint that the benchmark measures.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    window_sum_kernel(const T* __restrict__ feat, int w, int c, int rows, int cols,
                      float* __restrict__ out) {
  __shared__ float partial[kThreads];
  const int run = cols * c;  // contiguous elements of one window row
  float acc = 0.0f;
  for (int r = 0; r < rows; ++r) {
    const T* row = feat + (size_t)r * w * c;
    for (int i = threadIdx.x; i < run; i += kThreads) acc += to_f32(row[i]);
  }
  partial[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) partial[threadIdx.x] += partial[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = partial[0];
}

}  // namespace

extern "C" int window_sum(const void* feat, int h, int w, int c, int rows, int cols,
                          int dtype, void* out, void* stream) {
  (void)h;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    window_sum_kernel<float><<<1, kThreads, 0, st>>>(static_cast<const float*>(feat), w, c, rows,
                                                     cols, static_cast<float*>(out));
  } else {
    window_sum_kernel<__nv_bfloat16><<<1, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(feat), w, c, rows, cols, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
