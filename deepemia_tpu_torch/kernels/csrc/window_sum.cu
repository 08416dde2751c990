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
// adds are nothing beside it. What a call can save is DRAM round trips:
// a thread that waits on each load before the next pays one per load.
//
// Design: one thread-block cluster of ``blocks`` (8) blocks of 256
// threads, one launch. Each window row is one contiguous run of cols*C
// elements of the row-major operand; block b sums rows b, b + blocks, ...
// A thread takes loads t, t + 256, ... of a row, ``BATCH`` of them at a
// time, all issued before the first add, so a row costs one round trip
// per batch. Loads are 16 bytes (8 bf16 or 4 f32) where the base and the
// row pitch are 16-byte aligned (the vector instance; a run of 16*C
// elements always is), else one element (the scalar instance); the plan,
// row mapping included, is made by the wrapper
// (window_sum.py:window_sum_plan) and checked here.
//
// Reduction, in a fixed order with no atomics: each thread adds its loads
// in order into one f32 sum, a shuffle tree adds a warp's 32, thread 0
// adds the block's 8 warp sums in order and stores the block's sum into
// block rank 0's shared memory through distributed shared memory, and
// after cluster.sync() rank 0 adds the 8 block sums in rank order and
// writes the output. So the result is the same bits on every run. Rank 0
// does not read the block sums remotely: its eight remote reads ran one
// after another, and a second cluster.sync() had to keep every block
// alive until they had; on an H100 that cost ~1 us more a launch.
//
// The wrapper hands the kernel a row-major operand: a transposed or
// flipped producer pays for a copy there, the GPU form of the TPU kernel's
// operand layout constraint that the benchmark measures.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 8;  // the portable cluster size
enum Instance { kVector = 0, kScalar = 1 };
// loads a thread issues before its first add (window_sum.py: BATCH)
constexpr int kVectorBatch = 4;   // 16-byte loads: 64 B in flight per thread
constexpr int kScalarBatch = 16;  // element loads

// acc += each element of one load, lowest address first
__device__ __forceinline__ void add(float& acc, float v) { acc += v; }
__device__ __forceinline__ void add(float& acc, __nv_bfloat16 v) { acc += __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ void add_word(float& acc, uint32_t w);
template <>
__device__ __forceinline__ void add_word<float>(float& acc, uint32_t w) {
  acc += __uint_as_float(w);
}
template <>
__device__ __forceinline__ void add_word<__nv_bfloat16>(float& acc, uint32_t w) {
  acc += __uint_as_float(w << 16);  // the lower-addressed bf16
  acc += __uint_as_float(w & 0xffff0000u);
}

template <typename T>
__device__ __forceinline__ void add_vector(float& acc, const uint4& v) {
  add_word<T>(acc, v.x);
  add_word<T>(acc, v.y);
  add_word<T>(acc, v.z);
  add_word<T>(acc, v.w);
}

// A block may write into another's shared memory only once that block has
// started. So every block arrives on the cluster barrier as it starts
// (cluster_start) and waits on it after its loads, when the wait is free.
__device__ __forceinline__ void cluster_start() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}

// The cluster's sum of one float per thread, in the fixed order above,
// into out[0]. Every thread of every block of the cluster calls it, after
// cluster_start.
__device__ __forceinline__ void cluster_reduce(float acc, float* __restrict__ out) {
  __shared__ float warp_sum[kWarps];
  __shared__ float block_sums[kMaxBlocks];  // rank 0's: every block's sum, by rank
  cg::cluster_group cluster = cg::this_cluster();
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  asm volatile("barrier.cluster.wait;" ::: "memory");  // every block has started
  if (threadIdx.x == 0) {
    float s = warp_sum[0];
    for (int i = 1; i < kWarps; ++i) s += warp_sum[i];
    *cluster.map_shared_rank(&block_sums[cluster.block_rank()], 0) = s;
  }
  cluster.sync();  // the block sums have landed in rank 0's shared memory
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    float s = block_sums[0];
    for (unsigned r = 1; r < cluster.num_blocks(); ++r) s += block_sums[r];
    out[0] = s;
  }
}

// The vector (L = uint4) and scalar (L = T) instances: loads_per_row loads
// of L per window row, rows pitch elements apart.
template <typename T, typename L, int BATCH>
__global__ void __launch_bounds__(kThreads)
    window_sum_kernel(const T* __restrict__ feat, int rows, long long loads_per_row, long long pitch,
                      float* __restrict__ out) {
  cluster_start();
  float acc = 0.0f;
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const L* row = reinterpret_cast<const L*>(feat + r * pitch);
    for (long long base = threadIdx.x; base < loads_per_row; base += (long long)BATCH * kThreads) {
      L v[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        if (base + i * kThreads < loads_per_row) v[i] = __ldg(row + base + i * kThreads);
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        if (base + i * kThreads < loads_per_row) {
          if constexpr (sizeof(L) == 16) {
            add_vector<T>(acc, v[i]);
          } else {
            add(acc, v[i]);
          }
        }
      }
    }
  }
  cluster_reduce(acc, out);
}

// Same launch shape, no work: the floor under any launch of this kernel.
__global__ void __launch_bounds__(kThreads)
    window_sum_empty_kernel(const void*, int, long long, long long, float*) {}

template <typename... Args>
int launch_cluster(void (*kernel)(Args...), int blocks, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch's error
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// cudaSuccess when the plan is one this build runs on this operand: a
// vector plan's loads (16 bytes, from the base and every row start) must
// be 16-byte aligned; the loads a thread batches follow from the instance.
cudaError_t check_plan(const void* feat, int dtype, int instance, int blocks, int rows, long long loads_per_row,
                       long long pitch) {
  const int esize = dtype == 0 ? 4 : 2;
  const bool ok = (dtype == 0 || dtype == 1) && (instance == kVector || instance == kScalar) && blocks >= 1 &&
                  blocks <= kMaxBlocks && rows >= 0 && loads_per_row >= 0 && pitch >= 0 &&
                  (instance == kScalar ||
                   (reinterpret_cast<uintptr_t>(feat) % 16 == 0 && (pitch * esize) % 16 == 0));
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T>
int launch(int instance, int blocks, cudaStream_t st, const void* feat, int rows, long long loads_per_row,
           long long pitch, void* out) {
  const T* f = static_cast<const T*>(feat);
  float* o = static_cast<float*>(out);
  if (instance == kVector) {
    return launch_cluster(window_sum_kernel<T, uint4, kVectorBatch>, blocks, st, f, rows, loads_per_row, pitch,
                          o);
  }
  return launch_cluster(window_sum_kernel<T, T, kScalarBatch>, blocks, st, f, rows, loads_per_row, pitch, o);
}

}  // namespace

// The plan's fields in window_sum.py:WindowSumPlan order. Returns a CUDA
// error code: cudaErrorInvalidValue for a plan this build does not run.
extern "C" int window_sum(const void* feat, int dtype, int instance, int blocks, int rows, long long loads_per_row,
                          long long pitch, void* out, void* stream) {
  const cudaError_t bad = check_plan(feat, dtype, instance, blocks, rows, loads_per_row, pitch);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(instance, blocks, st, feat, rows, loads_per_row, pitch, out);
  return launch<__nv_bfloat16>(instance, blocks, st, feat, rows, loads_per_row, pitch, out);
}

// window_sum's launch (same cluster, same checks) of a kernel that does
// nothing: the launch floor, timed beside it.
extern "C" int window_sum_empty(const void* feat, int dtype, int instance, int blocks, int rows,
                                long long loads_per_row, long long pitch, void* out, void* stream) {
  const cudaError_t bad = check_plan(feat, dtype, instance, blocks, rows, loads_per_row, pitch);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  return launch_cluster(window_sum_empty_kernel, blocks, static_cast<cudaStream_t>(stream), feat, rows,
                        loads_per_row, pitch, static_cast<float*>(out));
}
