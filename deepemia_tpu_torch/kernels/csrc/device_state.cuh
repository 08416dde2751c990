// Host state of the launchers that belongs to one GPU (int8_conv.cu,
// int8_quant.cu). A process may launch on several GPUs, from several
// threads (one per tile shard or ensemble member), so such state is kept
// per device, and set up once per device under a lock.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <mutex>

namespace device_state {

constexpr int kMaxDevices = 64;

// The device an operand lies on, when it is also the thread's current
// device (the Python wrapper makes it so); -1 otherwise, for a launch
// would then go to another GPU's context.
inline int launch_device(const void* operand) {
  cudaPointerAttributes attr;
  if (cudaPointerGetAttributes(&attr, operand) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || attr.type != cudaMemoryTypeDevice || attr.device != current ||
      current < 0 || current >= kMaxDevices) {
    return -1;
  }
  return current;
}

// The SM count of device dev, read once per device.
inline int num_sms(int dev) {
  static std::atomic<int> sms[kMaxDevices];
  int n = sms[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    sms[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

// Which devices a setup step (a kernel's function attributes, which live in
// each device's context) has run on.
struct Once {
  std::atomic<bool> done[kMaxDevices];
  std::mutex lock;
};

// Runs setup() on device dev (the current device) unless it succeeded
// there before; a failed setup runs again on the next launch.
template <typename F>
cudaError_t once_per_device(Once& once, int dev, F setup) {
  if (once.done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  std::lock_guard<std::mutex> guard(once.lock);
  if (once.done[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t err = setup();
  if (err == cudaSuccess) once.done[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace device_state
