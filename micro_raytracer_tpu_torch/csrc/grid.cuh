// Host side of a launch: the dynamic shared-memory limit a kernel needs
// and the blocks of it that the card keeps resident, asked of the CUDA
// runtime once per kernel, device and size and then kept, so that a
// launch makes no query of its own (trace_fwd.cu, trace_bwd.cu).
#pragma once
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace mrt {

// Into *per_sm the blocks of `kernel` at `threads` threads and `smem`
// dynamic shared bytes that one SM of the current device keeps resident,
// and into *sms (if not null) the device's SMs, after raising the
// kernel's dynamic shared-memory limit to `smem` where it passes the
// default 48 KB and the limit set before (the limit never goes down, so a
// size asked before stays launchable). Returns a CUDA error code.
template <class Kernel>
int resident_blocks(Kernel kernel, int threads, size_t smem, int* per_sm,
                    int* sms = nullptr) {
  using Key = std::tuple<const void*, int, int, size_t>;
  static std::mutex mu;
  static std::map<Key, std::pair<int, int>> known;  // -> (per SM, SMs)
  static std::map<std::pair<const void*, int>, size_t> limit;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Key key{reinterpret_cast<const void*>(kernel), dev, threads, smem};
  std::lock_guard<std::mutex> lock(mu);
  auto it = known.find(key);
  if (it == known.end()) {
    int n = 0, count = 0;
    size_t& lim = limit[{reinterpret_cast<const void*>(kernel), dev}];
    if (smem > 48 * 1024 && smem > lim) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e == cudaSuccess) lim = smem;
    }
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                        smem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    it = known.emplace(key, std::make_pair(n, count)).first;
  }
  *per_sm = it->second.first;
  if (sms) *sms = it->second.second;
  return 0;
}

}  // namespace mrt
