// CPU emulation of the few CUDA pieces the port's kernels use: one std::thread
// per CUDA thread, blocks one after another; __syncthreads a barrier of the
// block, __syncwarp(mask) a barrier of the threads of the caller's warp that
// `mask` names (the kernels call it with a team's mask only).
#pragma once
#include <barrier>
#include <bit>
#include <cstdint>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <utility>
#include <vector>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
struct dim3e { unsigned x, y, z; };
inline thread_local dim3e threadIdx, blockIdx;
inline dim3e blockDim, gridDim;
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
inline uint32_t __umulhi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline std::barrier<>* g_bar;
inline std::mutex g_warp_mu;
inline std::map<std::pair<unsigned, unsigned>, std::unique_ptr<std::barrier<>>> g_warp_bars;
inline void __syncwarp(unsigned mask = 0xffffffffu) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> lock(g_warp_mu);
    auto& slot = g_warp_bars[{threadIdx.x / 32, mask}];
    if (!slot) slot = std::make_unique<std::barrier<>>(std::popcount(mask));
    b = slot.get();
  }
  b->arrive_and_wait();
}
inline void __syncthreads() { g_bar->arrive_and_wait(); }
template <class K>
void emu_launch(unsigned grid, unsigned block, K body) {
  blockDim = {block, 1, 1};
  gridDim = {grid, 1, 1};
  for (unsigned b = 0; b < grid; ++b) {
    std::barrier<> bar(block);
    g_bar = &bar;
    g_warp_bars.clear();
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < block; ++t)
      ts.emplace_back([&, b, t] {
        threadIdx = {t, 0, 0};
        blockIdx = {b, 0, 0};
        body();
        bar.arrive_and_drop();
      });
    for (auto& th : ts) th.join();
  }
}
