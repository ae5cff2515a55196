// CPU emulation of the few CUDA pieces the port's kernels use: one std::thread
// per CUDA thread, blocks one after another, __syncwarp as a block barrier.
#pragma once
#include <barrier>
#include <cstdint>
#include <thread>
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
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline std::barrier<>* g_bar;
inline void __syncwarp(unsigned = 0xffffffffu) { g_bar->arrive_and_wait(); }
inline void __syncthreads() { g_bar->arrive_and_wait(); }
template <class K>
void emu_launch(unsigned grid, unsigned block, K body) {
  blockDim = {block, 1, 1};
  gridDim = {grid, 1, 1};
  for (unsigned b = 0; b < grid; ++b) {
    std::barrier<> bar(block);
    g_bar = &bar;
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
