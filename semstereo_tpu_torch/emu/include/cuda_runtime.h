// Stand-in for the CUDA runtime header, so that a kernel source of csrc/
// compiles with g++ and runs on the CPU (see semstereo_tpu_torch/emu).
// Each block runs as one std::thread per CUDA thread, blocks one after
// another; __syncthreads is a std::barrier over the block's threads.  Only
// what the emulated sources use is here.
#pragma once

#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(16) uint4 { unsigned x, y, z, w; };

using cudaStream_t = void*;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorNotSupported = 801 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

inline thread_local dim3 threadIdx, blockIdx;

namespace emu {

// The running block's dynamic shared memory; emu.build rewrites each
// `extern __shared__ T name[];` to a pointer to it.
inline thread_local unsigned char* smem_base = nullptr;
inline thread_local std::barrier<>* block_barrier = nullptr;

// cp.async: copies a thread issued and has not yet waited for.  A copy
// lands when a wait leaves fewer groups pending, as on the card, so a read
// before its wait sees the shared memory's old bytes.
struct Copy {
  unsigned dst;
  const void* src;
  bool valid;
};
inline thread_local std::vector<Copy> uncommitted;
inline thread_local std::deque<std::vector<Copy>> groups;

inline void land(const std::vector<Copy>& g) {
  for (const Copy& c : g) {
    if (c.valid)
      std::memcpy(smem_base + c.dst, c.src, 16);
    else
      std::memset(smem_base + c.dst, 0, 16);
  }
}

inline void drain() {
  for (const auto& g : groups) land(g);
  groups.clear();
  land(uncommitted);
  uncommitted.clear();
}

struct LaunchCfg {
  dim3 grid, block;
  size_t smem = 0;
  cudaStream_t stream = nullptr;
};

// The rewritten `kernel<<<grid, block, smem, stream>>>(args...)`.  Shared
// memory starts each block filled with 0xff bytes (NaN in fp32 and bf16),
// so a read of a byte no thread wrote shows in the result.
template <typename... P, typename... A>
void launch(void (*kernel)(P...), LaunchCfg cfg, A... args) {
  const unsigned nt = cfg.block.x * cfg.block.y * cfg.block.z;
  std::unique_ptr<unsigned char[]> raw(new unsigned char[cfg.smem + 16]);
  unsigned char* smem = raw.get() + (16 - reinterpret_cast<uintptr_t>(raw.get()) % 16) % 16;
  for (unsigned bz = 0; bz < cfg.grid.z; ++bz)
    for (unsigned by = 0; by < cfg.grid.y; ++by)
      for (unsigned bx = 0; bx < cfg.grid.x; ++bx) {
        std::memset(smem, 0xff, cfg.smem);
        std::barrier<> bar(nt);
        std::vector<std::thread> threads;
        threads.reserve(nt);
        for (unsigned t = 0; t < nt; ++t)
          threads.emplace_back([&, t] {
            threadIdx = dim3(t % cfg.block.x, t / cfg.block.x % cfg.block.y,
                             t / (cfg.block.x * cfg.block.y));
            blockIdx = dim3(bx, by, bz);
            smem_base = smem;
            block_barrier = &bar;
            kernel(static_cast<P>(args)...);
            drain();
          });
        for (auto& th : threads) th.join();
      }
}

}  // namespace emu

inline void __syncthreads() { emu::block_barrier->arrive_and_wait(); }

template <typename K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
// The emulator has no SMs to fill.
template <typename K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 0;
  return cudaErrorNotSupported;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
