// Stand-in for csrc/tc.cuh on the CPU: the cp.async helpers, queued per
// thread and landed at the wait that covers them (cuda_runtime.h here).
// Shared addresses are offsets from the block's shared memory, as the
// card's are 32-bit shared-window addresses.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace tc {

inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(static_cast<const unsigned char*>(p) - emu::smem_base);
}

inline void cp_async16(unsigned dst, const void* src, bool valid) {
  emu::uncommitted.push_back({dst, src, valid});
}
inline void cp_async_commit() {
  emu::groups.push_back(std::move(emu::uncommitted));
  emu::uncommitted.clear();
}
template <int N>
inline void cp_async_wait() {
  while (emu::groups.size() > N) {
    emu::land(emu::groups.front());
    emu::groups.pop_front();
  }
}

}  // namespace tc
