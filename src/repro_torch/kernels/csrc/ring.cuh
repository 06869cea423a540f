// Asynchronous copies from device memory to shared memory (cp.async), the
// ring stages of the scans in knn.cu and knn_int8.cu and of l2dist.cu.
#pragma once

namespace rt {

// Copy 16 bytes from src to the shared-memory address dst, reading only the
// first `bytes` (0 or 16) and zero-filling the rest; L2 only (.cg).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}
// The same, asking L2 to fetch the whole 128-byte line around src from
// device memory, so that a later copy of the rest of the line finds it
// there.
__device__ __forceinline__ void cp_async16_line(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace rt
