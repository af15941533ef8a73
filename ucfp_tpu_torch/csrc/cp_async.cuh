// cp.async (16-byte copies from device memory into shared memory, in
// flight while the thread goes on), shared by csrc/mma_scan.cuh,
// csrc/fused_scan.cu and csrc/min_ber.cu. The "memory" clobbers keep the
// compiler from moving shared-memory reads across an issue or a wait: a
// slot may be refilled only after the thread's reads of it.

#pragma once

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(gmem) : "memory");
}

// the same, reading only the first src_bytes (0..16) of gmem and writing
// zeros to the rest of the 16 bytes
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, int src_bytes) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of the thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
