// The int8 tensor-core product mma.sync.m16n8k32 (s32 sums): s8 x s8 for
// csrc/mma_scan.cuh (the batched int4 and int2 scans), s8 x u8 for
// csrc/fused_scan.cu (the batched Hamming scan). Fragments (PTX ISA,
// mma.m16n8k32 with 8-bit types), with g = lane / 4 and l = lane % 4: A's
// a0..a3 hold rows g, g + 8, g, g + 8 at k = 4l..4l+3, 4l..4l+3,
// 16+4l..16+4l+3, 16+4l..16+4l+3 (byte i the lower k first); B's b0, b1
// hold column g at k = 4l..4l+3 and 16+4l..16+4l+3; the sums c[0..3] are
// (row g, column 2l), (g, 2l+1), (g+8, 2l), (g+8, 2l+1).

#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d = A * B + c with B unsigned (s8 x u8), accumulating into d
__device__ __forceinline__ void mma_s8u8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the same with the sums' input c given apart (d is written, not read)
__device__ __forceinline__ void mma_s8u8_c(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint32_t b0, uint32_t b1, int c0, int c1,
                                           int c2, int c3) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%11,%12,%13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "r"(c0), "r"(c1), "r"(c2),
        "r"(c3));
}

}  // namespace
