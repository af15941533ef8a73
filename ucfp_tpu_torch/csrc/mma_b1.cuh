// The binary tensor-core product mma.sync.m16n8k256 with AND and popcount
// (s32 sums): d[m][n] += sum over the 256 k-bits of (A[m][k] & B[k][n]),
// for csrc/min_ber.cu. Fragments (PTX ISA, mma.m16n8k256 with .b1), with
// g = lane / 4 and l = lane % 4: A's a0 and a2 hold row g, a1 and a3 row
// g + 8; a0 and a1 hold k-bits 32l..32l+31, a2 and a3 k-bits
// 128+32l..128+32l+31; B's b0 and b1 hold column g at the same two
// k-ranges; the sums d[0..3] are (row g, column 2l), (g, 2l+1), (g+8,
// 2l), (g+8, 2l+1). Each register is one whole 32-bit word of k-bits and
// the product pairs A's register bits with B's, so a caller may give the
// 8 words of a k-step to the 8 register slots in any order that A and B
// share.

#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ void mma_b1_and(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

}  // namespace
