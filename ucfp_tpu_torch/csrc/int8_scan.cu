// Fused int8-cosine candidate scans: the int8 dots computed inside the scan,
// reduced to per-cell candidates without writing a [C] score array.
//
// ucfp_cosine_i8_cells replaces pallas_scan.cosine_int8_topk_fused
// (_cosine_i8_kernel, pallas_scan.py:587). The catalog is [C, D] int8 rows;
// a tile is ROWS_PER_TILE_C = 128 rows x 128 lanes, row (t * 128 + r) * 128
// + lane falling in cell (t, lane). Each row's score is its exact int32 dot
// with the query, converted to float32 round-to-nearest, over
// max(|row|, 1e-9) -- the division inside the scan, before the argbest --
// and each (tile, lane) cell keeps its best score and the lowest r that
// reaches it (_lane_argbest). Bound: device memory -- it reads each row's D
// bytes and its 4-byte norm once (at 9,994,240 x 64, 679.6 MB: 0.203 ms at
// 3.35 TB/s); the D/4 __dp4a per row issue far below that. It takes D = 64,
// the width the bench runs and the GPU smoke test holds. Design: one
// block per tile, 128 lanes x 8 row groups of 16 rows, the query in
// registers, each row's D bytes as D/16 16-byte loads and D/4 __dp4a, the
// group's argbest in registers with a strict '>' over ascending rows, the
// 8 group winners merged in row order through shared memory. Adjacent
// lanes read adjacent rows (D bytes apart): a warp's first 16-byte load
// brings each row's sector into L1 and the row's later loads hit it. The
// division stays IEEE (no --use_fast_math, no reciprocal) and the
// conversion __int2float_rn, so the scores equal the reference's bit for
// bit.
//
// ucfp_cosine_i8_mxu_cells replaces pallas_scan.cosine_int8_topk_mxu
// (_cosine_i8_mxu_kernel, pallas_scan.py:682). The catalog is read as
// 128-byte lines that each hold per = 128 / D rows; the lines are tiled
// by rpt and each tile is split into SUB = 8 segments of rpt / 8 lines.
// Each (tile, segment, slot < per) cell keeps the best raw dot and the
// lowest line that reaches it; the caller divides only those candidates by
// the row norm (pallas_scan.py:767). The reference takes the dot as a bf16
// product with a block-diagonal query matrix on the MXU, exact because
// |dot| < 2^24; here it is __dp4a on the row's bytes, the same integers.
// Bound: device memory -- the catalog's C * D bytes once (639.6 MB at
// 9,994,240 x 64: 0.191 ms at 3.35 TB/s). It takes D in {32, 64, 128}, the
// widths the GPU smoke test holds. Design: one block per tile, one
// warp per segment; each warp step reads 4 consecutive lines (512
// contiguous bytes, one 16-byte load a thread), D / 16 neighbouring
// threads sum a row's partial dots with shuffles, each thread keeps its
// slot's best over its lines with a strict '>', and the 4 line phases merge
// by (dot, lowest line). s8 mma.sync / wgmma would not move a bytes-bound
// scan and is left for later.
//
// Both entry points have a plain C interface (loaded with ctypes), launch
// on the caller's stream, allocate nothing, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int COS_TILE_ROWS = 128;  // pallas_scan.ROWS_PER_TILE_C
constexpr int COS_GROUPS = 8;       // row groups per block
constexpr int COS_GROUP_ROWS = COS_TILE_ROWS / COS_GROUPS;
constexpr int COS_DIM = 64;         // row width: the query stays in registers
constexpr int COS_VECS = COS_DIM / 16;  // 16-byte chunks per row
constexpr int SUB = 8;              // pallas_scan.SUB: segments per line tile
constexpr int LINE_BYTES = 128;
constexpr int LINES_PER_STEP = 4;   // a warp reads 4 lines of 8 x 16 bytes
constexpr float NORM_FLOOR = 1e-9f; // jnp.maximum(row_norm, 1e-9)

__device__ __forceinline__ int dot16(const int4 a, const int4 b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  return __dp4a(a.w, b.w, acc);
}

__device__ __forceinline__ float cosine_score(const int4* __restrict__ db,
                                              const float* __restrict__ row_norm,
                                              const int4 (&qv)[COS_VECS], long long row) {
  const int4* p = db + row * COS_VECS;
  int acc = 0;
#pragma unroll
  for (int i = 0; i < COS_VECS; ++i) acc = dot16(__ldg(p + i), qv[i], acc);
  return __int2float_rn(acc) / fmaxf(__ldg(row_norm + row), NORM_FLOOR);
}

__global__ void __launch_bounds__(LANES * COS_GROUPS)
cosine_i8_cells_kernel(const int4* __restrict__ q, const int4* __restrict__ db,
                       const float* __restrict__ row_norm, float* __restrict__ best_out,
                       int* __restrict__ idx_out) {
  const int lane = threadIdx.x;
  const int group = threadIdx.y;
  const long long t = blockIdx.x;
  int4 qv[COS_VECS];
#pragma unroll
  for (int i = 0; i < COS_VECS; ++i) qv[i] = __ldg(q + i);

  const int r0 = group * COS_GROUP_ROWS;
  const long long row0 = (t * COS_TILE_ROWS + r0) * LANES + lane;
  float best = cosine_score(db, row_norm, qv, row0);
  int best_r = r0;
#pragma unroll 4
  for (int r = 1; r < COS_GROUP_ROWS; ++r) {
    const float s = cosine_score(db, row_norm, qv, row0 + (long long)r * LANES);
    if (s > best) {
      best = s;
      best_r = r0 + r;
    }
  }

  __shared__ float s_val[COS_GROUPS][LANES];
  __shared__ int s_row[COS_GROUPS][LANES];
  s_val[group][lane] = best;
  s_row[group][lane] = best_r;
  __syncthreads();
  if (group != 0) return;
  // groups hold ascending row ranges: a strict comparison keeps the
  // earliest group's (lowest) row on ties
  for (int g = 1; g < COS_GROUPS; ++g) {
    const float v = s_val[g][lane];
    if (v > best) {
      best = v;
      best_r = s_row[g][lane];
    }
  }
  const long long out = t * LANES + lane;
  best_out[out] = best;
  idx_out[out] = (int)((t * COS_TILE_ROWS + best_r) * LANES + lane);
}

template <int GSZ>  // threads per row: D / 16
__global__ void __launch_bounds__(32 * SUB)
cosine_i8_mxu_cells_kernel(const int4* __restrict__ q, const int4* __restrict__ lines,
                           int rpt, float* __restrict__ best_out, int* __restrict__ idx_out) {
  constexpr int PER = 8 / GSZ;  // rows per 128-byte line
  const int tid = threadIdx.x;  // 0..31
  const int s = threadIdx.y;    // segment
  const int li = tid >> 3;      // line phase within a step
  const int ch = tid & 7;       // 16-byte chunk within the line
  const int seg = rpt / SUB;
  const long long tile = blockIdx.x;
  const long long line0 = tile * rpt + (long long)s * seg;  // segment's first line
  const int4 qv = __ldg(q + ch % GSZ);

  int best = INT_MIN;
  int best_l = 0;
#pragma unroll 4
  for (int l0 = 0; l0 < seg; l0 += LINES_PER_STEP) {
    const int l = l0 + li;
    const int4 x = __ldg(lines + (line0 + l) * (LINE_BYTES / 16) + ch);
    int acc = dot16(x, qv, 0);
#pragma unroll
    for (int off = 1; off < GSZ; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    // lines arrive in ascending order per phase: '>' keeps the first
    if (acc > best) {
      best = acc;
      best_l = l;
    }
  }
  // merge the 4 line phases (tid bits 3 and 4) by (dot, lowest line)
#pragma unroll
  for (int off = 8; off <= 16; off <<= 1) {
    const int v = __shfl_xor_sync(0xffffffffu, best, off);
    const int vl = __shfl_xor_sync(0xffffffffu, best_l, off);
    if (v > best || (v == best && vl < best_l)) {
      best = v;
      best_l = vl;
    }
  }
  if (li == 0 && ch % GSZ == 0) {
    const int slot = ch / GSZ;
    const long long out = (tile * SUB + s) * PER + slot;
    best_out[out] = __int2float_rn(best);
    idx_out[out] = (int)(PER * (line0 + best_l) + slot);
  }
}

}  // namespace

extern "C" int ucfp_cosine_i8_cells(const void* q8, int d, const void* db8, long long c,
                                    const float* row_norm, float* best, int* idx,
                                    void* stream) {
  if (d != COS_DIM || c <= 0 || c % (COS_TILE_ROWS * LANES) != 0 ||
      c > (1LL << 31))  // int32 row indices
    return (int)cudaErrorInvalidValue;
  const int tiles = (int)(c / (COS_TILE_ROWS * LANES));
  const dim3 block(LANES, COS_GROUPS);
  cosine_i8_cells_kernel<<<tiles, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(q8), static_cast<const int4*>(db8), row_norm, best, idx);
  return (int)cudaGetLastError();
}

extern "C" int ucfp_cosine_i8_mxu_cells(const void* q8, int d, const void* db8,
                                        long long n_lines, int rpt, float* best, int* idx,
                                        void* stream) {
  if ((d != 32 && d != 64 && d != 128) || rpt <= 0 ||
      rpt % (SUB * LINES_PER_STEP) != 0 || n_lines <= 0 || n_lines % rpt != 0 ||
      n_lines * (LINE_BYTES / d) > (1LL << 31))  // int32 row indices
    return (int)cudaErrorInvalidValue;
  const long long grid = n_lines / rpt;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 block(32, SUB);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const int4*>(q8);
  const auto* lines = static_cast<const int4*>(db8);
  switch (d) {
    case 32:
      cosine_i8_mxu_cells_kernel<2><<<(unsigned)grid, block, 0, s>>>(q, lines, rpt, best, idx);
      break;
    case 64:
      cosine_i8_mxu_cells_kernel<4><<<(unsigned)grid, block, 0, s>>>(q, lines, rpt, best, idx);
      break;
    default:
      cosine_i8_mxu_cells_kernel<8><<<(unsigned)grid, block, 0, s>>>(q, lines, rpt, best, idx);
      break;
  }
  return (int)cudaGetLastError();
}
