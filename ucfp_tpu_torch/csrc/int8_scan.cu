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
// the width the bench runs and the GPU smoke test holds. Design: one warp
// per (tile, 32-lane quarter) -- 2,440 one-warp blocks at 9,994,240 rows,
// which the block scheduler spreads over the 132 SMs within a block each
// (a tile per 1,024-thread block gave 610 blocks, 2.3 waves, the last 31%
// full). Four threads share a 64-byte row, so each load instruction of a
// warp reads 8 rows, 512 contiguous bytes, and four of them read the
// quarter's 32 rows of one tile row r (a lane reading its own row as four
// 16-byte loads scattered a warp's load over 32 rows 64 bytes apart, half
// of every fetched sector waiting in L1). A shuffle reduce-scatter over the
// four threads of a row (3 shuffles for 4 rows) leaves each thread one
// row's whole dot: thread x ends with lane 8 (x % 4) + x / 4 of the quarter,
// the same lane at every r, so the cell's argbest stays in its registers
// with a strict '>' over ascending r and needs no merge. Four tile rows'
// loads (8 KB a warp) are issued before their dots. The division stays
// IEEE (no --use_fast_math, no reciprocal) and the conversion
// __int2float_rn, so the scores equal the reference's bit for bit.
// ucfp_cosine_i8_topk launches it and the selection (csrc/select.cu) from
// one host call.
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
// Every entry point has a plain C interface (loaded with ctypes), launch
// on the caller's stream, allocate nothing, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int COS_TILE_ROWS = 128;  // pallas_scan.ROWS_PER_TILE_C
constexpr int COS_QUARTERS = LANES / 32;  // one warp per (tile, 32 lanes)
constexpr int COS_DIM = 64;         // row width: a row is four 16-byte pieces
constexpr int COS_VECS = COS_DIM / 16;  // 16-byte chunks per row
constexpr int COS_STEP = 4;         // tile rows whose loads a warp issues together
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

__global__ void __launch_bounds__(32)
cosine_i8_cells_kernel(const int4* __restrict__ q, const int4* __restrict__ db,
                       const float* __restrict__ row_norm, float* __restrict__ best_out,
                       int* __restrict__ idx_out) {
  constexpr unsigned FULL = 0xffffffffu;
  const int x = threadIdx.x;
  const int piece = x & 3;  // the 16-byte piece of a row this thread loads
  const bool b1 = piece & 2, b0 = piece & 1;
  const long long t = blockIdx.x / COS_QUARTERS;
  const int lane0 = (int)(blockIdx.x % COS_QUARTERS) * 32;
  const int lane = lane0 + 8 * piece + (x >> 2);  // the row whose whole dot x ends with
  const int4 qv = __ldg(q + piece);
  // load j of tile row r: piece x of the 8 rows lane0 + 8j ... lane0 + 8j + 7
  const int4* rows = db + (t * COS_TILE_ROWS * LANES + lane0) * COS_VECS + x;
  const float* norms = row_norm + t * COS_TILE_ROWS * LANES + lane;

  float best = -INFINITY;
  int best_r = 0;
  for (int r0 = 0; r0 < COS_TILE_ROWS; r0 += COS_STEP) {
    int4 v[COS_STEP][COS_VECS];
    float nr[COS_STEP];
#pragma unroll
    for (int s = 0; s < COS_STEP; ++s) {
#pragma unroll
      for (int j = 0; j < COS_VECS; ++j)
        v[s][j] = __ldg(rows + (long long)(r0 + s) * LANES * COS_VECS + j * 32);
      nr[s] = __ldg(norms + (long long)(r0 + s) * LANES);
    }
#pragma unroll
    for (int s = 0; s < COS_STEP; ++s) {
      int pd[COS_VECS];  // this piece's partial dot with rows 8j + x / 4
#pragma unroll
      for (int j = 0; j < COS_VECS; ++j) pd[j] = dot16(v[s][j], qv, 0);
      // reduce-scatter over the row's 4 threads: keep the half of the rows
      // named by piece bit 1 (xor 2), then the row named by bit 0 (xor 1)
      const int a0 = (b1 ? pd[2] : pd[0]) + __shfl_xor_sync(FULL, b1 ? pd[0] : pd[2], 2);
      const int a1 = (b1 ? pd[3] : pd[1]) + __shfl_xor_sync(FULL, b1 ? pd[1] : pd[3], 2);
      const int dot = (b0 ? a1 : a0) + __shfl_xor_sync(FULL, b0 ? a0 : a1, 1);
      const float sc = __int2float_rn(dot) / fmaxf(nr[s], NORM_FLOOR);
      if (sc > best) {  // rows ascending: '>' keeps the first
        best = sc;
        best_r = r0 + s;
      }
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
  const long long blocks = c / (COS_TILE_ROWS * LANES) * COS_QUARTERS;
  cosine_i8_cells_kernel<<<(unsigned)blocks, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(q8), static_cast<const int4*>(db8), row_norm, best, idx);
  return (int)cudaGetLastError();
}

// csrc/select.cu: the top-k selection over [q, n] candidates
extern "C" int ucfp_select_topk(const void* vals, const int* gidx, int kind, int q, int n, int k,
                                int largest, void* out_val, int* out_idx, void* scratch,
                                void* stream);

// #7 whole: the cells, then the selection over them (float32, largest
// first), from one host call; best / idx hold the cells, scratch as
// ucfp_select_topk's
extern "C" int ucfp_cosine_i8_topk(const void* q8, int d, const void* db8, long long c,
                                   const float* row_norm, int k, float* best, int* idx,
                                   float* out_val, int* out_idx, void* scratch, void* stream) {
  const int rc = ucfp_cosine_i8_cells(q8, d, db8, c, row_norm, best, idx, stream);
  if (rc != 0) return rc;
  // the selection's value kind 0: float32
  return ucfp_select_topk(best, idx, 0, 1, (int)(c / COS_TILE_ROWS), k, 1, out_val, out_idx,
                          scratch, stream);
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
