// Fused per-(tile, lane) candidate scans for the served top-k paths.
//
// Every kernel here computes the candidate cells of ucfp_tpu/ops/pallas_scan.py
// exactly: the catalog is viewed as [rows, 128] lanes, a tile is a run of
// rows, and each (tile, lane) cell keeps its best row -- ties go to the
// lowest row (the reference's _lane_argbest / _qblock_argbest). The final
// top-k over the tiles x 128 candidates is a kernel of its own
// (csrc/select.cu), as lax.top_k sits outside the Pallas call in the
// reference. The TPU block shapes ([R, W, 128] host transpose, SUB=8 output
// padding, query padding) were Mosaic workarounds and are not copied.
//
// ucfp_scores_cells replaces pallas_scan.scores_topk_fused_batched
// (_scores_kernel_batched) and, at Q = 1, pallas_scan.scores_topk_fused
// (_scores_kernel). Bound: device memory -- it reads each score once
// (Q*C*4 bytes for f32, half for bf16, 16 MB at C = 2^22) and does one
// compare per element; at one query that is 5 us of bytes, so what the
// kernel must avoid is latency: a 2^22-row catalog is only 128 tiles for
// the 132 SMs. Design: one block of 512 threads per (256-row tile,
// query); each thread makes 16-byte loads covering 4 (f32) or 8 (bf16)
// adjacent lanes, so a warp reads 512 contiguous bytes per step, and
// walks every 16th (f32) or 32nd (bf16) row of the tile with all its
// loads issued before the compares: 128 KB in flight per block, enough
// to cover the memory latency with one block per SM. Each thread keeps
// the first row of its best value per lane (strict '>', rows ascending);
// the row slices' winners meet in shared memory, where one thread per
// lane takes the best value and, among equal values, the lowest row, and
// writes that row's own element (a -0.0 keeps its sign bit).

// ucfp_hamming_batched_topk replaces pallas_scan.hamming_topk_fused_batched
// (_hamming_kernel_batched, pallas_scan.py:137, its pallas_call :200) and
// the lax.top_k after it: a cells kernel, then the selection (csrc/select.cu,
// int32, smallest first), launched from one host call. A cell is (128-row
// tile, lane): rows (t * 128 + r) * 128 + lane, r = 0..127 (the reference's
// rt = ROWS_PER_TILE // 2). It keeps its smallest distance and, among equal
// distances, the lowest r; an invalid row scores 2^30, so a cell with no
// valid row gives (2^30, r = 0). Bound: device memory. The function must
// read each row's 4W + 1 bytes once (75.5 MB at 2^23 rows x 2 words, 0.0225
// ms at 3.35 TB/s); its distances are an exact int8 product (below) of
// 2 * 16 * ceil(Q / 16) * C * 32W operations (0.017 ms at Q = 32 on the
// tensor cores) and one max per (query, row). Two cells kernels:
//  * Q < HAMMING_MMA_MIN_Q: hamming_stream_cells_kernel, #6's design at
//    #2's shapes. A block of 8 warps per (tile, 32-lane quarter): warp g
//    walks rows r = 16g..16g+15 of the tile, its 32 lanes side by side
//    (a warp's load is 32 adjacent rows, 256 contiguous bytes at W = 2,
//    and their 32 validity bytes), up to 8 rows' loads in flight before
//    their popcounts. The queries (at most HS_MAX_Q) sit in shared memory;
//    per query and row each thread takes W __popc and keeps
//    min((d << 8) + r), an invalid row adding 2^30 instead of r; the
//    warps' minima merge the same way. Q * W popcounts a row stay under
//    the bytes' time for a few queries only (16 per clock per SM).
//  * Q >= HAMMING_MMA_MIN_Q: hamming_mma_cells_kernel, the int8 tensor
//    cores (mma.sync.m16n8k32, s8 x u8, csrc/mma_s8.cuh). Hamming distance
//    is a dot product: with query bits as +1 / -1 and row bits as 0 / 1,
//    dot = popc(q & b) - popc(~q & b) and hamming = popc(q) - dot. A
//    (16 x 32) holds 16 queries, B (32 x 8) 8 adjacent lanes at one r, one
//    k32 step per 32-bit word (K = 32W, never padded). Any permutation of
//    K applied to both operands leaves the sum unchanged, so slot 4l + j
//    of a fragment holds bit l + 8j of the word and slot 16 + 4l + j bit
//    l + 4 + 8j: a thread moves its B bits to bit 7 of each byte with one
//    shift and one AND a register (u8 128 * bit), and A holds s8 +1 / -1,
//    built once per block and kept in registers, so a sum is 128 * dot.
//    The accumulator's input carries the rest of the key: 127 - r, less
//    2^22 for an invalid row. Each thread's sums are fixed (query, lane)
//    pairs (rows g and g + 8, columns 2l and 2l + 1 of the m16n8 tile), so
//    it keeps each cell's running best as one max per (query, row), a
//    three-way max over two steps of r (one DPX instruction): the largest
//    dot, then the lowest r, no shuffle. A persistent grid of blocks of 8
//    warps walks the (tile, 32-lane quarter) items, blockIdx.y the block
//    of up to 64 queries (fewer past W = 2: the A fragments' registers);
//    in an item, two 16-lane halves x four runs of 32 r. Each warp streams
//    its rows' words and validity bytes through a ring in shared memory
//    with cp.async, across the items its block takes, so the catalog is
//    read from device memory once per block of queries (the kernel it
//    replaces read it once per 8) and the next item's loads overlap this
//    one's products. The four runs merge by the same max (shared-memory
//    atomicMax, double-buffered by item); dist = popc(q) - dot, or (2^30,
//    r = 0) when every row was invalid (dot < -2^14 after the offset).
//    Queries past Q are zero rows of A and are not stored. What limits it
//    is the mma.sync rate, not the bytes: at Q = 32 the products alone
//    take ~2.5 times the bytes' time on an H100 (PERF.md section 6).
// HAMMING_MMA_MIN_Q comes from chip_smoke.py's sweep of both kernels
// (phase 3, kernels/hamming_paths; PERF.md section 6).
//
// ucfp_dots_norm_cells replaces pallas_scan.dots_norm_topk_fused
// (_dots_norm_kernel, pallas_scan.py:240) and
// pallas_scan.dots_norm_topk_fused_batched (_dots_norm_kernel_batched,
// pallas_scan.py:397): the int8 tier's cosine straight off the int32
// product, s = (float)dot / max(|row|, 1e-9) * (1/|q|) for rows below the
// prefix length n with |row| > 0, else -inf, then the per-cell argbest.
// Bound: device memory -- it must read each dot once and each row norm
// once, Q*C*4 + C*4 bytes (at Q = 32, C = 2^22 0.55 GB, 0.165 ms at
// 3.35 TB/s); per dot it does one conversion, one division and one
// product, a small share of the bytes' time, so what the kernel must do is
// keep enough bytes in flight. Design: one block of 256 threads (8 warps)
// per (256-row tile, block of up to 8 queries), the query blocks of one
// tile side by side in the grid so they meet its norms in L2. Warp w takes
// rows w, w + 8, ... of the tile, one row per step, and each thread 4
// adjacent lanes: 16-byte pieces, so a warp reads one row's 512
// contiguous bytes of norms and of each query's dots. The rows stream
// through a ring in shared memory, per warp, with cp.async: each slot
// holds a row's norms and its dots for every query of the block, and a
// thread copies exactly the pieces it reads back, so the ring needs no
// barrier; 2 rows of 8 queries (9 KB), or 7 rows of one query (7 KB), are
// in flight per warp: 150 KB per SM at two blocks of 8 queries, where
// loads held in registers kept under half of that. A row's norms are read
// once and used for every query of the block. Each thread keeps, per query
// and lane, the first row of its best value (strict '>', rows ascending,
// an all -inf run keeping its first row); the 8 warps' winners meet in
// shared memory (the ring's, once drained), 4 queries a round, where one
// thread per (query, lane) takes the best value and, among equal values,
// the lowest row with that row's own value (fused_scan.dots_norm_cells_
// sliced is this order in plain PyTorch). The division and the product
// stay two correctly rounded operations (no fast-math, no reciprocal), so
// the scores equal the reference's bit for bit while the dots are exact in
// float32 (|dot| < 2^24, D <= 1040).
//
// ucfp_hamming_topk_cells replaces pallas_scan.hamming_topk_fused
// (_hamming_kernel, pallas_scan.py:79), the single-query scan each shard of
// the sharded Hamming path runs: one query, no validity mask, tiles of 256
// rows x 128 lanes (pallas_scan.ROWS_PER_TILE, twice the batched kernel's
// tile). Bound: device memory -- it reads each row's 4W bytes once and does
// W popcounts per row, a quarter of the bytes' time at W = 2 (8 MB, 2.5 us
// at 2^20 rows; 80 MB, 24 us at 9,994,240). Design: a block of 8 warps per
// (tile, 32-lane quarter), so 2^20 rows give 128 blocks for the 132 SMs
// (one block per tile left 100 of them idle) and 9,994,240 rows 1,220
// small blocks that the block scheduler spreads evenly (a tile per block
// gave 305 blocks of 1,024 threads, 2.3 waves whose last ran 31% full).
// Warp g walks rows [32g, 32g + 32) of the tile, its 32 lanes side by side,
// so a warp's load is 32 adjacent rows (256 contiguous bytes at W = 2);
// up to 8 rows' loads are issued before their popcounts. Each thread keeps
// min((distance << 8) | row): the smallest distance, then the lowest row,
// and the warps' minima merge the same way, as in _lane_argbest.
// ucfp_hamming_topk launches it and the selection (csrc/select.cu) from
// one host call.
//
// Every entry point has a plain C interface (loaded with ctypes), launch
// on the caller's stream, allocate nothing, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"
#include "mma_s8.cuh"

namespace {

constexpr int LANES = 128;
constexpr int SCORE_TILE_ROWS = 256;  // pallas_scan.ROWS_PER_TILE
constexpr int HAM_TILE_ROWS = 128;    // pallas_scan.ROWS_PER_TILE // 2
constexpr int QSEL = 8;               // pallas_scan.QSEL
constexpr int MAX_WORDS = 16;         // pallas_scan.MAX_FUSED_HAMMING_WORDS
constexpr int INVALID_DIST = 1 << 30;
constexpr float NORM_FLOOR = 1e-9f;   // jnp.maximum(row_norm, 1e-9)
constexpr int MAX_DEVICES = 64;       // per-device launch caches


constexpr int CELL_THREADS = 512;  // scores cells: threads per (tile, query) block

__device__ __forceinline__ void unpack16(const uint4& w, float (&f)[4]) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}

__device__ __forceinline__ void unpack16(const uint4& w, float (&f)[8]) {
  const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 lane 2i in the low half-word
    f[2 * i] = __uint_as_float(x[i] << 16);
    f[2 * i + 1] = __uint_as_float(x[i] & 0xffff0000u);
  }
}

template <typename T, bool LARGEST>
__global__ void __launch_bounds__(CELL_THREADS)
scores_cells_kernel(const T* __restrict__ scores, long long c, int tiles,
                    T* __restrict__ best_out, int* __restrict__ idx_out) {
  constexpr int V = 16 / sizeof(T);           // lanes per 16-byte load
  constexpr int TPR = LANES / V;              // threads per row
  constexpr int RSTEP = CELL_THREADS / TPR;   // rows per step
  constexpr int STEPS = SCORE_TILE_ROWS / RSTEP;
  const int tid = threadIdx.x;
  const int rs = tid / TPR;  // row slice: rows rs, rs + RSTEP, ...
  const int l0 = (tid % TPR) * V;
  const int t = blockIdx.x;
  const long long q = blockIdx.y;
  const T* tile = scores + q * c + (long long)t * SCORE_TILE_ROWS * LANES;

  uint4 raw[STEPS];
#pragma unroll
  for (int st = 0; st < STEPS; ++st)
    raw[st] = __ldg(reinterpret_cast<const uint4*>(tile + (st * RSTEP + rs) * LANES + l0));
  float best[V];
  int best_r[V];
  unpack16(raw[0], best);
#pragma unroll
  for (int j = 0; j < V; ++j) best_r[j] = rs;
#pragma unroll
  for (int st = 1; st < STEPS; ++st) {
    float f[V];
    unpack16(raw[st], f);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (LARGEST ? (f[j] > best[j]) : (f[j] < best[j])) {
        best[j] = f[j];
        best_r[j] = st * RSTEP + rs;
      }
    }
  }

  __shared__ float s_val[RSTEP][LANES];
  __shared__ int s_row[RSTEP][LANES];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    s_val[rs][l0 + j] = best[j];
    s_row[rs][l0 + j] = best_r[j];
  }
  __syncthreads();
  if (tid >= LANES) return;
  const int lane = tid;
  float b = s_val[0][lane];
  int br = s_row[0][lane];
  for (int g = 1; g < RSTEP; ++g) {
    const float v = s_val[g][lane];
    const int r = s_row[g][lane];
    if (LARGEST ? (v > b) : (v < b)) {
      b = v;
      br = r;
    } else if (v == b && r < br) {
      br = r;
    }
  }
  const long long out = (q * tiles + t) * LANES + lane;
  // the winning row's own value, in the input type
  best_out[out] = tile[(long long)br * LANES + lane];
  idx_out[out] = (t * SCORE_TILE_ROWS + br) * LANES + lane;
}

constexpr int DN_THREADS = 256;                       // dots-norm cells: 8 warps
constexpr int DN_RSTEP = DN_THREADS / 32;             // one row per warp and step
constexpr int DN_STEPS = SCORE_TILE_ROWS / DN_RSTEP;  // 32 rows per warp
constexpr int DN_MERGE_Q = 4;                         // queries merged per round

// QB queries per block; each warp keeps R rows in a ring of shared memory,
// R - 1 of them in flight, each slot the row's norms and then each query's
// dots (QB + 1 chunks of 512 bytes); a thread copies (cp.async) exactly the
// 16-byte pieces it reads back, so the ring needs no barrier
template <int QB, int R>
__host__ __device__ constexpr int dn_smem_bytes() {
  return DN_THREADS / 32 * R * (QB + 1) * 512;
}

template <int QB, int R>
__global__ void __launch_bounds__(DN_THREADS, 2)
dots_norm_cells_kernel(const int* __restrict__ dots, int nq_total, long long c,
                       const float* __restrict__ row_norm, long long n,
                       const float* __restrict__ inv_q, int tiles,
                       float* __restrict__ best_out, int* __restrict__ idx_out) {
  static_assert(DN_STEPS >= R && R >= 2, "a ring of 2 to 32 rows");
  constexpr int MQ = QB < DN_MERGE_Q ? QB : DN_MERGE_Q;
  static_assert(dn_smem_bytes<QB, R>() >= MQ * DN_RSTEP * LANES * 8, "merge fits the ring");
  extern __shared__ __align__(16) uint4 dn_smem[];
  const int tid = threadIdx.x;
  const int rs = tid >> 5;          // row slice (the warp): rows rs, rs + 8, ...
  const int l0 = (tid & 31) * 4;    // lanes l0..l0+3
  const int q0 = blockIdx.x * QB;   // the query blocks of a tile run side by side
  const int t = blockIdx.y;
  const int nq = min(QB, nq_total - q0);
  const long long e0 = (long long)t * SCORE_TILE_ROWS * LANES + l0;
  // this thread's pieces: slot k, chunk j at ring[(k * (QB + 1) + j) * 32]
  uint4* ring = dn_smem + (long long)rs * R * (QB + 1) * 32 + (tid & 31);

  auto issue = [&](int st) {  // row st * 8 + rs into slot st % R
    const long long e = e0 + (long long)(st * DN_RSTEP + rs) * LANES;
    uint4* slot = ring + (st % R) * (QB + 1) * 32;
    cp_async16(slot, row_norm + e);
#pragma unroll
    for (int qi = 0; qi < QB; ++qi)
      if (qi < nq) cp_async16(slot + (1 + qi) * 32, dots + (long long)(q0 + qi) * c + e);
  };
#pragma unroll
  for (int st = 0; st < R - 1; ++st) {
    issue(st);
    cp_async_commit();
  }

  float iq[QB];
  float best[QB][4];
  int best_r[QB][4];
#pragma unroll
  for (int qi = 0; qi < QB; ++qi) {
    iq[qi] = qi < nq ? __ldg(inv_q + q0 + qi) : 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      best[qi][j] = -INFINITY;
      best_r[qi][j] = rs;
    }
  }
  for (int st = 0; st < DN_STEPS; ++st) {
    cp_async_wait<R - 2>();  // row st has landed
    if (st + R - 1 < DN_STEPS) issue(st + R - 1);  // into the slot row st - 1 left
    cp_async_commit();
    const uint4* slot = ring + (st % R) * (QB + 1) * 32;
    const int r = st * DN_RSTEP + rs;
    const long long e = e0 + (long long)r * LANES;
    const uint4 rn = slot[0];
    const float rv[4] = {__uint_as_float(rn.x), __uint_as_float(rn.y), __uint_as_float(rn.z),
                         __uint_as_float(rn.w)};
    bool ok[4];
    float den[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ok[j] = e + j < n && rv[j] > 0.0f;
      den[j] = fmaxf(rv[j], NORM_FLOOR);
    }
#pragma unroll
    for (int qi = 0; qi < QB; ++qi) {
      if (qi < nq) {
        const uint4 d = slot[(1 + qi) * 32];
        const int dv[4] = {(int)d.x, (int)d.y, (int)d.z, (int)d.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float sc = ok[j] ? (float)dv[j] / den[j] * iq[qi] : -INFINITY;
          if (sc > best[qi][j]) {
            best[qi][j] = sc;
            best_r[qi][j] = r;
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // the row slices' winners, MQ queries a round, in the ring's memory
  float(*s_val)[DN_RSTEP][LANES] = reinterpret_cast<float(*)[DN_RSTEP][LANES]>(dn_smem);
  int(*s_row)[DN_RSTEP][LANES] = reinterpret_cast<int(*)[DN_RSTEP][LANES]>(s_val + MQ);
#pragma unroll
  for (int m0 = 0; m0 < QB; m0 += MQ) {
    if (m0 >= nq) break;  // nq is the same for the whole block
    __syncthreads();  // every warp is done with the ring, or with the last round
#pragma unroll
    for (int mq = 0; mq < MQ; ++mq)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s_val[mq][rs][l0 + j] = best[m0 + mq][j];
        s_row[mq][rs][l0 + j] = best_r[m0 + mq][j];
      }
    __syncthreads();
    for (int cell = tid; cell < MQ * LANES; cell += DN_THREADS) {
      const int mq = cell / LANES, lane = cell % LANES;
      if (m0 + mq >= nq) continue;
      // the best value, and among equal values the lowest row (slices
      // interleave, so rows are compared), keeping that row's own value
      float b = s_val[mq][0][lane];
      int br = s_row[mq][0][lane];
      for (int g = 1; g < DN_RSTEP; ++g) {
        const float v = s_val[mq][g][lane];
        const int r = s_row[mq][g][lane];
        if (v > b || (v == b && r < br)) {
          b = v;
          br = r;
        }
      }
      const long long out = ((long long)(q0 + m0 + mq) * tiles + t) * LANES + lane;
      best_out[out] = b;
      idx_out[out] = (t * SCORE_TILE_ROWS + br) * LANES + lane;
    }
  }
}

// f(kernel, queries per block, dynamic shared memory) for the dots-norm
// cells kernel of q queries, its shared-memory cap set once per device
template <typename F>
int with_dots_norm_kernel(int q, F&& f) {
  static int ready[2][MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  auto run = [&](auto kernel, int qb, int smem, int& done) {
    if (!done) {
      const cudaError_t a =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (a != cudaSuccess) return (int)a;
      done = 1;
    }
    return f(kernel, qb, smem);
  };
  if (q == 1) return run(dots_norm_cells_kernel<1, 8>, 1, dn_smem_bytes<1, 8>(), ready[0][dev]);
  return run(dots_norm_cells_kernel<QSEL, 3>, QSEL, dn_smem_bytes<QSEL, 3>(), ready[1][dev]);
}

// W words of a row at p, in vector reads where aligned: from device memory
// through the read-only cache, or (SHARED) from shared memory
template <int W, bool SHARED = false>
__device__ __forceinline__ void load_row(const uint32_t* __restrict__ p, uint32_t (&rw)[W]) {
  auto rd = [](const auto* q) {
    if constexpr (SHARED)
      return *q;
    else
      return __ldg(q);
  };
  if constexpr (W % 4 == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const uint4 x = rd(v + i);
      rw[4 * i] = x.x;
      rw[4 * i + 1] = x.y;
      rw[4 * i + 2] = x.z;
      rw[4 * i + 3] = x.w;
    }
  } else if constexpr (W % 2 == 0) {
    const uint2* v = reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < W / 2; ++i) {
      const uint2 x = rd(v + i);
      rw[2 * i] = x.x;
      rw[2 * i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) rw[i] = rd(p + i);
  }
}

// the query's bits (bytes 0 or 1) as s8 +1 for a 1, -1 for a 0
__device__ __forceinline__ uint32_t plus_minus1(uint32_t x) { return 0xFFFFFFFFu ^ (x * 0xFEu); }

constexpr uint32_t BIT_BYTES = 0x01010101u;  // bit 0 of each byte
constexpr uint32_t TOP_BYTES = 0x80808080u;  // bit 7 of each byte

// #6's and #2's blocks: a (tile, 32-lane quarter) each, 8 warps
constexpr int HAM1_TILE_ROWS = 256;  // pallas_scan.ROWS_PER_TILE
constexpr int HAM1_LANES = 32;       // lanes per block: one warp's rows side by side
constexpr int HAM1_QUARTERS = LANES / HAM1_LANES;
constexpr int HAM1_GROUPS = 8;       // warps per block, each a run of rows
constexpr int HAM1_GROUP_ROWS = HAM1_TILE_ROWS / HAM1_GROUPS;

constexpr int HS_GROUP_ROWS = HAM_TILE_ROWS / HAM1_GROUPS;  // streaming cells: r a warp
constexpr int HS_MAX_Q = 8;                  // queries the streaming kernel takes
// the fewest queries the tensor-core kernel serves: chip_smoke.py's sweep
// (kernels/hamming_paths, 2^23 rows x 2 words) found the streaming cells
// faster on an H100 at every Q they take, 1 to 8 (PERF.md section 6)
constexpr int HAMMING_MMA_MIN_Q = HS_MAX_Q + 1;

template <int W>
__global__ void __launch_bounds__(HAM1_LANES * HAM1_GROUPS)
hamming_stream_cells_kernel(const uint32_t* __restrict__ queries, int nq,
                            const uint32_t* __restrict__ db, const uint8_t* __restrict__ valid,
                            int tiles, int* __restrict__ dist_out, int* __restrict__ idx_out) {
  constexpr int R = W <= 2 ? 8 : W <= 4 ? 4 : W <= 8 ? 2 : 1;  // rows in flight a thread
  static_assert(HS_GROUP_ROWS % R == 0, "whole batches of rows");
  __shared__ uint32_t s_q[HS_MAX_Q][W];
  __shared__ int s_best[HS_MAX_Q][HAM1_GROUPS][HAM1_LANES];
  const int x = threadIdx.x, group = threadIdx.y;
  const int tid = group * HAM1_LANES + x;
  const int lane = (int)(blockIdx.x % HAM1_QUARTERS) * HAM1_LANES + x;
  const long long t = blockIdx.x / HAM1_QUARTERS;
  for (int i = tid; i < nq * W; i += HAM1_LANES * HAM1_GROUPS)
    s_q[i / W][i % W] = __ldg(queries + i);
  __syncthreads();

  const int r0 = group * HS_GROUP_ROWS;
  const long long row0 = (t * HAM_TILE_ROWS + r0) * LANES + lane;
  int best[HS_MAX_Q];  // (d << 8) + r, or 2^30 + (d << 8) for an invalid row
#pragma unroll
  for (int qi = 0; qi < HS_MAX_Q; ++qi) best[qi] = 0x7fffffff;
  for (int r = 0; r < HS_GROUP_ROWS; r += R) {
    uint32_t rw[R][W];
    int rkey[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const long long row = row0 + (long long)(r + j) * LANES;
      load_row<W>(db + row * W, rw[j]);
      rkey[j] = __ldg(valid + row) ? r0 + r + j : INVALID_DIST;
    }
#pragma unroll
    for (int qi = 0; qi < HS_MAX_Q; ++qi) {
      if (qi < nq) {
        int d[R];
#pragma unroll
        for (int j = 0; j < R; ++j) d[j] = 0;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const uint32_t qw = s_q[qi][w];
#pragma unroll
          for (int j = 0; j < R; ++j) d[j] += __popc(qw ^ rw[j][w]);
        }
#pragma unroll
        for (int j = 0; j < R; ++j) best[qi] = min(best[qi], (d[j] << 8) + rkey[j]);
      }
    }
  }
#pragma unroll
  for (int qi = 0; qi < HS_MAX_Q; ++qi)
    if (qi < nq) s_best[qi][group][x] = best[qi];
  __syncthreads();
  for (int qi = group; qi < nq; qi += HAM1_GROUPS) {  // a warp per query
    int b = s_best[qi][0][x];
#pragma unroll
    for (int g = 1; g < HAM1_GROUPS; ++g) b = min(b, s_best[qi][g][x]);
    const bool invalid = b >= INVALID_DIST;  // the cell's every row
    const long long out = ((long long)qi * tiles + t) * LANES + lane;
    dist_out[out] = invalid ? INVALID_DIST : b >> 8;
    idx_out[out] = (int)((t * HAM_TILE_ROWS + (invalid ? 0 : b & 0xff)) * LANES + lane);
  }
}

constexpr int HM_THREADS = 32 * HAM1_GROUPS;  // tensor-core cells: threads per block
constexpr int HM_NT = 2;                       // n8 tiles a warp: 16 lanes
constexpr int HM_WARP_LANES = 8 * HM_NT;
constexpr int HM_RUNS = HAM1_GROUPS * HM_WARP_LANES / HAM1_LANES;  // runs of r per block
constexpr int HM_RUN = HAM_TILE_ROWS / HM_RUNS;               // 32 r a warp
constexpr int HM_INVALID = -(1 << 22);       // accumulator input of an invalid row
constexpr int HM_INVALID_DOT = HM_INVALID / 128 / 2;  // below it no row of the cell was valid

// the m16 tiles of queries a block keeps in registers (4W words of A
// fragments a tile, at most 32 words below W = 9)
template <int W>
__host__ __device__ constexpr int hm_mt_max() {
  return W <= 2 ? 4 : W <= 4 ? 2 : 1;
}

// a warp's ring: HM_RING stages of hm_stage_r<W> steps of r, each step 16
// rows' words (64W bytes) then their 16 validity bytes (a third stage in
// flight measured no faster at W = 2, and finer stages slower)
constexpr int HM_RING = 2;
template <int W>
__host__ __device__ constexpr int hm_stage_r() {
  return W <= 4 ? 8 : W <= 8 ? 4 : 2;
}
template <int W>
__host__ __device__ constexpr int hm_stage_bytes() {
  return hm_stage_r<W>() * (4 * W + 1) * 16;
}

// Persistent over the (tile, 32-lane quarter) items, blockIdx.y the block of
// up to 16 * MT queries. Each warp's ring streams its rows of every item the
// block takes, so the next item's loads overlap this item's products.
template <int W, int MT>
__global__ void __launch_bounds__(HM_THREADS, W <= 8 ? 2 : 1)
hamming_mma_cells_kernel(const uint32_t* __restrict__ queries, int nq_total,
                         const uint32_t* __restrict__ db, const uint8_t* __restrict__ valid,
                         int tiles, int* __restrict__ dist_out, int* __restrict__ idx_out) {
  constexpr int QB = 16 * MT;  // queries a block
  constexpr int RS = hm_stage_r<W>(), RING = HM_RING, STAGES = HM_RUN / RS;
  constexpr int STAGE_BYTES = hm_stage_bytes<W>();
  constexpr int WORD_CHUNKS = RS * 4 * W;  // 16-byte pieces of a stage's words
  static_assert(HM_RUN % RS == 0 && RS % 2 == 0, "whole stages of pairs of steps");
  __shared__ __align__(16) uint8_t s_ring[HAM1_GROUPS * RING * STAGE_BYTES];
  __shared__ int s_key[2][QB][HAM1_LANES + 1];  // by item parity
  __shared__ int s_pq[QB];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, l = lane & 3;
  const int half = warp % 2, run = warp / 2;
  const int q0 = blockIdx.y * QB;
  const int nq = min(QB, nq_total - q0);
  const int mt_n = (nq + 15) / 16;
  const int items = tiles * HAM1_QUARTERS;
  const int my_items = (int)blockIdx.x < items ? (items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  uint8_t* ring = s_ring + warp * RING * STAGE_BYTES;
  // the warp's rows of item cb at step s of its run: rows(cb) + s * 128 .. + 15
  auto rows = [&](int cb) {
    return ((long long)(cb / HAM1_QUARTERS) * HAM_TILE_ROWS + run * HM_RUN) * LANES +
           (cb % HAM1_QUARTERS) * HAM1_LANES + half * HM_WARP_LANES;
  };
  // the warp's stream of stages over the block's items, fetched RING ahead
  // of the one consumed: item p_it's stage p_st into slot p_slot
  int p_it = 0, p_st = 0, p_slot = 0;
  auto fetch_next = [&]() {
    if (p_it < my_items) {
      const long long rbase = rows(blockIdx.x + p_it * gridDim.x) + (long long)p_st * RS * LANES;
      uint8_t* slot = ring + p_slot * STAGE_BYTES;
#pragma unroll
      for (int ch = lane; ch < RS * (4 * W + 1); ch += 32) {  // pieces spread over the warp
        if (ch < WORD_CHUNKS)
          cp_async16(slot + ch * 16,
                     db + (rbase + (ch / (4 * W)) * LANES) * W + (ch % (4 * W)) * 4);
        else
          cp_async16(slot + ch * 16, valid + rbase + (ch - WORD_CHUNKS) * LANES);
      }
    }
    if (++p_st == STAGES) p_st = 0, ++p_it;
    if (++p_slot == RING) p_slot = 0;
  };
#pragma unroll
  for (int i = 0; i < RING; ++i) {
    fetch_next();
    cp_async_commit();
  }

  const uint32_t* qp = queries + (long long)q0 * W;
  for (int i = tid; i < QB; i += HM_THREADS) {
    int pc = 0;
    if (i < nq)
      for (int w = 0; w < W; ++w) pc += __popc(__ldg(qp + i * W + w));
    s_pq[i] = pc;
  }
  for (int i = tid; i < 2 * QB * (HAM1_LANES + 1); i += HM_THREADS) (&s_key[0][0][0])[i] = INT_MIN;
  // A fragments of m tile m, k32 step w: queries 16m + g (a0, a2) and
  // 16m + g + 8 (a1, a3); zero past Q
  uint32_t a[MT][W][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = 16 * m + 8 * h + g;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const uint32_t x = qi < nq ? __ldg(qp + qi * W + w) : 0u;
        a[m][w][h] = qi < nq ? plus_minus1((x >> l) & BIT_BYTES) : 0u;
        a[m][w][2 + h] = qi < nq ? plus_minus1((x >> (l + 4)) & BIT_BYTES) : 0u;
      }
    }
  // B bytes: bit l + 8j (b0) or l + 4 + 8j (b1) of the word moved to bit 7
  // of byte j by one shift and kept by one AND
  const int up0 = 7 - l, up1 = 3 - l;
  __syncthreads();  // s_pq and s_key are set

  int c_slot = 0;  // the slot being consumed
  for (int it = 0; it < my_items; ++it) {
    const int cb = blockIdx.x + it * gridDim.x;
    int best[MT][HM_NT][4];  // 128 * dot + 127 - r, less 2^22 for an invalid row
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nt = 0; nt < HM_NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) best[m][nt][i] = INT_MIN;
    for (int st = 0; st < STAGES; ++st) {
      cp_async_wait<RING - 1>();  // this lane's pieces of the stage have landed
      __syncwarp();               // ... and every lane's
      const uint8_t* slot = ring + c_slot * STAGE_BYTES;
#pragma unroll
      for (int s = 0; s < RS; s += 2) {  // two steps of r, one three-way max
#pragma unroll
        for (int nt = 0; nt < HM_NT; ++nt) {
          uint32_t b[2][W][2];
          int c_even[2], c_odd[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            uint32_t rw[W];
            load_row<W, true>(
                reinterpret_cast<const uint32_t*>(slot + (s + u) * 64 * W) + (8 * nt + g) * W,
                rw);
#pragma unroll
            for (int w = 0; w < W; ++w) {
              b[u][w][0] = (rw[w] << up0) & TOP_BYTES;
              b[u][w][1] = (rw[w] << up1) & TOP_BYTES;
            }
            // validity of lanes 2l and 2l + 1 of the n8 tile
            const uint32_t vv = *reinterpret_cast<const unsigned short*>(
                slot + WORD_CHUNKS * 16 + (s + u) * 16 + 8 * nt + 2 * l);
            const int off = HAM_TILE_ROWS - 1 - (run * HM_RUN + st * RS + s + u) + HM_INVALID;
            c_even[u] = (int)(vv & 0xff) * -HM_INVALID + off;
            c_odd[u] = (int)(vv >> 8) * -HM_INVALID + off;
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m < mt_n) {
              int d[2][4];
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                mma_s8u8_c(d[u], a[m][0][0], a[m][0][1], a[m][0][2], a[m][0][3], b[u][0][0],
                           b[u][0][1], c_even[u], c_odd[u], c_even[u], c_odd[u]);
#pragma unroll
                for (int w = 1; w < W; ++w)
                  mma_s8u8(d[u], a[m][w][0], a[m][w][1], a[m][w][2], a[m][w][3], b[u][w][0],
                           b[u][w][1]);
              }
#pragma unroll
              for (int i = 0; i < 4; ++i)
                best[m][nt][i] = __vimax3_s32(best[m][nt][i], d[0][i], d[1][i]);
            }
          }
        }
      }
      __syncwarp();  // every lane is done with the slot
      fetch_next();
      cp_async_commit();
      if (++c_slot == RING) c_slot = 0;
    }

    // the runs merge by the same max
    int(*keys)[HAM1_LANES + 1] = s_key[it & 1];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m >= mt_n) break;
#pragma unroll
      for (int nt = 0; nt < HM_NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          atomicMax(
              &keys[16 * m + 8 * (i >> 1) + g][half * HM_WARP_LANES + 8 * nt + 2 * l + (i & 1)],
              best[m][nt][i]);
    }
    __syncthreads();  // every run's keys are in; the other parity's readout is done
    const long long t = cb / HAM1_QUARTERS;
    const int quarter = cb % HAM1_QUARTERS;
    for (int cell = tid; cell < nq * HAM1_LANES; cell += HM_THREADS) {
      const int qi = cell / HAM1_LANES, lq = cell % HAM1_LANES;
      const int key = keys[qi][lq];
      keys[qi][lq] = INT_MIN;  // for item it + 2
      const int dot = key >> 7;  // floor: the key's low 7 bits are 127 - r
      const bool invalid = dot < HM_INVALID_DOT;
      const int out_lane = quarter * HAM1_LANES + lq;
      const long long out = ((long long)(q0 + qi) * tiles + t) * LANES + out_lane;
      dist_out[out] = invalid ? INVALID_DIST : s_pq[qi] - dot;
      idx_out[out] = (int)((t * HAM_TILE_ROWS +
                            (invalid ? 0 : HAM_TILE_ROWS - 1 - (key & 127))) * LANES + out_lane);
    }
  }
  cp_async_wait<0>();
}

// blocks of the persistent grid: the card's SMs times the kernel's blocks
// per SM, asked once per device
template <int W, int MT>
int hamming_mma_grid(int items, int* grid) {
  static int resident[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hamming_mma_cells_kernel<W, MT>,
                                                      HM_THREADS, 0);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *grid = (int)(items < resident[dev] ? items : resident[dev]);
  return 0;
}

template <int W, int MT>
int launch_hamming_mma(const uint32_t* queries, int q, const uint32_t* db, const uint8_t* valid,
                       int tiles, int* dist, int* idx, cudaStream_t s) {
  int grid = 0;
  const int e = hamming_mma_grid<W, MT>(tiles * HAM1_QUARTERS, &grid);
  if (e != 0) return e;
  const dim3 blocks(grid, (q + 16 * MT - 1) / (16 * MT));
  hamming_mma_cells_kernel<W, MT><<<blocks, HM_THREADS, 0, s>>>(queries, q, db, valid, tiles,
                                                                dist, idx);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, W>) for a row width of w words, 1..16
template <typename F>
int with_words(int w, F&& f) {
  switch (w) {
#define UCFP_WORDS_CASE(N) \
  case N:                  \
    return f(std::integral_constant<int, N>{});
    UCFP_WORDS_CASE(1) UCFP_WORDS_CASE(2) UCFP_WORDS_CASE(3) UCFP_WORDS_CASE(4)
    UCFP_WORDS_CASE(5) UCFP_WORDS_CASE(6) UCFP_WORDS_CASE(7) UCFP_WORDS_CASE(8)
    UCFP_WORDS_CASE(9) UCFP_WORDS_CASE(10) UCFP_WORDS_CASE(11) UCFP_WORDS_CASE(12)
    UCFP_WORDS_CASE(13) UCFP_WORDS_CASE(14) UCFP_WORDS_CASE(15) UCFP_WORDS_CASE(16)
#undef UCFP_WORDS_CASE
  }
  return (int)cudaErrorInvalidValue;
}

template <int W>
__global__ void __launch_bounds__(HAM1_LANES * HAM1_GROUPS)
hamming1_cells_kernel(const uint32_t* __restrict__ query, const uint32_t* __restrict__ db,
                      int* __restrict__ dist_out, int* __restrict__ idx_out) {
  constexpr int R = W <= 2 ? 8 : W <= 4 ? 4 : W <= 8 ? 2 : 1;  // rows in flight a thread
  const int x = threadIdx.x;
  const int lane = (int)(blockIdx.x % HAM1_QUARTERS) * HAM1_LANES + x;
  const int group = threadIdx.y;
  const long long t = blockIdx.x / HAM1_QUARTERS;
  uint32_t q[W];
#pragma unroll
  for (int w = 0; w < W; ++w) q[w] = __ldg(query + w);

  const int r0 = group * HAM1_GROUP_ROWS;
  const uint32_t* p = db + ((t * HAM1_TILE_ROWS + r0) * LANES + lane) * W;
  int best = 0x7fffffff;  // (distance << 8) | row; a distance is at most 512
  for (int r = 0; r < HAM1_GROUP_ROWS; r += R) {
    uint32_t rw[R][W];
#pragma unroll
    for (int j = 0; j < R; ++j) load_row<W>(p + (long long)(r + j) * LANES * W, rw[j]);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      int d = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) d += __popc(q[w] ^ rw[j][w]);
      best = min(best, (d << 8) | (r0 + r + j));
    }
  }

  __shared__ int s_best[HAM1_GROUPS][HAM1_LANES];
  s_best[group][x] = best;
  __syncthreads();
  if (group != 0) return;
#pragma unroll
  for (int g = 1; g < HAM1_GROUPS; ++g) best = min(best, s_best[g][x]);
  const long long out = t * LANES + lane;
  dist_out[out] = best >> 8;
  idx_out[out] = (int)((t * HAM1_TILE_ROWS + (best & 0xff)) * LANES + lane);
}

}  // namespace

extern "C" int ucfp_scores_cells(const void* scores, int is_bf16, int largest, int q,
                                 long long c, void* best, int* idx, void* stream) {
  if (q <= 0 || q > 65535 || c <= 0 || c % (SCORE_TILE_ROWS * LANES) != 0)
    return (int)cudaErrorInvalidValue;
  const int tiles = (int)(c / (SCORE_TILE_ROWS * LANES));
  const dim3 grid(tiles, q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const auto* in = static_cast<const __nv_bfloat16*>(scores);
    auto* out = static_cast<__nv_bfloat16*>(best);
    if (largest)
      scores_cells_kernel<__nv_bfloat16, true><<<grid, CELL_THREADS, 0, s>>>(in, c, tiles, out,
                                                                           idx);
    else
      scores_cells_kernel<__nv_bfloat16, false><<<grid, CELL_THREADS, 0, s>>>(in, c, tiles, out,
                                                                            idx);
  } else {
    const auto* in = static_cast<const float*>(scores);
    auto* out = static_cast<float*>(best);
    if (largest)
      scores_cells_kernel<float, true><<<grid, CELL_THREADS, 0, s>>>(in, c, tiles, out, idx);
    else
      scores_cells_kernel<float, false><<<grid, CELL_THREADS, 0, s>>>(in, c, tiles, out, idx);
  }
  return (int)cudaGetLastError();
}

// csrc/select.cu: the top-k selection over [q, n] candidates
extern "C" int ucfp_select_topk(const void* vals, const int* gidx, int kind, int q, int n, int k,
                                int largest, void* out_val, int* out_idx, void* scratch,
                                void* stream);

// #1 / #3 whole: the cells, then the selection over them, launched back to
// back from one host call (the wrapper's host time is most of a small
// scan's time); best / idx hold the cells, scratch as ucfp_select_topk's
extern "C" int ucfp_scores_topk(const void* scores, int is_bf16, int largest, int q,
                                long long c, int k, void* best, int* idx, void* out_val,
                                int* out_idx, void* scratch, void* stream) {
  const int rc = ucfp_scores_cells(scores, is_bf16, largest, q, c, best, idx, stream);
  if (rc != 0) return rc;
  const long long n = c / SCORE_TILE_ROWS;  // (tile, lane) cells per query
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // the selection's value kinds: 0 float32, 1 bfloat16
  return ucfp_select_topk(best, idx, is_bf16 ? 1 : 0, q, (int)n, k, largest, out_val, out_idx,
                          scratch, stream);
}

// path: -1 picks by q (the streaming kernel below HAMMING_MMA_MIN_Q), 0 the
// streaming kernel (q <= HS_MAX_Q), 1 the tensor cores
extern "C" int ucfp_hamming_cells(const uint32_t* queries, int q, int w, const uint32_t* db,
                                  const uint8_t* valid, long long c, int* dist, int* idx,
                                  int path, void* stream) {
  if (q <= 0 || q > 65535 || w < 1 || w > MAX_WORDS || c <= 0 ||
      c % (HAM_TILE_ROWS * LANES) != 0 || c > (1LL << 31))  // int32 row indices
    return (int)cudaErrorInvalidValue;
  if (path < 0) path = q < HAMMING_MMA_MIN_Q ? 0 : 1;
  const int tiles = (int)(c / (HAM_TILE_ROWS * LANES));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 0) {
    if (q > HS_MAX_Q) return (int)cudaErrorInvalidValue;
    return with_words(w, [&](auto wc) {
      constexpr int W = decltype(wc)::value;
      const dim3 block(HAM1_LANES, HAM1_GROUPS);
      hamming_stream_cells_kernel<W><<<tiles * HAM1_QUARTERS, block, 0, s>>>(queries, q, db, valid,
                                                                            tiles, dist, idx);
      return (int)cudaGetLastError();
    });
  }
  if (path != 1) return (int)cudaErrorInvalidValue;
  // m16 tiles of queries a block: as few as Q needs, at most what its
  // registers hold; more queries take more blocks of each tile
  const int need = ((q < 64 ? q : 64) + 15) / 16;
  return with_words(w, [&](auto wc) {
    constexpr int W = decltype(wc)::value;
    constexpr int MT_MAX = hm_mt_max<W>();
    if (need <= 1 || MT_MAX == 1)
      return launch_hamming_mma<W, 1>(queries, q, db, valid, tiles, dist, idx, s);
    if constexpr (MT_MAX >= 4) {
      if (need > 2) return launch_hamming_mma<W, 4>(queries, q, db, valid, tiles, dist, idx, s);
    }
    return launch_hamming_mma<W, (MT_MAX >= 2 ? 2 : 1)>(queries, q, db, valid, tiles, dist, idx,
                                                       s);
  });
}

// #2 whole: the cells, then the selection over them (int32 distances,
// smallest first), from one host call; dist / idx hold the [q, c / 128]
// cells, scratch as ucfp_select_topk's
extern "C" int ucfp_hamming_batched_topk(const uint32_t* queries, int q, int w,
                                         const uint32_t* db, const uint8_t* valid, long long c,
                                         int k, int path, int* dist, int* idx, int* out_dist,
                                         int* out_idx, void* scratch, void* stream) {
  const int rc = ucfp_hamming_cells(queries, q, w, db, valid, c, dist, idx, path, stream);
  if (rc != 0) return rc;
  // the selection's value kind 2: int32
  return ucfp_select_topk(dist, idx, 2, q, (int)(c / HAM_TILE_ROWS), k, 0, out_dist, out_idx,
                          scratch, stream);
}

// #2's path rule at w words: info[0] = HAMMING_MMA_MIN_Q, info[1] =
// HS_MAX_Q, info[2] = the queries a block of the tensor-core kernel takes
extern "C" int ucfp_hamming_paths_info(int w, int* info) {
  if (w < 1 || w > MAX_WORDS) return (int)cudaErrorInvalidValue;
  info[0] = HAMMING_MMA_MIN_Q;
  info[1] = HS_MAX_Q;
  info[2] = with_words(w, [](auto wc) { return 16 * hm_mt_max<decltype(wc)::value>(); });
  return 0;
}

extern "C" int ucfp_hamming_topk_cells(const uint32_t* query, int w, const uint32_t* db,
                                       long long c, int* dist, int* idx, void* stream) {
  if (w < 1 || w > MAX_WORDS || c <= 0 || c % (HAM1_TILE_ROWS * LANES) != 0 ||
      c > (1LL << 31))  // int32 row indices
    return (int)cudaErrorInvalidValue;
  const long long blocks = c / (HAM1_TILE_ROWS * LANES) * HAM1_QUARTERS;
  const dim3 block(HAM1_LANES, HAM1_GROUPS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
#define UCFP_HAMMING1_CASE(N) \
  case N:                     \
    hamming1_cells_kernel<N><<<(unsigned)blocks, block, 0, s>>>(query, db, dist, idx); \
    break;
    UCFP_HAMMING1_CASE(1) UCFP_HAMMING1_CASE(2) UCFP_HAMMING1_CASE(3) UCFP_HAMMING1_CASE(4)
    UCFP_HAMMING1_CASE(5) UCFP_HAMMING1_CASE(6) UCFP_HAMMING1_CASE(7) UCFP_HAMMING1_CASE(8)
    UCFP_HAMMING1_CASE(9) UCFP_HAMMING1_CASE(10) UCFP_HAMMING1_CASE(11) UCFP_HAMMING1_CASE(12)
    UCFP_HAMMING1_CASE(13) UCFP_HAMMING1_CASE(14) UCFP_HAMMING1_CASE(15) UCFP_HAMMING1_CASE(16)
#undef UCFP_HAMMING1_CASE
  }
  return (int)cudaGetLastError();
}

// #6 whole: the cells, then the selection over them (int32 distances,
// smallest first), from one host call; dist / idx hold the cells, scratch
// as ucfp_select_topk's
extern "C" int ucfp_hamming_topk(const uint32_t* query, int w, const uint32_t* db, long long c,
                                 int k, int* dist, int* idx, int* out_dist, int* out_idx,
                                 void* scratch, void* stream) {
  const int rc = ucfp_hamming_topk_cells(query, w, db, c, dist, idx, stream);
  if (rc != 0) return rc;
  // the selection's value kind 2: int32
  return ucfp_select_topk(dist, idx, 2, 1, (int)(c / HAM1_TILE_ROWS), k, 0, out_dist, out_idx,
                          scratch, stream);
}

extern "C" int ucfp_dots_norm_cells(const int* dots, int q, long long c, const float* row_norm,
                                    long long n, const float* inv_q, float* best, int* idx,
                                    void* stream) {
  if (q <= 0 || (q + QSEL - 1) / QSEL > 65535 || c <= 0 ||
      c % (SCORE_TILE_ROWS * LANES) != 0 || c > (1LL << 31))  // int32 row indices
    return (int)cudaErrorInvalidValue;
  const int tiles = (int)(c / (SCORE_TILE_ROWS * LANES));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dots_norm_kernel(q, [&](auto kernel, int qb, int smem) {
    kernel<<<dim3((q + qb - 1) / qb, tiles), DN_THREADS, smem, s>>>(
        dots, q, c, row_norm, n, inv_q, tiles, best, idx);
    return (int)cudaGetLastError();
  });
}

// blocks per SM of the dots-norm cells kernel that serves q queries
extern "C" int ucfp_dots_norm_blocks_per_sm(int q, int* per_sm) {
  if (q <= 0) return (int)cudaErrorInvalidValue;
  return with_dots_norm_kernel(q, [&](auto kernel, int, int smem) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, DN_THREADS, smem);
  });
}
