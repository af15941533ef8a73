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

// ucfp_hamming_cells replaces pallas_scan.hamming_topk_fused_batched
// (_hamming_kernel_batched). Bound: the popcount issue rate once a block
// holds more than a few queries. Compute capability 9.0 issues __popc at
// 16 per clock per SM, a quarter of its XOR/add/compare rate (64), so the
// W popcounts per (query, row) take longer than reading the row's 4W + 1
// bytes from device memory whenever Q * W / (4W + 1) exceeds about 1.25
// (Q >= 6 at W = 2); a single query is bound by device memory. Design:
// one block per (128-row tile, block of <= 8 queries), so each row is
// read once per 8 queries; one thread per lane walking its 128 rows in
// ascending order straight from the [C, W] layout (adjacent lanes read
// adjacent rows, vector loads of the row's words); the query block in
// shared memory (broadcast reads); one __popc per word and query, the
// fewest the function needs; and a strict '<' so the first row of the
// minimum wins. Moving part of the popcounts onto the 64-per-clock
// integer pipe (a SWAR count) is left for a later change.
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
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int LANES = 128;
constexpr int SCORE_TILE_ROWS = 256;  // pallas_scan.ROWS_PER_TILE
constexpr int HAM_TILE_ROWS = 128;    // pallas_scan.ROWS_PER_TILE // 2
constexpr int QSEL = 8;               // pallas_scan.QSEL
constexpr int MAX_WORDS = 16;         // pallas_scan.MAX_FUSED_HAMMING_WORDS
constexpr int INVALID_DIST = 1 << 30;
constexpr float NORM_FLOOR = 1e-9f;   // jnp.maximum(row_norm, 1e-9)


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
constexpr int DN_MAX_DEVICES = 64;

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
  static int ready[2][DN_MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= DN_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
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

template <int W>
__device__ __forceinline__ void load_row(const uint32_t* __restrict__ p, uint32_t (&rw)[W]) {
  if constexpr (W % 4 == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const uint4 x = __ldg(v + i);
      rw[4 * i] = x.x;
      rw[4 * i + 1] = x.y;
      rw[4 * i + 2] = x.z;
      rw[4 * i + 3] = x.w;
    }
  } else if constexpr (W % 2 == 0) {
    const uint2* v = reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < W / 2; ++i) {
      const uint2 x = __ldg(v + i);
      rw[2 * i] = x.x;
      rw[2 * i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) rw[i] = __ldg(p + i);
  }
}

template <int W>
__global__ void __launch_bounds__(LANES)
hamming_cells_kernel(const uint32_t* __restrict__ queries, int nq_total,
                     const uint32_t* __restrict__ db, const uint8_t* __restrict__ valid,
                     int tiles, int* __restrict__ dist_out, int* __restrict__ idx_out) {
  const int lane = threadIdx.x;
  const int t = blockIdx.x;
  const int q0 = blockIdx.y * QSEL;
  const int nq = min(QSEL, nq_total - q0);

  __shared__ uint32_t s_q[QSEL][W];
  for (int i = lane; i < QSEL * W; i += LANES) {
    const int qi = i / W;
    s_q[qi][i % W] = qi < nq ? queries[(long long)(q0 + qi) * W + i % W] : 0u;
  }
  __syncthreads();

  int best[QSEL];
  int best_r[QSEL];
#pragma unroll
  for (int qi = 0; qi < QSEL; ++qi) {
    best[qi] = 0x7fffffff;
    best_r[qi] = 0;
  }
  for (int r = 0; r < HAM_TILE_ROWS; ++r) {
    const long long row = ((long long)t * HAM_TILE_ROWS + r) * LANES + lane;
    uint32_t rw[W];
    load_row<W>(db + row * W, rw);
    const bool ok = valid[row] != 0;
#pragma unroll
    for (int qi = 0; qi < QSEL; ++qi) {
      int d = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) d += __popc(s_q[qi][w] ^ rw[w]);
      if (!ok) d = INVALID_DIST;
      if (d < best[qi]) {
        best[qi] = d;
        best_r[qi] = r;
      }
    }
  }
#pragma unroll
  for (int qi = 0; qi < QSEL; ++qi) {
    if (qi < nq) {
      const long long out = ((long long)(q0 + qi) * tiles + t) * LANES + lane;
      dist_out[out] = best[qi];
      idx_out[out] = (t * HAM_TILE_ROWS + best_r[qi]) * LANES + lane;
    }
  }
}

template <int W>
void launch_hamming(const uint32_t* queries, int q, const uint32_t* db, const uint8_t* valid,
                    int tiles, int* dist, int* idx, cudaStream_t stream) {
  const dim3 grid(tiles, (q + QSEL - 1) / QSEL);
  hamming_cells_kernel<W><<<grid, LANES, 0, stream>>>(queries, q, db, valid, tiles, dist, idx);
}

constexpr int HAM1_TILE_ROWS = 256;  // pallas_scan.ROWS_PER_TILE
constexpr int HAM1_LANES = 32;       // lanes per block: one warp's rows side by side
constexpr int HAM1_QUARTERS = LANES / HAM1_LANES;
constexpr int HAM1_GROUPS = 8;       // warps per block, each a run of rows
constexpr int HAM1_GROUP_ROWS = HAM1_TILE_ROWS / HAM1_GROUPS;

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

extern "C" int ucfp_hamming_cells(const uint32_t* queries, int q, int w, const uint32_t* db,
                                  const uint8_t* valid, long long c, int* dist, int* idx,
                                  void* stream) {
  if (q <= 0 || (q + QSEL - 1) / QSEL > 65535 || w < 1 || w > MAX_WORDS || c <= 0 ||
      c % (HAM_TILE_ROWS * LANES) != 0)
    return (int)cudaErrorInvalidValue;
  const int tiles = (int)(c / (HAM_TILE_ROWS * LANES));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
#define UCFP_HAMMING_CASE(N) \
  case N:                    \
    launch_hamming<N>(queries, q, db, valid, tiles, dist, idx, s); \
    break;
    UCFP_HAMMING_CASE(1) UCFP_HAMMING_CASE(2) UCFP_HAMMING_CASE(3) UCFP_HAMMING_CASE(4)
    UCFP_HAMMING_CASE(5) UCFP_HAMMING_CASE(6) UCFP_HAMMING_CASE(7) UCFP_HAMMING_CASE(8)
    UCFP_HAMMING_CASE(9) UCFP_HAMMING_CASE(10) UCFP_HAMMING_CASE(11) UCFP_HAMMING_CASE(12)
    UCFP_HAMMING_CASE(13) UCFP_HAMMING_CASE(14) UCFP_HAMMING_CASE(15) UCFP_HAMMING_CASE(16)
#undef UCFP_HAMMING_CASE
  }
  return (int)cudaGetLastError();
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
