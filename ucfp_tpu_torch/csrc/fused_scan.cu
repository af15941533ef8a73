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
// Bound: device memory -- it reads each dot once and each row norm once
// per query block, Q*C*4 + ceil(Q/8)*C*4 bytes (at Q = 32, C = 2^23 about
// 1.1 GiB, 0.33 ms at 3.35 TB/s), and does one division and one product
// per dot. Design: the scores kernel's shape (one block per (256-row tile,
// block of <= 8 queries); 128 lanes x 8 row groups, coalesced loads,
// group winners merged in row order with a strict '>'), and each thread
// loads a row's norm once for all the queries of its block. The division
// and the product stay two correctly rounded operations (no fast-math,
// no reciprocal), so the scores equal the reference's bit for bit while
// the dots are exact in float32 (|dot| < 2^24, D <= 1040).
//
// ucfp_hamming_topk_cells replaces pallas_scan.hamming_topk_fused
// (_hamming_kernel, pallas_scan.py:79), the single-query scan each shard of
// the sharded Hamming path runs: one query, no validity mask, tiles of 256
// rows x 128 lanes (pallas_scan.ROWS_PER_TILE, twice the batched kernel's
// tile). Bound: device memory -- it reads each row's 4W bytes once and does
// W popcounts per row, a quarter of the bytes' time at W = 2. Design: the
// scores kernel's shape (one block per tile; 128 lanes x 8 row groups of 32
// rows, so a warp reads 32 consecutive rows per step and a block keeps 1,024
// loads in flight), the query in registers, a strict '<' inside a group and
// the group winners merged in row order, so the first row of the minimum
// wins as in _lane_argbest.
//
// Every entry point has a plain C interface (loaded with ctypes), launch
// on the caller's stream, allocate nothing, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int SCORE_TILE_ROWS = 256;  // pallas_scan.ROWS_PER_TILE
constexpr int SCORE_GROUPS = 8;       // row groups per scores block
constexpr int SCORE_GROUP_ROWS = SCORE_TILE_ROWS / SCORE_GROUPS;
constexpr int HAM_TILE_ROWS = 128;    // pallas_scan.ROWS_PER_TILE // 2
constexpr int QSEL = 8;               // pallas_scan.QSEL
constexpr int MAX_WORDS = 16;         // pallas_scan.MAX_FUSED_HAMMING_WORDS
constexpr int INVALID_DIST = 1 << 30;
constexpr float NORM_FLOOR = 1e-9f;   // jnp.maximum(row_norm, 1e-9)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

__global__ void __launch_bounds__(LANES * SCORE_GROUPS)
dots_norm_cells_kernel(const int* __restrict__ dots, int nq_total, long long c,
                       const float* __restrict__ row_norm, long long n,
                       const float* __restrict__ inv_q, int tiles,
                       float* __restrict__ best_out, int* __restrict__ idx_out) {
  const int lane = threadIdx.x;
  const int group = threadIdx.y;
  const int t = blockIdx.x;
  const int q0 = blockIdx.y * QSEL;
  const int nq = min(QSEL, nq_total - q0);

  float iq[QSEL];
  float best[QSEL];
  int best_r[QSEL];
#pragma unroll
  for (int qi = 0; qi < QSEL; ++qi) {
    iq[qi] = qi < nq ? inv_q[q0 + qi] : 0.0f;
    best[qi] = -INFINITY;
    best_r[qi] = 0;
  }
  const int r0 = group * SCORE_GROUP_ROWS;
  for (int r = 0; r < SCORE_GROUP_ROWS; ++r) {
    const long long row = ((long long)t * SCORE_TILE_ROWS + r0 + r) * LANES + lane;
    const float rn = row_norm[row];
    const bool ok = row < n && rn > 0.0f;
    const float denom = fmaxf(rn, NORM_FLOOR);
#pragma unroll
    for (int qi = 0; qi < QSEL; ++qi) {
      if (qi < nq) {
        const float d = (float)dots[(long long)(q0 + qi) * c + row];
        const float s = ok ? d / denom * iq[qi] : -INFINITY;
        if (s > best[qi]) {
          best[qi] = s;
          best_r[qi] = r;
        }
      }
    }
  }

  __shared__ float s_val[SCORE_GROUPS][LANES];
  __shared__ int s_row[SCORE_GROUPS][LANES];
#pragma unroll
  for (int qi = 0; qi < QSEL; ++qi) {
    if (qi >= nq) break;  // nq is the same for the whole block
    s_val[group][lane] = best[qi];
    s_row[group][lane] = r0 + best_r[qi];
    __syncthreads();
    if (group == 0) {
      // groups hold ascending row ranges: a strict comparison keeps the
      // earliest group's (lowest) row on ties, and an all -inf cell keeps
      // its first row, as _lane_argbest does
      float b = s_val[0][lane];
      int br = s_row[0][lane];
      for (int g = 1; g < SCORE_GROUPS; ++g) {
        const float v = s_val[g][lane];
        if (v > b) {
          b = v;
          br = s_row[g][lane];
        }
      }
      const long long out = ((long long)(q0 + qi) * tiles + t) * LANES + lane;
      best_out[out] = b;
      idx_out[out] = (t * SCORE_TILE_ROWS + br) * LANES + lane;
    }
    __syncthreads();
  }
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
constexpr int HAM1_GROUPS = 8;       // row groups per block
constexpr int HAM1_GROUP_ROWS = HAM1_TILE_ROWS / HAM1_GROUPS;

template <int W>
__global__ void __launch_bounds__(LANES * HAM1_GROUPS)
hamming1_cells_kernel(const uint32_t* __restrict__ query, const uint32_t* __restrict__ db,
                      int* __restrict__ dist_out, int* __restrict__ idx_out) {
  const int lane = threadIdx.x;
  const int group = threadIdx.y;
  const int t = blockIdx.x;
  uint32_t q[W];
#pragma unroll
  for (int w = 0; w < W; ++w) q[w] = __ldg(query + w);

  const int r0 = group * HAM1_GROUP_ROWS;
  int best = 0x7fffffff;
  int best_r = r0;
#pragma unroll 4
  for (int r = 0; r < HAM1_GROUP_ROWS; ++r) {
    const long long row = ((long long)t * HAM1_TILE_ROWS + r0 + r) * LANES + lane;
    uint32_t rw[W];
    load_row<W>(db + row * W, rw);
    int d = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) d += __popc(q[w] ^ rw[w]);
    if (d < best) {
      best = d;
      best_r = r0 + r;
    }
  }

  __shared__ int s_val[HAM1_GROUPS][LANES];
  __shared__ int s_row[HAM1_GROUPS][LANES];
  s_val[group][lane] = best;
  s_row[group][lane] = best_r;
  __syncthreads();
  if (group != 0) return;
  // groups hold ascending row ranges: a strict comparison keeps the
  // earliest group's (lowest) row on ties
  for (int g = 1; g < HAM1_GROUPS; ++g) {
    const int v = s_val[g][lane];
    if (v < best) {
      best = v;
      best_r = s_row[g][lane];
    }
  }
  const long long out = (long long)t * LANES + lane;
  dist_out[out] = best;
  idx_out[out] = (t * HAM1_TILE_ROWS + best_r) * LANES + lane;
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
  const int tiles = (int)(c / (HAM1_TILE_ROWS * LANES));
  const dim3 block(LANES, HAM1_GROUPS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
#define UCFP_HAMMING1_CASE(N) \
  case N:                     \
    hamming1_cells_kernel<N><<<tiles, block, 0, s>>>(query, db, dist, idx); \
    break;
    UCFP_HAMMING1_CASE(1) UCFP_HAMMING1_CASE(2) UCFP_HAMMING1_CASE(3) UCFP_HAMMING1_CASE(4)
    UCFP_HAMMING1_CASE(5) UCFP_HAMMING1_CASE(6) UCFP_HAMMING1_CASE(7) UCFP_HAMMING1_CASE(8)
    UCFP_HAMMING1_CASE(9) UCFP_HAMMING1_CASE(10) UCFP_HAMMING1_CASE(11) UCFP_HAMMING1_CASE(12)
    UCFP_HAMMING1_CASE(13) UCFP_HAMMING1_CASE(14) UCFP_HAMMING1_CASE(15) UCFP_HAMMING1_CASE(16)
#undef UCFP_HAMMING1_CASE
  }
  return (int)cudaGetLastError();
}

extern "C" int ucfp_dots_norm_cells(const int* dots, int q, long long c, const float* row_norm,
                                    long long n, const float* inv_q, float* best, int* idx,
                                    void* stream) {
  if (q <= 0 || (q + QSEL - 1) / QSEL > 65535 || c <= 0 ||
      c % (SCORE_TILE_ROWS * LANES) != 0 || c > (1LL << 31))  // int32 row indices
    return (int)cudaErrorInvalidValue;
  const int tiles = (int)(c / (SCORE_TILE_ROWS * LANES));
  const dim3 grid(tiles, (q + QSEL - 1) / QSEL);
  const dim3 block(LANES, SCORE_GROUPS);
  dots_norm_cells_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      dots, q, c, row_norm, n, inv_q, tiles, best, idx);
  return (int)cudaGetLastError();
}
