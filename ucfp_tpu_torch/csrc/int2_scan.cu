// Packed-int2 prefilter scans for the UCFP_KNN_QUANT=int2 tier.
//
// ucfp_int2_scan replaces three kernels of ucfp_tpu/ops/pallas_int2.py,
// all built on _unpack_dots2: int2_masked_scores (_int2_scores_kernel),
// int2_masked_scores_batched (_int2_batched_kernel) and int2_topq_scores
// (_int2_topq_kernel). The catalog keeps the reference's layout, packed_t
// [D/4, C] int8, column-major (catalog rows contiguous for each dim
// quarter j): bits 6-7 hold dim j as a signed field a in [-2, 1], bits
// 4-5, 2-3, 0-1 hold dims j + D/4, j + D/2, j + 3D/4 biased +2. For a
// query with int8 quarters qa, qb, qc, qd:
//
//   dot   = sum_j a * qa[j] + (b+2) * qb[j] + (c+2) * qc[j] + (d+2) * qd[j]
//   score = ((float)dot - corr) * inv_n2[c], -inf where c >= n or
//           inv_n2[c] == 0        float32, or bfloat16 rounded to nearest
//                                 even from that float32
//   topq:  per 512-row segment, 8 passes of (largest score, lowest row
//          holding it, that row set to -inf): the reference's rule, so a
//          segment with fewer than 8 live rows repeats its lowest -inf row
//
// The arithmetic is integer and exact: four dim quarters of one row sit in
// one 32-bit word after a 4x4 byte transpose (__byte_perm). word &
// 0xC0C0C0C0 is 64*a per byte as an exact signed byte, and (word >> 4),
// (word >> 2), word, each & 0x03030303, are the three biased fields, so
// four __dp4a per word gather 64 * sum(a*qa) and the biased-field sum; the
// first is shifted down (exactly divisible) and added. (float)dot - corr is
// exact (integers and half-integers below 2^23), so the one rounding is
// the product, taken with __fmul_rn; the build has no fast-math, and the
// outputs equal the plain versions bit for bit.
//
// Bound: device memory. The function must read the packed catalog once
// (C * D/4 bytes) and inv_n2 once (C * 4), and write Q * C outputs (or
// C/512 * 8 pairs for topq); at C = 2^22, D = 768 one query is 0.84 GB,
// 0.25 ms at 3.35 TB/s. The batched form also does 4 * Q * C * D/16
// __dp4a on the CUDA cores, which at Q = 32 takes longer than the bytes;
// tensor-core mma is left for a later change.
//
// Design. Single query (int2_single_kernel): one thread per four
// consecutive rows; for each group of four dim quarters it loads one
// 32-bit word per quarter, so a warp reads 128 consecutive bytes per
// quarter (coalesced), then transposes; the query words sit in shared
// memory (broadcast reads). topq (int2_topq_kernel): the same per-thread
// scan, one 128-thread block per 512-row segment; each thread keeps its
// four scores in registers, and each of the 8 passes is a warp shuffle
// reduction of (score, row) plus a 4-entry cross-warp step in shared
// memory; only the 8 (score, row) pairs per segment are written. Batched
// (int2_batched_kernel): one block per 128-row tile, staged in shared
// memory 16 dim groups at a time (transposed on the way in) together
// with the matching words of up to 64 queries; 256 threads each run 4
// rows x 8 queries, so the catalog is read once per 64 queries. Which
// body runs is set by the query count alone: int2_masked_scores_batched
// with one query (the served Q = 1 form) runs int2_single_kernel, with
// float32 or bfloat16 stores; only Q >= 2 runs int2_batched_kernel.
//
// Plain C interface (loaded with ctypes): launches on the caller's
// stream, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int OUT_F32 = 1;
constexpr int OUT_BF16 = 2;
constexpr int OUT_TOPQ = 3;

constexpr int ROW_ALIGN = 128;  // int2_scan.ROW_ALIGN
constexpr int S_THREADS = 128;  // single query and topq: 4 rows per thread
constexpr int TOPQ = 8;         // int2_scan.TOPQ
constexpr int TOPQ_SEG = 512;   // int2_scan.TOPQ_SEG = 4 * S_THREADS
constexpr int B_ROWS = 128;     // batched: rows per block (32 word columns)
constexpr int B_QG = 8;         // batched: queries per thread
constexpr int B_QPASS = 64;     // batched: queries per pass over a tile
constexpr int B_THREADS = 256;  // 32 word columns x 8 query groups
constexpr int B_KC = 16;        // batched: dim groups (of 4 quarters) per stage
constexpr int MAX_DQ = 8192;    // int2_scan.MAX_DQ

// w[jj] holds quarter j0 + jj of rows r..r+3 (byte i = row r + i);
// t[i] gets row r + i's four quarters (byte jj = quarter j0 + jj)
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4], uint32_t (&t)[4]) {
  const uint32_t x0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t x1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t x2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t x3 = __byte_perm(w[2], w[3], 0x7362);
  t[0] = __byte_perm(x0, x2, 0x5410);
  t[1] = __byte_perm(x0, x2, 0x7632);
  t[2] = __byte_perm(x1, x3, 0x5410);
  t[3] = __byte_perm(x1, x3, 0x7632);
}

__device__ __forceinline__ int fa64(uint32_t t) { return (int)(t & 0xC0C0C0C0u); }
__device__ __forceinline__ int fb(uint32_t t) { return (int)((t >> 4) & 0x03030303u); }
__device__ __forceinline__ int fc(uint32_t t) { return (int)((t >> 2) & 0x03030303u); }
__device__ __forceinline__ int fd(uint32_t t) { return (int)(t & 0x03030303u); }

// one transposed word of one row against the query's four words
__device__ __forceinline__ void dot_word(uint32_t t, int qa, int qb, int qc, int qd,
                                         int& acc_a, int& acc_r) {
  acc_a = __dp4a(fa64(t), qa, acc_a);
  acc_r = __dp4a(fd(t), qd, __dp4a(fc(t), qc, __dp4a(fb(t), qb, acc_r)));
}

// dots of rows 4w..4w+3 (p = packed + w) against the query words in
// shared memory (s_q: qa, qb, qc, qd, `groups` words each)
__device__ __forceinline__ void dots4(const uint32_t* __restrict__ p, long long c4, int dq,
                                      int groups, const int* s_q, int (&dot)[4]) {
  int acc_a[4] = {0, 0, 0, 0}, acc_r[4] = {0, 0, 0, 0};
  const int full = dq / 4;
#pragma unroll 4
  for (int g = 0; g < full; ++g) {
    const uint32_t* pg = p + (long long)(4 * g) * c4;
    const uint32_t ws[4] = {__ldg(pg), __ldg(pg + c4), __ldg(pg + 2 * c4), __ldg(pg + 3 * c4)};
    uint32_t t[4];
    transpose4(ws, t);
    const int qa = s_q[g], qb = s_q[groups + g], qc = s_q[2 * groups + g],
              qd = s_q[3 * groups + g];
#pragma unroll
    for (int i = 0; i < 4; ++i) dot_word(t[i], qa, qb, qc, qd, acc_a[i], acc_r[i]);
  }
  if (full < groups) {  // D/4 % 4 != 0: quarters past D/4 read as zero bytes
    const uint32_t* pg = p + (long long)(4 * full) * c4;
    uint32_t ws[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) ws[jj] = 4 * full + jj < dq ? __ldg(pg + jj * c4) : 0u;
    uint32_t t[4];
    transpose4(ws, t);
    const int qa = s_q[full], qb = s_q[groups + full], qc = s_q[2 * groups + full],
              qd = s_q[3 * groups + full];  // zero bytes past D/4
#pragma unroll
    for (int i = 0; i < 4; ++i) dot_word(t[i], qa, qb, qc, qd, acc_a[i], acc_r[i]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) dot[i] = (acc_a[i] >> 6) + acc_r[i];
}

__device__ __forceinline__ float score(int dot, float corr, float inv, long long row,
                                       long long n) {
  return (row < n && inv > 0.0f) ? __fmul_rn(__fsub_rn(__int2float_rn(dot), corr), inv)
                                 : -INFINITY;
}

// four rows' outputs at out[off..off+3]
template <int KIND>
__device__ __forceinline__ void store4(void* __restrict__ out, long long off, const float (&s)[4]) {
  if constexpr (KIND == OUT_F32) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + off) = make_float4(s[0], s[1], s[2], s[3]);
  } else {
    __nv_bfloat162 a = __floats2bfloat162_rn(s[0], s[1]);  // .x = s[0], lower address
    __nv_bfloat162 b = __floats2bfloat162_rn(s[2], s[3]);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + off) =
        make_uint2(*reinterpret_cast<uint32_t*>(&a), *reinterpret_cast<uint32_t*>(&b));
  }
}

__device__ __forceinline__ void load_query(const int* __restrict__ qw, int groups, int* s_q) {
  for (int i = threadIdx.x; i < 4 * groups; i += blockDim.x) s_q[i] = qw[i];
  __syncthreads();
}

template <int KIND>
__global__ void __launch_bounds__(S_THREADS)
int2_single_kernel(const uint32_t* __restrict__ packed, int dq, long long c4,
                   const int* __restrict__ qw, int groups, const float* __restrict__ corr,
                   const float* __restrict__ inv, long long n, void* __restrict__ out) {
  extern __shared__ int s_q[];  // qa, qb, qc, qd words
  load_query(qw, groups, s_q);
  const long long w = (long long)blockIdx.x * S_THREADS + threadIdx.x;
  if (w >= c4) return;
  int dot[4];
  dots4(packed + w, c4, dq, groups, s_q, dot);
  const float4 iv = __ldg(reinterpret_cast<const float4*>(inv) + w);
  const float ivs[4] = {iv.x, iv.y, iv.z, iv.w};
  const float cr = corr[0];
  float s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = score(dot[i], cr, ivs[i], 4 * w + i, n);
  store4<KIND>(out, 4 * w, s);
}

// (v, i) beats (ov, oi): larger score, or the same score at a lower row
__device__ __forceinline__ bool beats(float ov, int oi, float v, int i) {
  return ov > v || (ov == v && oi < i);
}

__global__ void __launch_bounds__(S_THREADS)
int2_topq_kernel(const uint32_t* __restrict__ packed, int dq, long long c4,
                 const int* __restrict__ qw, int groups, const float* __restrict__ corr,
                 const float* __restrict__ inv, long long n, float* __restrict__ out_v,
                 int* __restrict__ out_i) {
  extern __shared__ int s_q[];
  __shared__ float red_v[2][S_THREADS / 32];
  __shared__ int red_i[2][S_THREADS / 32];
  load_query(qw, groups, s_q);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long w = (long long)blockIdx.x * S_THREADS + tid;  // always < c4
  int dot[4];
  dots4(packed + w, c4, dq, groups, s_q, dot);
  const float4 iv = __ldg(reinterpret_cast<const float4*>(inv) + w);
  const float ivs[4] = {iv.x, iv.y, iv.z, iv.w};
  const float cr = corr[0];
  float s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = score(dot[i], cr, ivs[i], 4 * w + i, n);
  for (int t = 0; t < TOPQ; ++t) {
    float v = s[0];
    int idx = 4 * tid;
#pragma unroll
    for (int i = 1; i < 4; ++i)
      if (s[i] > v) { v = s[i]; idx = 4 * tid + i; }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
      if (beats(ov, oi, v, idx)) { v = ov; idx = oi; }
    }
    const int buf = t & 1;  // alternate buffers: one barrier per pass
    if (lane == 0) { red_v[buf][warp] = v; red_i[buf][warp] = idx; }
    __syncthreads();
    v = red_v[buf][0];
    idx = red_i[buf][0];
#pragma unroll
    for (int k = 1; k < S_THREADS / 32; ++k)
      if (beats(red_v[buf][k], red_i[buf][k], v, idx)) { v = red_v[buf][k]; idx = red_i[buf][k]; }
    if ((idx >> 2) == tid) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if ((idx & 3) == i) s[i] = -INFINITY;
    }
    if (tid == 0) {
      out_v[(long long)blockIdx.x * TOPQ + t] = v;
      out_i[(long long)blockIdx.x * TOPQ + t] = blockIdx.x * TOPQ_SEG + idx;
    }
  }
}

template <int KIND>
__global__ void __launch_bounds__(B_THREADS)
int2_batched_kernel(const uint32_t* __restrict__ packed, int dq, long long c, long long c4,
                    const int* __restrict__ qw, int nq, int groups,
                    const float* __restrict__ corr, const float* __restrict__ inv,
                    long long n, void* __restrict__ out) {
  __shared__ uint32_t s_t[B_KC][4][32];  // [group][row within word][word column]
  __shared__ __align__(16) int s_q[4][B_KC][B_QPASS];  // [quarter][group][query]
  const int tid = threadIdx.x;
  const int wc = tid & 31;  // word column: rows 4*wc..4*wc+3 of the tile
  const int qg = tid >> 5;  // query group: queries 8*qg..8*qg+7 of the pass
  const long long c0 = (long long)blockIdx.x * B_ROWS;
  const long long w0 = c0 / 4;
  const float4 iv = __ldg(reinterpret_cast<const float4*>(inv) + w0 + wc);
  const float ivs[4] = {iv.x, iv.y, iv.z, iv.w};

  for (int pass = 0; pass < nq; pass += B_QPASS) {
    const int pass_q = min(B_QPASS, nq - pass);
    const bool active = qg * B_QG < pass_q;  // the same for the whole warp
    int acc_a[B_QG][4], acc_r[B_QG][4];
#pragma unroll
    for (int j = 0; j < B_QG; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc_a[j][i] = acc_r[j][i] = 0;

    for (int g0 = 0; g0 < groups; g0 += B_KC) {
      for (int it = tid; it < B_KC * 32; it += B_THREADS) {
        const int gg = it >> 5, col = it & 31, g = g0 + gg;
        uint32_t ws[4] = {0u, 0u, 0u, 0u};
        if (g < groups) {
          const uint32_t* pg = packed + (long long)(4 * g) * c4 + w0 + col;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            if (4 * g + jj < dq) ws[jj] = __ldg(pg + jj * c4);
        }
        uint32_t t[4];
        transpose4(ws, t);
#pragma unroll
        for (int i = 0; i < 4; ++i) s_t[gg][i][col] = t[i];
      }
      for (int it = tid; it < 4 * B_KC * B_QPASS; it += B_THREADS) {
        const int quarter = it / (B_KC * B_QPASS), rem = it % (B_KC * B_QPASS);
        const int gg = rem / B_QPASS, qq = rem % B_QPASS, g = g0 + gg;
        const bool ok = g < groups && qq < pass_q;
        s_q[quarter][gg][qq] = ok ? qw[((long long)quarter * nq + pass + qq) * groups + g] : 0;
      }
      __syncthreads();
      if (active) {
#pragma unroll 2
        for (int gg = 0; gg < B_KC; ++gg) {  // zero words past the last group add 0
          int a[4], b[4], cc[4], d[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t t = s_t[gg][i][wc];
            a[i] = fa64(t);
            b[i] = fb(t);
            cc[i] = fc(t);
            d[i] = fd(t);
          }
          int qv[4][B_QG];
#pragma unroll
          for (int quarter = 0; quarter < 4; ++quarter) {
            const int4* pq = reinterpret_cast<const int4*>(&s_q[quarter][gg][qg * B_QG]);
            const int4 lo = pq[0], hi = pq[1];
            qv[quarter][0] = lo.x; qv[quarter][1] = lo.y; qv[quarter][2] = lo.z;
            qv[quarter][3] = lo.w; qv[quarter][4] = hi.x; qv[quarter][5] = hi.y;
            qv[quarter][6] = hi.z; qv[quarter][7] = hi.w;
          }
#pragma unroll
          for (int j = 0; j < B_QG; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc_a[j][i] = __dp4a(a[i], qv[0][j], acc_a[j][i]);
              acc_r[j][i] = __dp4a(d[i], qv[3][j],
                                   __dp4a(cc[i], qv[2][j], __dp4a(b[i], qv[1][j], acc_r[j][i])));
            }
        }
      }
      __syncthreads();
    }
    if (active) {
#pragma unroll
      for (int j = 0; j < B_QG; ++j) {
        const int q = pass + qg * B_QG + j;
        if (q < nq) {
          const float cr = corr[q];
          float s[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            s[i] = score((acc_a[j][i] >> 6) + acc_r[j][i], cr, ivs[i], c0 + 4 * wc + i, n);
          store4<KIND>(out, (long long)q * c + c0 + 4 * wc, s);
        }
      }
    }
  }
}

template <int KIND>
void launch(const uint32_t* packed, int dq, long long c, const int* qw, int nq, int groups,
            const float* corr, const float* inv, long long n, void* out, cudaStream_t s) {
  const long long c4 = c / 4;
  if (nq == 1) {
    const long long blocks = (c4 + S_THREADS - 1) / S_THREADS;
    int2_single_kernel<KIND><<<(unsigned)blocks, S_THREADS, 4 * groups * sizeof(int), s>>>(
        packed, dq, c4, qw, groups, corr, inv, n, out);
  } else {
    int2_batched_kernel<KIND><<<(unsigned)(c / B_ROWS), B_THREADS, 0, s>>>(
        packed, dq, c, c4, qw, nq, groups, corr, inv, n, out);
  }
}

}  // namespace

extern "C" int ucfp_int2_scan(const void* packed, int dq, long long c, const int* qwords,
                              int nq, int groups, const float* corr, const float* inv_n2,
                              long long n, int kind, void* out, int* out_idx, void* stream) {
  if (dq < 1 || dq > MAX_DQ || groups != (dq + 3) / 4 || c <= 0 || c % ROW_ALIGN != 0 ||
      c / B_ROWS > 0x7fffffffLL || nq < 1 || kind < OUT_F32 || kind > OUT_TOPQ ||
      inv_n2 == nullptr || corr == nullptr ||
      (kind == OUT_TOPQ && (nq != 1 || c % TOPQ_SEG != 0 || out_idx == nullptr)))
    return (int)cudaErrorInvalidValue;
  const auto* p = static_cast<const uint32_t*>(packed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == OUT_TOPQ)
    int2_topq_kernel<<<(unsigned)(c / TOPQ_SEG), S_THREADS, 4 * groups * sizeof(int), s>>>(
        p, dq, c / 4, qwords, groups, corr, inv_n2, n, static_cast<float*>(out), out_idx);
  else if (kind == OUT_F32)
    launch<OUT_F32>(p, dq, c, qwords, nq, groups, corr, inv_n2, n, out, s);
  else
    launch<OUT_BF16>(p, dq, c, qwords, nq, groups, corr, inv_n2, n, out, s);
  return (int)cudaGetLastError();
}
