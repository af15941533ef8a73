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
// The arithmetic is integer and exact, and (float)dot - corr is exact
// (integers and half-integers below 2^23), so the one rounding is the
// product, taken with __fmul_rn; the build has no fast-math, and the
// outputs equal the plain versions bit for bit.
//
// Bound: device memory. The function must read the packed catalog once
// (C * D/4 bytes) and inv_n2 once (C * 4), and write Q * C outputs (or
// C/512 * 8 pairs for topq); at C = 2^22, D = 768 one query is 0.84 GB,
// 0.25 ms at 3.35 TB/s, and Q = 32 in bf16 1.09 GB, 0.33 ms. The batched
// form also does 2 * Q * C * D integer operations (206 G at Q = 32): on
// the CUDA cores' __dp4a (4 * Q * C * D/16 instructions) that took 9x the
// bytes' time (3.0 ms at Q = 32 on one H100); on the int8 tensor cores it
// is about 0.1 ms, under the bytes.
//
// Design. Single query (int2_single_kernel): one thread per four
// consecutive rows; for each group of four dim quarters it loads one
// 32-bit word per quarter, so a warp reads 128 consecutive bytes per
// quarter (coalesced), then transposes them (__byte_perm) so one word
// holds four quarters of one row: word & 0xC0C0C0C0 is 64*a per byte as
// an exact signed byte and (word >> 4), (word >> 2), word, each &
// 0x03030303, are the three biased fields, so four __dp4a per word gather
// 64 * sum(a*qa) and the biased-field sum; the query words sit in shared
// memory (broadcast reads). topq (int2_topq_kernel): the same per-thread
// scan, one 128-thread block per 512-row segment; each thread keeps its
// four scores in registers, and each of the 8 passes is a warp shuffle
// reduction of (score, row) plus a 4-entry cross-warp step in shared
// memory; only the 8 (score, row) pairs per segment are written.
//
// Batched, Q >= 2 (mma_scan_kernel<KIND, B_SMEM, 4>, csrc/mma_scan.cuh,
// the tensor-core scan the batched int4 kernel shares): each field becomes
// an exact signed byte scaled by 64 with one XOR for the biased ones, A =
// w & 0xC0C0C0C0 (64a), B = ((w << 2) & 0xC0C0C0C0) ^ 0x80808080 (64b, b =
// (b+2) - 2), C and D likewise with shifts 4 and 6, so a catalog row is the
// K = D vector of s8 [A | B | C | D] against the query's [qa | qb | qc |
// qd], and one s32 sum of mma.sync.m16n8k32 products holds S = 64*(dot -
// 2*(sum qb + sum qc + sum qd)) exactly (|S| <= 64 * 2 * 128 * D < 2^30 at
// D/4 = 8192). The epilogue is dot = (S >> 6) + bias, bias = 2*(sum qb +
// sum qc + sum qd) from the wrapper, then the single kernel's score. A
// chunk of 16 quarters is two k32 steps, [A | B] then [C | D], so a
// thread's 4 bytes of K for a row are one field of one transposed word;
// one transpose and one unpack of the catalog per pass of 64 queries feed
// 4 m-tiles x 8 n-tiles of products. Zero query bytes pad K to whole
// chunks (a zero or unloaded catalog byte's B, C, D are -128, not 0) and Q
// to whole groups of 8. The query fragments sit in shared memory up to
// D/4 = 5,120 and come from global memory past it, so the batched path
// takes D/4 <= 8192 as before. Which body runs is set by the query count
// alone: int2_masked_scores_batched with one query (the served Q = 1
// form) runs int2_single_kernel, with float32 or bfloat16 stores.
//
// Plain C interface (loaded with ctypes): launches on the caller's
// stream, allocates nothing, returns cudaGetLastError().

#include "mma_scan.cuh"

namespace {

constexpr int OUT_TOPQ = 3;     // OUT_F32, OUT_BF16: csrc/mma_scan.cuh

constexpr int ROW_ALIGN = 128;  // int2_scan.ROW_ALIGN
constexpr int S_THREADS = 128;  // single query and topq: 4 rows per thread
constexpr int TOPQ = 8;         // int2_scan.TOPQ
constexpr int TOPQ_SEG = 512;   // int2_scan.TOPQ_SEG = 4 * S_THREADS
constexpr int MAX_DQ = 8192;    // int2_scan.MAX_DQ

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
  store4f<KIND>(out, 4 * w, s);
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
int launch(const uint32_t* packed, int dq, long long c, const int* qw, int nq, int groups,
           const int* bias, const float* corr, const float* inv, long long n, void* out,
           cudaStream_t s) {
  if (nq == 1) {
    const long long c4 = c / 4;
    const long long blocks = (c4 + S_THREADS - 1) / S_THREADS;
    int2_single_kernel<KIND><<<(unsigned)blocks, S_THREADS, 4 * groups * sizeof(int), s>>>(
        packed, dq, c4, qw, groups, corr, inv, n, out);
    return (int)cudaGetLastError();
  }
  const long long fs = (long long)nq * groups;  // words per field
  const QueryWords q = {{qw, qw + fs, qw + 2 * fs, qw + 3 * fs}};
  return launch_batched<KIND, 4>(reinterpret_cast<const uint8_t*>(packed), dq, c, q, nq, groups,
                                 bias, corr, inv, n, out, s);
}

}  // namespace

// qwords: [4, nq, groups] words (qa, qb, qc, qd); bias: [nq] int32, 2 *
// (sum qb + sum qc + sum qd), read by the batched kernel (nq >= 2) only
extern "C" int ucfp_int2_scan(const void* packed, int dq, long long c, const int* qwords,
                              int nq, int groups, const int* bias, const float* corr,
                              const float* inv_n2, long long n, int kind, void* out,
                              int* out_idx, void* stream) {
  if (dq < 1 || dq > MAX_DQ || groups != (dq + 3) / 4 || c <= 0 || c % ROW_ALIGN != 0 ||
      c / S_THREADS > 0x7fffffffLL || nq < 1 || kind < OUT_F32 || kind > OUT_TOPQ ||
      inv_n2 == nullptr || corr == nullptr ||
      (nq > 1 && (bias == nullptr || reinterpret_cast<uintptr_t>(packed) % 16 != 0)) ||
      (kind == OUT_TOPQ && (nq != 1 || c % TOPQ_SEG != 0 || out_idx == nullptr)))
    return (int)cudaErrorInvalidValue;
  const auto* p = static_cast<const uint32_t*>(packed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == OUT_TOPQ) {
    int2_topq_kernel<<<(unsigned)(c / TOPQ_SEG), S_THREADS, 4 * groups * sizeof(int), s>>>(
        p, dq, c / 4, qwords, groups, corr, inv_n2, n, static_cast<float*>(out), out_idx);
    return (int)cudaGetLastError();
  }
  if (kind == OUT_F32)
    return launch<OUT_F32>(p, dq, c, qwords, nq, groups, bias, corr, inv_n2, n, out, s);
  return launch<OUT_BF16>(p, dq, c, qwords, nq, groups, bias, corr, inv_n2, n, out, s);
}

// blocks per SM of the batched (tensor-core) kernel for nq queries at D/4 = dq
extern "C" int ucfp_int2_batched_blocks_per_sm(int dq, int nq, int kind, int* per_sm) {
  if (dq < 1 || dq > MAX_DQ || nq < 2 || kind < OUT_F32 || kind > OUT_BF16)
    return (int)cudaErrorInvalidValue;
  return kind == OUT_F32 ? batched_blocks_per_sm<OUT_F32, 4>(dq, nq, per_sm)
                         : batched_blocks_per_sm<OUT_BF16, 4>(dq, nq, per_sm);
}
