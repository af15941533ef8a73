// Packed-int4 prefilter scans for the UCFP_KNN_QUANT=int4 tier.
//
// ucfp_int4_scan replaces three kernels of ucfp_tpu/ops/pallas_int4.py,
// all built on _unpack_dots: int4_dots (_int4_kernel), int4_masked_scores
// (_int4_scores_kernel) and int4_masked_scores_batched
// (_int4_batched_kernel). The catalog keeps the reference's layout,
// packed_t [D/2, C] int8, column-major (catalog rows contiguous for each
// dim pair j), byte = 16*hi + lo_b with hi in place and the low nibble
// biased +8. For query q with int8 halves qh = q[:D/2], ql = q[D/2:]:
//
//   dot   = sum_j (byte >> 4) * qh[j] + (byte & 15) * ql[j]   (uncorrected)
//   dots kernel:   out = dot                        int32
//   masked kernel: out = (float)(dot - corr) * inv_n4[c], -inf where
//                  c >= n or inv_n4[c] == 0         float32, or bfloat16
//                  rounded to nearest even from that float32
//
// The arithmetic is integer and exact: four dim pairs of one row sit in
// one 32-bit word after a 4x4 byte transpose (__byte_perm), so __dp4a
// takes them against four query bytes. hi16 = word & 0xF0F0F0F0 is
// 16*hi per byte, and lo16 = ((word << 4) & 0xF0F0F0F0) ^ 0x80808080 is
// 16*(lo_b - 8) per byte, both exact signed bytes for ANY input byte, so
// one accumulator gathers 16*(dot - 8*sum(ql)); the epilogue shifts it
// down and adds bias = 8*sum(ql) (dots) or 8*sum(ql) - corr (masked),
// which the wrapper computes. The product and the -inf mask are the
// reference's; the build has no fast-math, so the one float multiply is
// correctly rounded and the outputs equal the plain versions bit for bit.
//
// Bound: device memory. The function must read the packed catalog once
// (C * D/2 bytes), inv_n4 once (C * 4) and write Q * C outputs; at
// C = 2^22, D = 768 one query is 1.63 GB, 0.49 ms at 3.35 TB/s, and Q = 64
// in bf16 2.17 GB, 0.65 ms. The batched form also does 2 * Q * C * D
// integer operations (412 G at Q = 64), which the CUDA cores' __dp4a
// (2 * Q * C * D/8 instructions) could not issue in the bytes' time: the
// first port ran Q = 32 at 5.8x its byte bound. On the int8 tensor cores
// they take about 0.2 ms, under the bytes.
//
// Design. Single query (ucfp_int4_single): one thread per four
// consecutive rows; for each dim pair j it loads one 32-bit word of
// packed_t, so a warp reads 128 consecutive bytes per j (coalesced), four
// words at a time for the transpose; the query's words sit in shared
// memory (broadcast reads); no staging, since each byte is used once.
//
// Batched (nq > 1): int8 tensor-core products, mma.sync.m16n8k32 s8 x s8
// -> s32, catalog rows as M and queries as N, by the scan csrc/mma_scan.cuh
// shares with the batched int2 scan (FIELDS = 2 there): a catalog row is
// the K = D vector [hi16 | lo16] and a query [qh | ql], so one s32
// accumulator holds 16*(dot - 8*sum(ql)) exactly (|sum| <= 768 * 128 * 127
// < 2^24); one k32 step takes 16 dim pairs, slots 0-15 hi16 of pairs
// 16s..16s+15 and slots 16-31 their lo16. The header has the design (a
// persistent grid, a cp.async ring of 16 KB stages, the transpose on the
// way out of shared memory, 4 interleaved m16 tiles per warp); the query
// fragments sit in shared memory up to D/2 = 10,240 and come from global
// memory past it, so the batched path takes the same D/2 <= 16,384 as the
// single query, at a lower rate past 10,240.
//
// Plain C interface (loaded with ctypes): launches on the caller's
// stream, allocates nothing, returns cudaGetLastError().

#include "mma_scan.cuh"

namespace {

constexpr int ROW_ALIGN = 128;  // int4_scan.ROW_ALIGN
constexpr int S_THREADS = 128;  // single query: 4 rows per thread
constexpr int MAX_DP = 16384;   // int4_scan.MAX_DP

__device__ __forceinline__ int hi16(uint32_t t) { return (int)field<2>(t, 0); }
__device__ __forceinline__ int lo16(uint32_t t) { return (int)field<2>(t, 1); }

template <int KIND>
__global__ void __launch_bounds__(S_THREADS)
int4_single_kernel(const uint32_t* __restrict__ packed, int dp, long long c4,
                   const int* __restrict__ qh, const int* __restrict__ ql, int groups,
                   const int* __restrict__ bias, const float* __restrict__ inv,
                   long long n, void* __restrict__ out) {
  extern __shared__ int s_q[];  // qh words, then ql words
  for (int i = threadIdx.x; i < groups; i += S_THREADS) {
    s_q[i] = qh[i];
    s_q[groups + i] = ql[i];
  }
  __syncthreads();
  const long long w = (long long)blockIdx.x * S_THREADS + threadIdx.x;
  if (w >= c4) return;
  const uint32_t* p = packed + w;  // word column w: rows 4w..4w+3
  int acc[4] = {0, 0, 0, 0};
  const int full = dp / 4;
#pragma unroll 4
  for (int g = 0; g < full; ++g) {
    const uint32_t* pg = p + (long long)(4 * g) * c4;
    const uint32_t ws[4] = {__ldg(pg), __ldg(pg + c4), __ldg(pg + 2 * c4), __ldg(pg + 3 * c4)};
    uint32_t t[4];
    transpose4(ws, t);
    const int a = s_q[g], b = s_q[groups + g];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = __dp4a(lo16(t[i]), b, __dp4a(hi16(t[i]), a, acc[i]));
  }
  if (full < groups) {  // D/2 % 4 != 0: pairs past D/2 read as zero bytes
    const uint32_t* pg = p + (long long)(4 * full) * c4;
    uint32_t ws[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) ws[jj] = 4 * full + jj < dp ? __ldg(pg + jj * c4) : 0u;
    uint32_t t[4];
    transpose4(ws, t);
    const int a = s_q[full], b = s_q[groups + full];  // zero bytes past D/2
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = __dp4a(lo16(t[i]), b, __dp4a(hi16(t[i]), a, acc[i]));
  }
  float4 iv = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (KIND != OUT_DOTS) iv = __ldg(reinterpret_cast<const float4*>(inv) + w);
  store_rows<KIND, 2>(out, 4 * w, acc, bias[0], 0.0f, iv, 4 * w, n);
}

template <int KIND>
int launch(const uint32_t* packed, int dp, long long c, const int* qh, const int* ql,
            int nq, int groups, const int* bias, const float* inv, long long n, void* out,
            cudaStream_t s) {
  const long long c4 = c / 4;
  if (nq == 1) {
    const long long blocks = (c4 + S_THREADS - 1) / S_THREADS;
    int4_single_kernel<KIND><<<(unsigned)blocks, S_THREADS, 2 * groups * sizeof(int), s>>>(
        packed, dp, c4, qh, ql, groups, bias, inv, n, out);
    return (int)cudaGetLastError();
  }
  const QueryWords qw = {{qh, ql, nullptr, nullptr}};
  return launch_batched<KIND, 2>(reinterpret_cast<const uint8_t*>(packed), dp, c, qw, nq,
                                 groups, bias, nullptr, inv, n, out, s);
}

}  // namespace

extern "C" int ucfp_int4_scan(const void* packed, int dp, long long c, const int* qh,
                              const int* ql, int nq, int groups, const int* bias,
                              const float* inv_n4, long long n, int kind, void* out,
                              void* stream) {
  if (dp < 1 || dp > MAX_DP || groups != (dp + 3) / 4 || c <= 0 ||
      c % ROW_ALIGN != 0 || c / S_THREADS > 0x7fffffffLL || nq < 1 || kind < OUT_DOTS ||
      kind > OUT_BF16 || (kind != OUT_DOTS && inv_n4 == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto* p = static_cast<const uint32_t*>(packed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == OUT_DOTS)
    return launch<OUT_DOTS>(p, dp, c, qh, ql, nq, groups, bias, inv_n4, n, out, s);
  if (kind == OUT_F32)
    return launch<OUT_F32>(p, dp, c, qh, ql, nq, groups, bias, inv_n4, n, out, s);
  return launch<OUT_BF16>(p, dp, c, qh, ql, nq, groups, bias, inv_n4, n, out, s);
}
