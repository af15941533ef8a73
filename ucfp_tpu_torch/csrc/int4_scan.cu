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
// C = 2^22, D = 768 one query is 1.63 GB, 0.49 ms at 3.35 TB/s. On the
// CUDA cores the batched form also does 2 * Q * C * D/8 __dp4a, which at
// Q = 32 may take longer than the bytes; tensor-core mma is left for a
// later change.
//
// Design. Single query (ucfp_int4_single): one thread per four
// consecutive rows; for each dim pair j it loads one 32-bit word of
// packed_t, so a warp reads 128 consecutive bytes per j (coalesced), four
// words at a time for the transpose; the query's words sit in shared
// memory (broadcast reads); no staging, since each byte is used once.
// Batched (ucfp_int4_batched): one block per 128-row tile; the tile is
// staged in shared memory 16 dim groups at a time (transposed on the way
// in, bank-conflict free on both sides) together with the matching words
// of up to 64 queries, and 256 threads each run 4 rows x 8 queries over
// it, so the catalog is read from device memory once per 64 queries.
// Warps whose 8 queries lie past Q skip the arithmetic.
//
// Plain C interface (loaded with ctypes): launches on the caller's
// stream, allocates nothing, returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int OUT_DOTS = 0;
constexpr int OUT_F32 = 1;
constexpr int OUT_BF16 = 2;

constexpr int ROW_ALIGN = 128;  // int4_scan.ROW_ALIGN
constexpr int S_THREADS = 128;  // single query: 4 rows per thread
constexpr int B_ROWS = 128;     // batched: rows per block (32 word columns)
constexpr int B_QG = 8;         // batched: queries per thread
constexpr int B_QPASS = 64;     // batched: queries per pass over a tile
constexpr int B_THREADS = 256;  // 32 word columns x 8 query groups
constexpr int B_KC = 16;        // batched: dim groups (of 4 pairs) per stage
constexpr int MAX_DP = 16384;

// w[jj] holds dim pair j0 + jj of rows r..r+3 (byte i = row r + i);
// t[i] gets row r + i's four dim pairs (byte jj = pair j0 + jj)
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

__device__ __forceinline__ int hi16(uint32_t t) { return (int)(t & 0xF0F0F0F0u); }

__device__ __forceinline__ int lo16(uint32_t t) {
  return (int)(((t << 4) & 0xF0F0F0F0u) ^ 0x80808080u);
}

// four rows' outputs at out[off..off+3] (rows row0..row0+3)
template <int KIND>
__device__ __forceinline__ void store4(void* __restrict__ out, long long off,
                                      const int (&acc)[4], int bias, const float4& iv,
                                      long long row0, long long n) {
  int v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = (int)((unsigned)(acc[i] >> 4) + (unsigned)bias);
  if constexpr (KIND == OUT_DOTS) {
    *reinterpret_cast<int4*>(static_cast<int*>(out) + off) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
    const float inv[4] = {iv.x, iv.y, iv.z, iv.w};
    float s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s[i] = (row0 + i < n && inv[i] > 0.0f) ? (float)v[i] * inv[i] : -INFINITY;
    if constexpr (KIND == OUT_F32) {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + off) =
          make_float4(s[0], s[1], s[2], s[3]);
    } else {
      __nv_bfloat162 a = __floats2bfloat162_rn(s[0], s[1]);  // .x = s[0], lower address
      __nv_bfloat162 b = __floats2bfloat162_rn(s[2], s[3]);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + off) =
          make_uint2(*reinterpret_cast<uint32_t*>(&a), *reinterpret_cast<uint32_t*>(&b));
    }
  }
}

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
  store4<KIND>(out, 4 * w, acc, bias[0], iv, 4 * w, n);
}

template <int KIND>
__global__ void __launch_bounds__(B_THREADS)
int4_batched_kernel(const uint32_t* __restrict__ packed, int dp, long long c, long long c4,
                    const int* __restrict__ qh, const int* __restrict__ ql, int nq,
                    int groups, const int* __restrict__ bias,
                    const float* __restrict__ inv, long long n, void* __restrict__ out) {
  __shared__ uint32_t s_t[B_KC][4][32];  // [group][row within word][word column]
  __shared__ __align__(16) int s_qh[B_KC][B_QPASS];
  __shared__ __align__(16) int s_ql[B_KC][B_QPASS];
  const int tid = threadIdx.x;
  const int wc = tid & 31;  // word column: rows 4*wc..4*wc+3 of the tile
  const int qg = tid >> 5;  // query group: queries 8*qg..8*qg+7 of the pass
  const long long c0 = (long long)blockIdx.x * B_ROWS;
  const long long w0 = c0 / 4;
  float4 iv = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (KIND != OUT_DOTS) iv = __ldg(reinterpret_cast<const float4*>(inv) + w0 + wc);

  for (int pass = 0; pass < nq; pass += B_QPASS) {
    const int pass_q = min(B_QPASS, nq - pass);
    const bool active = qg * B_QG < pass_q;  // the same for the whole warp
    int acc[B_QG][4];
#pragma unroll
    for (int j = 0; j < B_QG; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0;

    for (int g0 = 0; g0 < groups; g0 += B_KC) {
      for (int it = tid; it < B_KC * 32; it += B_THREADS) {
        const int gg = it >> 5, col = it & 31, g = g0 + gg;
        uint32_t ws[4] = {0u, 0u, 0u, 0u};
        if (g < groups) {
          const uint32_t* pg = packed + (long long)(4 * g) * c4 + w0 + col;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            if (4 * g + jj < dp) ws[jj] = __ldg(pg + jj * c4);
        }
        uint32_t t[4];
        transpose4(ws, t);
#pragma unroll
        for (int i = 0; i < 4; ++i) s_t[gg][i][col] = t[i];
      }
      for (int it = tid; it < B_KC * B_QPASS; it += B_THREADS) {
        const int gg = it / B_QPASS, qq = it % B_QPASS, g = g0 + gg;
        const bool ok = g < groups && qq < pass_q;
        const long long src = (long long)(pass + qq) * groups + g;
        s_qh[gg][qq] = ok ? qh[src] : 0;
        s_ql[gg][qq] = ok ? ql[src] : 0;
      }
      __syncthreads();
      if (active) {
#pragma unroll 2
        for (int gg = 0; gg < B_KC; ++gg) {  // zero words past the last group add 0
          int h[4], l[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t t = s_t[gg][i][wc];
            h[i] = hi16(t);
            l[i] = lo16(t);
          }
          const int4* ph = reinterpret_cast<const int4*>(&s_qh[gg][qg * B_QG]);
          const int4* pl = reinterpret_cast<const int4*>(&s_ql[gg][qg * B_QG]);
          const int4 ha = ph[0], hb = ph[1], la = pl[0], lb = pl[1];
          const int qhv[B_QG] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
          const int qlv[B_QG] = {la.x, la.y, la.z, la.w, lb.x, lb.y, lb.z, lb.w};
#pragma unroll
          for (int j = 0; j < B_QG; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[j][i] = __dp4a(l[i], qlv[j], __dp4a(h[i], qhv[j], acc[j][i]));
        }
      }
      __syncthreads();
    }
    if (active) {
#pragma unroll
      for (int j = 0; j < B_QG; ++j) {
        const int q = pass + qg * B_QG + j;
        if (q < nq)
          store4<KIND>(out, (long long)q * c + c0 + 4 * wc, acc[j], bias[q], iv,
                       c0 + 4 * wc, n);
      }
    }
  }
}

template <int KIND>
void launch(const uint32_t* packed, int dp, long long c, const int* qh, const int* ql,
            int nq, int groups, const int* bias, const float* inv, long long n, void* out,
            cudaStream_t s) {
  const long long c4 = c / 4;
  if (nq == 1) {
    const long long blocks = (c4 + S_THREADS - 1) / S_THREADS;
    int4_single_kernel<KIND><<<(unsigned)blocks, S_THREADS, 2 * groups * sizeof(int), s>>>(
        packed, dp, c4, qh, ql, groups, bias, inv, n, out);
  } else {
    int4_batched_kernel<KIND><<<(unsigned)(c / B_ROWS), B_THREADS, 0, s>>>(
        packed, dp, c, c4, qh, ql, nq, groups, bias, inv, n, out);
  }
}

}  // namespace

extern "C" int ucfp_int4_scan(const void* packed, int dp, long long c, const int* qh,
                              const int* ql, int nq, int groups, const int* bias,
                              const float* inv_n4, long long n, int kind, void* out,
                              void* stream) {
  if (dp < 1 || dp > MAX_DP || groups != (dp + 3) / 4 || c <= 0 || c % ROW_ALIGN != 0 ||
      c / B_ROWS > 0x7fffffffLL || nq < 1 || kind < OUT_DOTS || kind > OUT_BF16 ||
      (kind != OUT_DOTS && inv_n4 == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto* p = static_cast<const uint32_t*>(packed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == OUT_DOTS)
    launch<OUT_DOTS>(p, dp, c, qh, ql, nq, groups, bias, inv_n4, n, out, s);
  else if (kind == OUT_F32)
    launch<OUT_F32>(p, dp, c, qh, ql, nq, groups, bias, inv_n4, n, out, s);
  else
    launch<OUT_BF16>(p, dp, c, qh, ql, nq, groups, bias, inv_n4, n, out, s);
  return (int)cudaGetLastError();
}
