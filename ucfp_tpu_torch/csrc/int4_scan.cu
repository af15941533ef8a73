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
// Batched (ucfp_int4_batched): int8 tensor-core products,
// mma.sync.m16n8k32 s8 x s8 -> s32, catalog rows as M and queries as N.
// The unpack above is the operand: a catalog row is the K = D vector
// [hi16 | lo16] and a query [qh | ql], so one s32 accumulator holds
// 16*(dot - 8*sum(ql)) exactly (|sum| <= 768 * 128 * 127 < 2^24). One
// k-step of 32 takes 16 dim pairs: slots 0-15 are hi16 of pairs
// 16s..16s+15 and slots 16-31 their lo16, so the A fragment a thread
// needs (4 bytes of K for a row) is hi16 or lo16 of ONE transposed word.
//  * A persistent grid (two blocks of 4 warps per SM, so one block's
//    epilogue overlaps the other's products): a block keeps its pass's
//    query fragments (up to 64 queries, zero-padded to whole groups of 8
//    in N and to whole k-steps in K: a zero query byte cancels the -128
//    that lo16 gives a zero catalog byte) in shared memory, loaded once,
//    and walks its 256-row tiles. The fragments of one k-step take 256
//    bytes per group of 8 queries; past D/2 = 10,240 not even one group's
//    fit beside the ring, and the kernel reads them from the query words
//    in global memory instead (L1 / L2 hits: every warp of a block reads
//    the same words), so the batched path takes the same D/2 <= 16,384
//    as the single query, at a lower rate past 10,240.
//  * The tiles stream through a ring of 3 stages of 64 dim pairs x 256
//    rows (16 KB) with cp.async, so loads of the next stages (and the next
//    tile) overlap the products. packed_t is [D/2, C], rows contiguous per
//    pair: K is not contiguous per row, so the transpose happens on the
//    way out of shared memory: a thread reads one 32-bit word (4 rows) of
//    each of 4 pairs and transposes them with __byte_perm. The 16-byte
//    chunks are XOR-swizzled by pair so these reads are bank-conflict free.
//  * Each of the 4 warps owns 64 rows as 4 m16 tiles whose rows interleave
//    (m-tile i, row r <- catalog row 4r + i, and 32 + 4(r - 8) + i), so
//    one transpose of 4 words feeds the same fragment slot of all four
//    m-tiles, and the accumulators of 4 consecutive rows of one query sit
//    in one thread: the epilogue (>> 4, + bias, the one f32 multiply, the
//    -inf mask, the bf16 round) stores them as one 16-byte (f32, int32)
//    or 8-byte (bf16) write, 8 lanes to 128 contiguous bytes.
// Q beyond 64 takes further passes over the catalog; queries of the last
// group of 8 past Q are zero and their outputs are not stored.
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
constexpr int MAX_DP = 16384;   // int4_scan.MAX_DP

// batched, tensor cores
constexpr int T_WARPS = 4;
constexpr int T_THREADS = 32 * T_WARPS;
constexpr int T_WARP_ROWS = 64;                   // 4 m16 tiles
constexpr int T_TILE = T_WARPS * T_WARP_ROWS;     // 256 catalog rows
constexpr int T_KSTEP_PAIRS = 16;                 // one k32 step
constexpr int T_STAGE_KSTEPS = 4;
constexpr int T_STAGE_PAIRS = T_STAGE_KSTEPS * T_KSTEP_PAIRS;  // 64
constexpr int T_STAGE_BYTES = T_STAGE_PAIRS * T_TILE;          // 16 KB
constexpr int T_STAGES = 3;
constexpr int T_MAX_NT = 8;                       // n8 tiles: 64 queries a pass
constexpr int T_B_BUDGET = 160 * 1024;            // query fragments in shared memory

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the 16-byte chunk of pair row pr (within a stage) that holds chunk ch:
// XOR by (pr / 4) % 4 spreads the 4 pair rows one k-step's lanes read
// (4l + jj, l = 0..3) over all 32 banks
__device__ __forceinline__ int swz(int pr, int ch) { return ch ^ (((pr >> 2) & 3) << 1); }

// stage `ls` of the block's stream: tile blockIdx.x + (ls / chunks) *
// gridDim.x, dim pairs (ls % chunks) * 32 ..; rows past C and pairs past
// dp are not loaded (their products meet zero query bytes or are not
// stored)
__device__ __forceinline__ void load_stage(uint8_t* slot, const uint8_t* __restrict__ packed,
                                           int dp, long long c, long long tiles, int chunks,
                                           long long ls) {
  const long long t = blockIdx.x + (ls / chunks) * (long long)gridDim.x;
  if (t >= tiles) return;
  const int j0 = (int)(ls % chunks) * T_STAGE_PAIRS;
  const long long c0 = t * T_TILE;
#pragma unroll
  for (int it = 0; it < T_STAGE_BYTES / 16 / T_THREADS; ++it) {
    const int id = threadIdx.x + it * T_THREADS;
    const int pr = id / (T_TILE / 16), ch = id % (T_TILE / 16);
    const int j = j0 + pr;
    const long long col = c0 + ch * 16;
    if (j < dp && col < c)
      cp_async16(slot + pr * T_TILE + swz(pr, ch) * 16, packed + (long long)j * c + col);
  }
}

// the B fragment of query qi for word group g (b0 = qh, b1 = ql); zero past
// Q and past the groups
__device__ __forceinline__ uint2 query_frag(const int* __restrict__ qh,
                                            const int* __restrict__ ql, int nq, int groups,
                                            int qi, int g) {
  if (qi >= nq || g >= groups) return make_uint2(0u, 0u);
  const long long src = (long long)qi * groups + g;
  return make_uint2((uint32_t)__ldg(qh + src), (uint32_t)__ldg(ql + src));
}

// B_SMEM: the pass's query fragments sit in shared memory; else each is
// read from qh / ql where the product needs it
template <int KIND, bool B_SMEM>
__global__ void __launch_bounds__(T_THREADS)
int4_mma_kernel(const uint8_t* __restrict__ packed, int dp, long long c,
                const int* __restrict__ qh, const int* __restrict__ ql, int nq, int groups,
                int nt_max, const int* __restrict__ bias, const float* __restrict__ inv,
                long long n, void* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_a = smem;                                               // T_STAGES stages
  uint2* s_b = reinterpret_cast<uint2*>(smem + T_STAGES * T_STAGE_BYTES);  // fragments
  const int ksteps = (dp + T_KSTEP_PAIRS - 1) / T_KSTEP_PAIRS;
  int* s_bias = reinterpret_cast<int*>(s_b + (B_SMEM ? (long long)ksteps * nt_max * 32 : 0));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, l = lane & 3;
  const long long tiles = (c + T_TILE - 1) / T_TILE;
  const int chunks = (ksteps + T_STAGE_KSTEPS - 1) / T_STAGE_KSTEPS;
  const long long my_tiles =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long stream_len = my_tiles * chunks;
  const int qpass = nt_max * 8;

  for (int q0 = 0; q0 < nq; q0 += qpass) {
    const int nt_n = (min(qpass, nq - q0) + 7) / 8;  // n8 tiles this pass
    __syncthreads();  // the previous pass is done with s_b and s_bias
    // query fragments: b0 = qh word, b1 = ql word of group 4s + (lane & 3)
    // for query q0 + 8 nt + (lane >> 2)
    if constexpr (B_SMEM) {
      for (int i = tid; i < ksteps * nt_n * 32; i += T_THREADS) {
        const int ln = i & 31, nt = (i >> 5) % nt_n, ks = (i >> 5) / nt_n;
        s_b[(ks * nt_max + nt) * 32 + ln] =
            query_frag(qh, ql, nq, groups, q0 + nt * 8 + (ln >> 2), 4 * ks + (ln & 3));
      }
    }
    for (int i = tid; i < qpass; i += T_THREADS) s_bias[i] = q0 + i < nq ? bias[q0 + i] : 0;

#pragma unroll
    for (int st = 0; st < T_STAGES - 1; ++st) {
      if (st < stream_len)
        load_stage(s_a + st * T_STAGE_BYTES, packed, dp, c, tiles, chunks, st);
      cp_async_commit();
    }

    long long ls = 0;  // stage being consumed
    for (long long ti = 0; ti < my_tiles; ++ti) {
      const long long c0 = (blockIdx.x + ti * gridDim.x) * T_TILE;
      int acc[4][T_MAX_NT][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int nt = 0; nt < T_MAX_NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0;

      for (int kc = 0; kc < chunks; ++kc, ++ls) {
        cp_async_wait<T_STAGES - 2>();
        __syncthreads();  // stage ls has landed; stage ls - 1's slot is free
        const long long nxt = ls + T_STAGES - 1;
        if (nxt < stream_len)
          load_stage(s_a + (nxt % T_STAGES) * T_STAGE_BYTES, packed, dp, c, tiles, chunks,
                     nxt);
        cp_async_commit();
        const uint8_t* slot = s_a + (ls % T_STAGES) * T_STAGE_BYTES;
#pragma unroll
        for (int sk = 0; sk < T_STAGE_KSTEPS; ++sk) {
          const int ks = kc * T_STAGE_KSTEPS + sk;
          if (ks >= ksteps) break;
          // words of pairs 16 sk + 4 l + jj for rows 4 gid..+3 and 32 + 4 gid..+3
          uint32_t w0[4], w1[4];
          const int ch0 = warp * (T_WARP_ROWS / 16) + (gid >> 2);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int pr = sk * T_KSTEP_PAIRS + 4 * l + jj;
            const uint8_t* row = slot + pr * T_TILE + (gid & 3) * 4;
            w0[jj] = *reinterpret_cast<const uint32_t*>(row + swz(pr, ch0) * 16);
            w1[jj] = *reinterpret_cast<const uint32_t*>(row + swz(pr, ch0 + 2) * 16);
          }
          uint32_t t0[4], t1[4];
          transpose4(w0, t0);
          transpose4(w1, t1);
          uint32_t ah0[4], ah1[4], al0[4], al1[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ah0[i] = (uint32_t)hi16(t0[i]);
            ah1[i] = (uint32_t)hi16(t1[i]);
            al0[i] = (uint32_t)lo16(t0[i]);
            al1[i] = (uint32_t)lo16(t1[i]);
          }
          const uint2* bk = s_b + ks * nt_max * 32 + lane;
#pragma unroll
          for (int nt = 0; nt < T_MAX_NT; ++nt) {
            if (nt < nt_n) {
              const uint2 b = B_SMEM ? bk[nt * 32]
                                     : query_frag(qh, ql, nq, groups, q0 + nt * 8 + gid,
                                                  4 * ks + l);
#pragma unroll
              for (int i = 0; i < 4; ++i)
                mma_s8(acc[i][nt], ah0[i], ah1[i], al0[i], al1[i], b.x, b.y);
            }
          }
        }
      }

      // epilogue: rows c0 + 64 warp + 32 h + 4 gid + i, queries q0 + 8 nt + 2 l + e
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row0 = c0 + warp * T_WARP_ROWS + 32 * h + 4 * gid;
        if (row0 >= c) break;
        float4 iv = make_float4(0.f, 0.f, 0.f, 0.f);
        if constexpr (KIND != OUT_DOTS) iv = __ldg(reinterpret_cast<const float4*>(inv + row0));
#pragma unroll
        for (int nt = 0; nt < T_MAX_NT; ++nt) {
          if (nt >= nt_n) break;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qi = nt * 8 + 2 * l + e;
            if (q0 + qi < nq) {
              const int v4[4] = {acc[0][nt][2 * h + e], acc[1][nt][2 * h + e],
                                 acc[2][nt][2 * h + e], acc[3][nt][2 * h + e]};
              store4<KIND>(out, (long long)(q0 + qi) * c + row0, v4, s_bias[qi], iv, row0, n);
            }
          }
        }
      }
    }
    cp_async_wait<0>();
  }
}

template <int KIND, bool B_SMEM>
int launch_mma(const uint32_t* packed, int dp, long long c, const int* qh, const int* ql,
               int nq, int groups, int nt_max, const int* bias, const float* inv, long long n,
               void* out, cudaStream_t s) {
  const int ksteps = (dp + T_KSTEP_PAIRS - 1) / T_KSTEP_PAIRS;
  const int smem = T_STAGES * T_STAGE_BYTES +
                   (B_SMEM ? ksteps * nt_max * 32 * (int)sizeof(uint2) : 0) +
                   nt_max * 8 * (int)sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(int4_mma_kernel<KIND, B_SMEM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, int4_mma_kernel<KIND, B_SMEM>,
                                                      T_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (c + T_TILE - 1) / T_TILE;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(tiles < resident ? tiles : resident);  // persistent
  int4_mma_kernel<KIND, B_SMEM><<<grid, T_THREADS, smem, s>>>(
      static_cast<const uint8_t*>(static_cast<const void*>(packed)), dp, c, qh, ql, nq, groups,
      nt_max, bias, inv, n, out);
  return (int)cudaGetLastError();
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
  // groups of 8 queries whose fragments fit in shared memory
  const int ksteps = (dp + T_KSTEP_PAIRS - 1) / T_KSTEP_PAIRS;
  const int fit = T_B_BUDGET / (ksteps * 32 * (int)sizeof(uint2));
  if (fit < 1)
    return launch_mma<KIND, false>(packed, dp, c, qh, ql, nq, groups, T_MAX_NT, bias, inv, n,
                                   out, s);
  return launch_mma<KIND, true>(packed, dp, c, qh, ql, nq, groups,
                                fit < T_MAX_NT ? fit : T_MAX_NT, bias, inv, n, out, s);
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
