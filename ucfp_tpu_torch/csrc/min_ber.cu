// The Haitsma-Kalker (Philips) minimum bit-error-rate search.
//
// ucfp_min_ber replaces min_ber_batch of ucfp_tpu/ops/audio/haitsma.py
// (202-246), which is no Pallas kernel but a lax.fori_loop over every
// offset of an XOR + popcount over [R, Qb] words; PyTorch has no popcount,
// so the port's counterpart is this kernel. For each stored row r of db
// [R, Tb] (u32 words), its true length lens[r], and a query q [Qb] with
// q_true live words:
//   errs(o) = sum_{j < q_true} popc(db[r, o + j] ^ q[j])
//   over the offsets 0 <= o <= last = min(lens[r] - q_true, Tb - Qb)
// (the reference slides over Tb - Qb + 1 offsets and masks those past
// lens[r] - q_true). The minimum errs wins, the FIRST minimal offset on a
// tie (the reference's strict < over ascending offsets, on BERs that order
// as the errs do since errs <= 2^22 and one denominator serves the row).
// The kernel writes each row's best key, errs << 32 | offset, or all ones
// for a row with no offset (lens[r] < q_true, dead rows included); the
// wrapper (ops/audio/haitsma.py) turns it into ber = errs / (32 *
// max(q_true, 1)) in float32, IEEE division, and the offset, (inf, -1)
// for none.
//
// Bound: operations. Counted as a popcount a word and an offset (sum_r
// (last + 1) * q_true, ~1.15e10 at the served shape: 2^14 rows of 2,311
// live words, Tb 4,096, a 359-word query) it is ~2.7 ms at 16 popcounts
// a clock per SM on 132 SMs, where the first form of this kernel (one
// thread an offset, XOR + __popc a word) ran at 89% of it. The same bit
// pairs on the binary tensor cores (mma.m16n8k256 .b1 AND-popc, 16 x 8 x
// 256 bit pairs in 1.71 SM clocks) take ~0.047 ms, about as long as the
// ~150 MB of live row words take from device memory; the products alone
// issue in ~0.09 ms. What holds the kernel above that (0.22 ms on an H100
// SXM at the served shape) is the work around the products: staging,
// the prefix sums, S and the keys, at 16 warps an SM (128 registers a
// thread).
//
// Design. popc(b ^ q) = popc(b) + popc(q) - 2 popc(b & q), so
//   errs(o) = S(o) + Pq - 2 D(o),  D(o) = sum_j popc(b[o + j] & q[j]),
// S(o) the window's popcount and Pq the query's; all exact in s32. D is a
// product whose B operand is the query shifted by one word a column: for
// a warp's 128 * MB_T offsets o = o_w + 8 MB_T m + 8 t + n (m < 16 rows,
// t < MB_T shift tiles, n < 8 columns), A[m][i] = b[o_w + 8 MB_T m + i]
// and B_t[i][n] = q[i - 8t - n] (zero outside [0, q_true)), so (A B_t)[m]
// [n] = D(o) with no diagonal sums; K runs over q_true + 8 MB_T - 1 words,
// 8 words (256 bits) a k-step. One A fragment feeds the MB_T tiles, and
// B_t at k-step c is B_0 at k-step c - t, so each k-step loads one A
// fragment (two 64-bit shared loads) and one new B_0 fragment into a ring
// of MB_T in registers: 8 products for 6 shared-memory wavefronts. A zero
// B entry masks the query's padding, and the block stages no row word at
// or past lens[r] (they read as 0), so words past either never reach an
// answer. S comes from prefix sums of the staged words' popcounts (one
// popcount a word, not a word and an offset), Pq from the query's. A
// block is MB_WARPS warps on consecutive offsets of one row; it stages
// the row segment its warps read with 16-byte cp.async copies (each word
// from device memory once) and the query, MB_QCHUNK query words a pass
// (queries run to 2^17 words), adding each pass's share of S and Pq. The
// shared layouts are skewed so that the A loads and the S reads are free
// of bank conflicts. Each thread keeps the first least errs of its 4 MB_T
// offsets; the block reduces the keys errs << 32 | offset (whose unsigned
// order is errs first, then the lower offset) and one 64-bit atomicMin a
// block folds them into the row's best, so ties go to the first offset in
// any order of arrival.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "mma_b1.cuh"

namespace {

constexpr int MB_T = 8;                          // 8-shift tiles a warp
constexpr int MB_WARPS = 2;                      // warps a block
constexpr int MB_THREADS = 32 * MB_WARPS;
constexpr int ROW_WORDS = 8 * MB_T;              // words between A's rows
constexpr int WARP_OFFS = 16 * ROW_WORDS;        // offsets a warp: 16 rows x 8 MB_T
constexpr int BLOCK_OFFS = MB_WARPS * WARP_OFFS;
constexpr int MB_QCHUNK = 512;                   // query words staged a pass
constexpr int MAX_KSTEPS = (MB_QCHUNK + ROW_WORDS + 6) / 8;
// row words a pass reads: the last warp's row 15 at the last k-step
constexpr int SEG_WORDS = BLOCK_OFFS - ROW_WORDS + 8 * MAX_KSTEPS;
constexpr int SEG_SMEM = SEG_WORDS + 8 * (SEG_WORDS / ROW_WORDS) + 8;
// prefix sums: S(o) = P[o + chunk] - P[o] for the block's offsets o; each
// thread scans a run of P_RUN words
constexpr int P_LEN = BLOCK_OFFS + MB_QCHUNK;
constexpr int P_RUN = P_LEN / MB_THREADS;
constexpr int Q_SMEM = 8 * MAX_KSTEPS + 8;  // 7 zero words, the chunk, zeros
// row g + 8 in seg: 8 rows of ROW_WORDS words and their skew after row g
constexpr int HI_ROW = 8 * (ROW_WORDS + 8);
// the same in the S array (s_at)
constexpr int HI_S = 8 * (ROW_WORDS + 8) + 2;
constexpr unsigned long long NO_OFFSET = ~0ull;
static_assert(P_RUN % 4 == 0 && P_LEN <= SEG_WORDS, "prefix runs of 16-byte loads");
static_assert(SEG_WORDS % 8 == 0 && BLOCK_OFFS % 4 == 0 && MB_QCHUNK % 4 == 0,
              "16-byte staging");
static_assert(BLOCK_OFFS + 9 * BLOCK_OFFS / ROW_WORDS <= SEG_SMEM, "the S array fits seg");
static_assert(MB_T <= 8, "a thread's 4 MB_T offsets in a 5-bit index");

// a row word's place in shared memory: 8 words of skew a row of A, so the
// row groups g = 0..3 (and 4..7) of a warp's 64-bit A load fall on
// distinct banks
__device__ __forceinline__ int seg_at(int x) { return x + 8 * (x / ROW_WORDS); }

// an offset's place in the S array: 8 words of skew a row of A and one
// more every 4 rows (8 g + g / 4 on row g of a warp), so the 8 row groups
// of a thread's 32-bit read fall on distinct banks
__device__ __forceinline__ int s_at(int y) {
  return y + 8 * (y / ROW_WORDS) + y / (4 * ROW_WORDS);
}

__device__ __forceinline__ unsigned long long min_u64(unsigned long long a,
                                                      unsigned long long b) {
  return b < a ? b : a;
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = min_u64(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

__device__ __forceinline__ int popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__global__ void __launch_bounds__(MB_THREADS, 8)
min_ber_mma(const uint32_t* __restrict__ db, long long tb, const int* __restrict__ lens,
            const uint32_t* __restrict__ q, int qb, int q_true, int tiles,
            unsigned long long* __restrict__ best) {
  // seg: the row segment (seg_at), after the products the S array (s_at)
  __shared__ __align__(16) uint32_t seg[SEG_SMEM];
  // pre[4 + x] = sum_{x' <= x} popc(seg word x'), pre[3] = 0
  __shared__ __align__(16) int pre[P_LEN + 4];
  __shared__ uint32_t qext[Q_SMEM];
  __shared__ int warp_total[MB_WARPS];
  __shared__ int warp_pq[MB_WARPS];
  __shared__ unsigned long long warp_best[MB_WARPS];
  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, l = lane & 3;
  const uint32_t* row = db + (long long)r * tb;
  // the row's last offset (below 0 when the query is longer than the
  // row), and the end of its live words
  const long long last = min((long long)lens[r] - q_true, tb - qb);
  const long long lim = min((long long)lens[r], tb);
  // this thread's offsets in its warp: my0 + 8t + b + 8 ROW_WORDS h for
  // tile t, column 2l + b, row g + 8h; sum e = 2h + b
  const int wo = w * WARP_OFFS;
  const int my0 = wo + ROW_WORDS * g + 2 * l;
  // 16-byte staging copies need the row 16-byte aligned (every segment
  // starts a multiple of 4 words into it)
  const bool vec = (reinterpret_cast<uintptr_t>(row) & 15) == 0;
  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const long long ob = (long long)tile * BLOCK_OFFS;
    if (ob > last) break;  // the same for every thread of the block
    const bool live = ob + wo <= last;
    int d[MB_T][4] = {};  // D(o)
    int s[MB_T][4] = {};  // S(o) + Pq
    for (int j0 = 0; j0 < q_true; j0 += MB_QCHUNK) {
      const int qn = min(MB_QCHUNK, q_true - j0);
      const int ksteps = (qn + ROW_WORDS + 6) / 8;
      const int seg_n = BLOCK_OFFS - ROW_WORDS + 8 * ksteps;
      __syncthreads();  // the previous pass is done with the shared words
      const long long g0 = ob + j0;
      if (vec) {  // 16 bytes a copy, the words at or past lim (or seg_n) zero
        for (int x = 4 * threadIdx.x; x < SEG_WORDS; x += 4 * MB_THREADS) {
          const long long gi = g0 + x;
          const long long n = x < seg_n ? min(lim - gi, 4LL) : 0;
          cp_async16_zfill(seg + seg_at(x), n > 0 ? row + gi : row, n > 0 ? 4 * (int)n : 0);
        }
        cp_async_commit();
      } else {
#pragma unroll 8
        for (int x = threadIdx.x; x < SEG_WORDS; x += MB_THREADS) {
          const long long gi = g0 + x;
          seg[seg_at(x)] = x < seg_n && gi < lim ? row[gi] : 0u;
        }
      }
      int pq = 0;
#pragma unroll
      for (int y = threadIdx.x; y < Q_SMEM; y += MB_THREADS) {
        const int j = y - 7;
        const uint32_t v = j >= 0 && j < qn ? q[j0 + j] : 0u;
        qext[y] = v;
        pq += __popc(v);
      }
      pq = __reduce_add_sync(0xffffffffu, pq);
      if (lane == 0) warp_pq[w] = pq;
      cp_async_wait<0>();
      __syncthreads();
      // the prefix sums, first each thread's run sum and the block's
      // exclusive scan of the sums
      const int x0 = threadIdx.x * P_RUN;
      int run = 0;
#pragma unroll
      for (int i = 0; i < P_RUN; i += 4)
        run += popc4(*reinterpret_cast<const uint4*>(seg + seg_at(x0 + i)));
      int incl = run;
#pragma unroll
      for (int sh = 1; sh < 32; sh <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, sh);
        if (lane >= sh) incl += u;
      }
      if (lane == 31) warp_total[w] = incl;
      if (live) {
        // D: bq[k] holds B_0's fragment at k-step c0 + k (b0, b1: column
        // g, words 2l and 2l + 1); tile t reads slot k - t, k-step c - t,
        // zero before the first
        uint32_t bq[MB_T][2] = {};
        const uint32_t* qg = qext + 7 + 2 * l - g;
        const uint32_t* ag = seg + seg_at(my0);  // a0 / a2 at k-step c0
        auto kstep = [&](int k) {
          bq[k][0] = qg[8 * k];
          bq[k][1] = qg[8 * k + 1];
          // a0 / a2: row g, words 2l and 2l + 1; a1 / a3: row g + 8
          const uint2 lo = *reinterpret_cast<const uint2*>(ag + 8 * k);
          const uint2 hi = *reinterpret_cast<const uint2*>(ag + 8 * k + HI_ROW);
#pragma unroll
          for (int t = 0; t < MB_T; ++t) {
            const int bt = (k - t + MB_T) % MB_T;
            mma_b1_and(d[t], lo.x, hi.x, lo.y, hi.y, bq[bt][0], bq[bt][1]);
          }
        };
        int c0 = 0;
        // MB_T k-steps are one row of A's words: ag moves a row and its skew
        for (; ksteps - c0 >= MB_T; c0 += MB_T, qg += 8 * MB_T, ag += ROW_WORDS + 8) {
#pragma unroll
          for (int k = 0; k < MB_T; ++k) kstep(k);
        }
#pragma unroll
        for (int k = 0; k < MB_T; ++k)
          if (c0 + k < ksteps) kstep(k);
      }
      __syncthreads();  // the run sums are in; seg's words are read
      int base = incl - run;
#pragma unroll
      for (int p = 0; p < MB_WARPS; ++p)
        if (p < w) base += warp_total[p];
#pragma unroll
      for (int i = 0; i < P_RUN; i += 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(seg + seg_at(x0 + i));
        int4 o;
        o.x = base += __popc(v.x);
        o.y = base += __popc(v.y);
        o.z = base += __popc(v.z);
        o.w = base += __popc(v.w);
        *reinterpret_cast<int4*>(pre + 4 + x0 + i) = o;
      }
      if (threadIdx.x == 0) pre[3] = 0;
      int pqc = 0;
#pragma unroll
      for (int p = 0; p < MB_WARPS; ++p) pqc += warp_pq[p];
      __syncthreads();  // the prefix sums are in; seg is free
      // S(o) + Pq for the block's offsets, into seg
#pragma unroll 8
      for (int y = threadIdx.x; y < BLOCK_OFFS; y += MB_THREADS)
        seg[s_at(y)] = (uint32_t)(pre[3 + y + qn] - pre[3 + y] + pqc);
      __syncthreads();
      if (live) {
        const int* sg = reinterpret_cast<const int*>(seg) + s_at(my0);
#pragma unroll
        for (int t = 0; t < MB_T; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][e] += sg[8 * t + (e & 1) + (e >> 1) * HI_S];
      }
    }
    unsigned long long key = NO_OFFSET;
    if (live) {
      // the first least errs among this thread's offsets: errs << 5 | i,
      // i = 16h + 2t + b ascending with the offset (errs <= 2^22)
      const long long span = last - ob;  // the tile's valid offsets: o - ob <= span
      const bool whole = ob + wo + WARP_OFFS - 1 <= last;  // the same for the warp
      unsigned kmin = ~0u;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int t = 0; t < MB_T; ++t)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const unsigned k = ((unsigned)(s[t][2 * h + b] - 2 * d[t][2 * h + b]) << 5) |
                               (unsigned)(16 * h + 2 * t + b);
            const int y = my0 + 8 * t + b + 8 * ROW_WORDS * h;
            kmin = min(kmin, whole || y <= span ? k : ~0u);
          }
      if (kmin != ~0u) {
        const int i = kmin & 31;
        const int y = my0 + 8 * ((i >> 1) & 7) + (i & 1) + 8 * ROW_WORDS * (i >> 4);
        key = ((unsigned long long)(kmin >> 5) << 32) | (unsigned long long)(ob + y);
      }
    }
    key = warp_min(key);
    if (lane == 0) warp_best[w] = key;
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll
      for (int p = 1; p < MB_WARPS; ++p) key = min_u64(key, warp_best[p]);
      if (key != NO_OFFSET) atomicMin(best + r, key);
    }
    __syncthreads();  // warp_best is read before the next tile writes it
  }
}

}  // namespace

// db [rows, tb] u32 words (row-major), lens [rows] int32, q [qb] u32 words
// of which the first q_true are live; best [rows] u64 out, each row's
// best key. Needs 0 <= q_true <= qb <= tb < 2^31.
extern "C" int ucfp_min_ber(const uint32_t* db, int rows, long long tb, const int* lens,
                            const uint32_t* q, int qb, int q_true, unsigned long long* best,
                            void* stream) {
  if (rows < 0 || q_true < 0 || q_true > qb || qb > tb || tb >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(best, 0xff, (size_t)rows * sizeof(unsigned long long), s);
  if (e != cudaSuccess) return (int)e;
  const long long n_off = tb - qb + 1;
  const int tiles = (int)((n_off + BLOCK_OFFS - 1) / BLOCK_OFFS);
  const dim3 grid(rows, tiles < 65535 ? tiles : 65535);
  min_ber_mma<<<grid, MB_THREADS, 0, s>>>(db, tb, lens, q, qb, q_true, tiles, best);
  return (int)cudaGetLastError();
}
