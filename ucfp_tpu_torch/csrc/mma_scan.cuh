// The int8 tensor-core scan of packed catalog columns, shared by the
// batched int4 scan (csrc/int4_scan.cu: #10, and #11 at nq > 1) and the
// batched int2 scan (csrc/int2_scan.cu: #13 at Q >= 2). The two differ only
// in how many fields a packed byte holds (FIELDS = 2 or 4), how each field
// becomes an operand, and the epilogue's shift and correction.
//
// The catalog is packed_t [DK, C] int8 (DK = D/2 dim pairs, or D/4 dim
// quarters), column-major: catalog rows contiguous for each packed column
// j. Each field of a byte becomes an exact signed byte with a shift, a
// mask and, for a field stored with a bias, one XOR:
//   int4 (FIELDS = 2):  16*hi          = b & 0xF0
//                       16*(lo_b - 8)  = ((b << 4) & 0xF0) ^ 0x80
//   int2 (FIELDS = 4):  64*a           = b & 0xC0          (bits 6-7)
//                       64*(f_b - 2)   = ((b << s) & 0xC0) ^ 0x80, s = 2, 4, 6
//                                        (the +2-biased fields in bits 4-5, 2-3, 0-1)
// A catalog row is then the K = FIELDS * DK vector of those bytes, and a
// query the vector of its matching dims (int4 [qh | ql], int2 [qa | qb |
// qc | qd]), so one s32 sum of mma.sync.m16n8k32 s8 x s8 products holds
// SCALE * (dot - unbias) exactly: SCALE = 16 (int4, unbias = 8*sum(ql)) or
// 64 (int2, unbias = 2*(sum(qb) + sum(qc) + sum(qd))), at most 2^29 in
// magnitude at the widest D each tier takes. The epilogue shifts the sum
// down (it is a multiple of SCALE), adds the wrapper's per-query bias, and
// for scores takes (float)dot (int2: minus the float32 corr, exact) times
// inv_norm as one correctly rounded product, -inf where row >= n or
// inv_norm == 0, rounded to bf16 (nearest even) where asked. The build
// has no fast-math, so the outputs equal the plain versions bit for bit.
//
// K order. Any fixed permutation of K applied to both operands leaves the
// sum unchanged, so the slots are ordered for the A fragment: a chunk of
// 16 packed columns 16s..16s+15 is FIELDS/2 k32 steps, step f holding
// field 2f of those columns in slots 0-15 and field 2f+1 in slots 16-31.
// The 4 bytes of K a thread needs for one row (mma lanes l = lane % 4 take
// slots 4l..4l+3 and 16+4l..16+4l+3) are then one field of ONE word that
// holds columns 16s+4l..16s+4l+3 of that row.
//
// Design (first built for the batched int4 scan, now a template):
//  * A persistent grid (blocks per SM from cudaOccupancyMaxActiveBlocks-
//    PerMultiprocessor, asked once per shape). The accumulators are sized
//    for the pass (NT = 2, 4 or 8 n8 tiles: Q <= 16, <= 32, more), so at
//    D = 768 three blocks of 4 warps share an SM up to Q = 32 and two past
//    it, and one block's epilogue overlaps the others' products. A block
//    keeps its pass's query fragments (up to 8 * NT queries, zero-padded
//    to whole groups of 8 in N and to whole chunks in K: a zero query byte
//    cancels the -128 that a biased field gives a zero or unloaded catalog
//    byte) in shared memory, loaded once, and walks its 256-row tiles,
//    loading each tile's inv_norm when the tile starts (a load in the
//    epilogue stalled every tile). One k32 step's fragments take 256 bytes
//    per group of 8 queries; where not even one group fits beside the ring
//    (K > 20,480: int4 D/2 > 10,240, int2 D/4 > 5,120), the kernel reads
//    them from the query words in global memory instead (L1 / L2 hits:
//    every warp of a block reads the same words).
//  * The tiles stream through a ring of 3 stages of 64 packed columns x
//    256 rows (16 KB) with cp.async, so the loads of the next stages (and
//    the next tile) overlap the products. packed_t's rows are contiguous
//    per column, not along K, so the tile is transposed on its way out of
//    shared memory: a thread reads one 32-bit word (4 rows) of each of 4
//    columns and transposes them with __byte_perm; the 16-byte chunks are
//    XOR-swizzled by column so these reads are bank-conflict free.
//  * Each of the 4 warps owns 64 rows as 4 m16 tiles whose rows
//    interleave (m-tile i, row r <- catalog row 4r + i, and 32 + 4(r - 8)
//    + i), so one transpose of 4 words feeds the same fragment slot of all
//    four m-tiles, and the accumulators of 4 consecutive rows of one query
//    sit in one thread: the epilogue stores them as one 16-byte (f32,
//    int32) or 8-byte (bf16) write, 8 lanes to 128 contiguous bytes.
//  * The field unpack runs once per catalog byte per pass of 64 queries
//    and feeds 4 m-tiles x up to 8 n-tiles of products.
// Q beyond 64 takes further passes over the catalog; queries of the last
// group of 8 past Q are zero and their outputs are not stored.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"
#include "mma_s8.cuh"

namespace {

constexpr int OUT_DOTS = 0;
constexpr int OUT_F32 = 1;
constexpr int OUT_BF16 = 2;

constexpr int T_WARPS = 4;
constexpr int T_THREADS = 32 * T_WARPS;
constexpr int T_WARP_ROWS = 64;                            // 4 m16 tiles
constexpr int T_TILE = T_WARPS * T_WARP_ROWS;              // 256 catalog rows
constexpr int T_CHUNK_COLS = 16;                           // 4 mma lanes x 4 bytes
constexpr int T_STAGE_CHUNKS = 4;
constexpr int T_STAGE_COLS = T_STAGE_CHUNKS * T_CHUNK_COLS;  // 64
constexpr int T_STAGE_BYTES = T_STAGE_COLS * T_TILE;       // 16 KB
constexpr int T_STAGES = 3;
constexpr int T_MAX_NT = 8;                                // n8 tiles: 64 queries a pass
constexpr int T_B_BUDGET = 160 * 1024;                     // query fragments in shared memory

// The [nq, groups] query words of each field's dims (four dims per word,
// byte b of word g = dim 4g + b, zero past the last dim): int4 {qh, ql},
// int2 {qa, qb, qc, qd}.
struct QueryWords {
  const int* f[4];
};

// w[jj] holds column j0 + jj of rows r..r+3 (byte i = row r + i);
// t[i] gets row r + i's four columns (byte jj = column j0 + jj)
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

// field k of every byte of a transposed word, as exact signed bytes (see
// the table at the top)
template <int FIELDS>
__device__ __forceinline__ uint32_t field(uint32_t t, int k) {
  constexpr uint32_t MASK = FIELDS == 2 ? 0xF0F0F0F0u : 0xC0C0C0C0u;
  constexpr int STEP = 8 / FIELDS;  // bits per field
  return k == 0 ? (t & MASK) : (((t << (STEP * k)) & MASK) ^ 0x80808080u);
}

// four float scores at out[off..off+3]
template <int KIND>
__device__ __forceinline__ void store4f(void* __restrict__ out, long long off,
                                        const float (&s)[4]) {
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

// the epilogue of four rows' sums (rows row0..row0+3) at out[off..off+3]:
// dot = (sum >> shift) + bias, then the dots, or the masked scores
// ((float)dot [- corr for int2]) * inv
template <int KIND, int FIELDS>
__device__ __forceinline__ void store_rows(void* __restrict__ out, long long off,
                                           const int (&acc)[4], int bias, float corr,
                                           const float4& iv, long long row0, long long n) {
  constexpr int SHIFT = FIELDS == 2 ? 4 : 6;
  int v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = (int)((unsigned)(acc[i] >> SHIFT) + (unsigned)bias);
  if constexpr (KIND == OUT_DOTS) {
    *reinterpret_cast<int4*>(static_cast<int*>(out) + off) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
    const float inv[4] = {iv.x, iv.y, iv.z, iv.w};
    float s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = __int2float_rn(v[i]);
      if constexpr (FIELDS == 4) x = __fsub_rn(x, corr);
      s[i] = (row0 + i < n && inv[i] > 0.0f) ? __fmul_rn(x, inv[i]) : -INFINITY;
    }
    store4f<KIND>(out, off, s);
  }
}

// the 16-byte chunk of column row pr (within a stage) that holds chunk ch:
// XOR by (pr / 4) % 4 spreads the 4 column rows one chunk's lanes read
// (4l + jj, l = 0..3) over all 32 banks
__device__ __forceinline__ int swz(int pr, int ch) { return ch ^ (((pr >> 2) & 3) << 1); }

// stage `ls` of the block's stream: tile blockIdx.x + (ls / stages) *
// gridDim.x, columns (ls % stages) * 64 ..; rows past C and columns past
// dk are not loaded (their products meet zero query bytes or are not
// stored)
__device__ __forceinline__ void load_stage(uint8_t* slot, const uint8_t* __restrict__ packed,
                                           int dk, long long c, long long tiles, int stages,
                                           long long ls) {
  const long long t = blockIdx.x + (ls / stages) * (long long)gridDim.x;
  if (t >= tiles) return;
  const int j0 = (int)(ls % stages) * T_STAGE_COLS;
  const long long c0 = t * T_TILE;
#pragma unroll
  for (int it = 0; it < T_STAGE_BYTES / 16 / T_THREADS; ++it) {
    const int id = threadIdx.x + it * T_THREADS;
    const int pr = id / (T_TILE / 16), ch = id % (T_TILE / 16);
    const int j = j0 + pr;
    const long long col = c0 + ch * 16;
    if (j < dk && col < c)
      cp_async16(slot + pr * T_TILE + swz(pr, ch) * 16, packed + (long long)j * c + col);
  }
}

// the B fragment of query qi for k32 step ks (fields 2f and 2f + 1 of
// word group 4 * (ks / (FIELDS/2)) + l, f = ks % (FIELDS/2)); zero past
// Q and past the groups
template <int FIELDS>
__device__ __forceinline__ uint2 query_frag(const QueryWords& qw, int nq, int groups, int qi,
                                            int ks, int l) {
  constexpr int KS = FIELDS / 2;
  const int g = 4 * (ks / KS) + l, f = ks % KS;
  if (qi >= nq || g >= groups) return make_uint2(0u, 0u);
  const long long src = (long long)qi * groups + g;
  return make_uint2((uint32_t)__ldg(qw.f[2 * f] + src), (uint32_t)__ldg(qw.f[2 * f + 1] + src));
}

// B_SMEM: the pass's query fragments sit in shared memory; else each is
// read from the query words where the product needs it. NT: the n8 tiles
// a pass holds in registers (nt_max <= NT). corr (int2 only): one float32
// per query, subtracted after the bias.
template <int KIND, bool B_SMEM, int FIELDS, int NT>
__global__ void __launch_bounds__(T_THREADS)
mma_scan_kernel(const uint8_t* __restrict__ packed, int dk, long long c, QueryWords qw,
                int nq, int groups, int nt_max, const int* __restrict__ bias,
                const float* __restrict__ corr, const float* __restrict__ inv, long long n,
                void* __restrict__ out) {
  constexpr int KS = FIELDS / 2;  // k32 steps per chunk of 16 columns
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_a = smem;                                                     // T_STAGES stages
  uint2* s_b = reinterpret_cast<uint2*>(smem + T_STAGES * T_STAGE_BYTES);  // fragments
  const int kchunks = (dk + T_CHUNK_COLS - 1) / T_CHUNK_COLS;
  const int ksteps = kchunks * KS;
  int* s_bias = reinterpret_cast<int*>(s_b + (B_SMEM ? (long long)ksteps * nt_max * 32 : 0));
  float* s_corr = reinterpret_cast<float*>(s_bias + nt_max * 8);  // FIELDS == 4 only
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, l = lane & 3;
  const long long tiles = (c + T_TILE - 1) / T_TILE;
  const int stages = (kchunks + T_STAGE_CHUNKS - 1) / T_STAGE_CHUNKS;  // per tile
  const long long my_tiles =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long stream_len = my_tiles * stages;
  const int qpass = nt_max * 8;

  for (int q0 = 0; q0 < nq; q0 += qpass) {
    const int nt_n = (min(qpass, nq - q0) + 7) / 8;  // n8 tiles this pass
    __syncthreads();  // the previous pass is done with s_b, s_bias and s_corr
    // query fragments of k32 step ks for query q0 + 8 nt + (lane >> 2)
    if constexpr (B_SMEM) {
      for (int i = tid; i < ksteps * nt_n * 32; i += T_THREADS) {
        const int ln = i & 31, nt = (i >> 5) % nt_n, ks = (i >> 5) / nt_n;
        s_b[(ks * nt_max + nt) * 32 + ln] =
            query_frag<FIELDS>(qw, nq, groups, q0 + nt * 8 + (ln >> 2), ks, ln & 3);
      }
    }
    for (int i = tid; i < qpass; i += T_THREADS) {
      s_bias[i] = q0 + i < nq ? bias[q0 + i] : 0;
      if constexpr (FIELDS == 4) s_corr[i] = q0 + i < nq ? corr[q0 + i] : 0.0f;
    }

#pragma unroll
    for (int st = 0; st < T_STAGES - 1; ++st) {
      if (st < stream_len)
        load_stage(s_a + st * T_STAGE_BYTES, packed, dk, c, tiles, stages, st);
      cp_async_commit();
    }

    long long ls = 0;  // stage being consumed
    for (long long ti = 0; ti < my_tiles; ++ti) {
      const long long c0 = (blockIdx.x + ti * gridDim.x) * T_TILE;
      // the tile's inv_norm, loaded now so the epilogue does not wait on it
      float4 iv[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
      if constexpr (KIND != OUT_DOTS) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row0 = c0 + warp * T_WARP_ROWS + 32 * h + 4 * gid;
          if (row0 < c) iv[h] = __ldg(reinterpret_cast<const float4*>(inv + row0));
        }
      }
      int acc[4][NT][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0;

      for (int kc = 0; kc < stages; ++kc, ++ls) {
        cp_async_wait<T_STAGES - 2>();
        __syncthreads();  // stage ls has landed; stage ls - 1's slot is free
        const long long nxt = ls + T_STAGES - 1;
        if (nxt < stream_len)
          load_stage(s_a + (nxt % T_STAGES) * T_STAGE_BYTES, packed, dk, c, tiles, stages,
                     nxt);
        cp_async_commit();
        const uint8_t* slot = s_a + (ls % T_STAGES) * T_STAGE_BYTES;
#pragma unroll
        for (int sk = 0; sk < T_STAGE_CHUNKS; ++sk) {
          const int ch = kc * T_STAGE_CHUNKS + sk;
          if (ch >= kchunks) break;
          // words of columns 16 sk + 4 l + jj for rows 4 gid..+3 and 32 + 4 gid..+3
          uint32_t w0[4], w1[4];
          const int ch0 = warp * (T_WARP_ROWS / 16) + (gid >> 2);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int pr = sk * T_CHUNK_COLS + 4 * l + jj;
            const uint8_t* row = slot + pr * T_TILE + (gid & 3) * 4;
            w0[jj] = *reinterpret_cast<const uint32_t*>(row + swz(pr, ch0) * 16);
            w1[jj] = *reinterpret_cast<const uint32_t*>(row + swz(pr, ch0 + 2) * 16);
          }
          uint32_t t0[4], t1[4];
          transpose4(w0, t0);
          transpose4(w1, t1);
#pragma unroll
          for (int f = 0; f < KS; ++f) {
            uint32_t a0[4], a1[4], a2[4], a3[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              a0[i] = field<FIELDS>(t0[i], 2 * f);
              a1[i] = field<FIELDS>(t1[i], 2 * f);
              a2[i] = field<FIELDS>(t0[i], 2 * f + 1);
              a3[i] = field<FIELDS>(t1[i], 2 * f + 1);
            }
            const int ks = ch * KS + f;
            const uint2* bk = s_b + ks * nt_max * 32 + lane;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              if (nt < nt_n) {
                const uint2 b = B_SMEM ? bk[nt * 32]
                                       : query_frag<FIELDS>(qw, nq, groups, q0 + nt * 8 + gid,
                                                            ks, l);
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  mma_s8(acc[i][nt], a0[i], a1[i], a2[i], a3[i], b.x, b.y);
              }
            }
          }
        }
      }

      // epilogue: rows c0 + 64 warp + 32 h + 4 gid + i, queries q0 + 8 nt + 2 l + e
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row0 = c0 + warp * T_WARP_ROWS + 32 * h + 4 * gid;
        if (row0 >= c) break;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt >= nt_n) break;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qi = nt * 8 + 2 * l + e;
            if (q0 + qi < nq) {
              const int v4[4] = {acc[0][nt][2 * h + e], acc[1][nt][2 * h + e],
                                 acc[2][nt][2 * h + e], acc[3][nt][2 * h + e]};
              store_rows<KIND, FIELDS>(out, (long long)(q0 + qi) * c + row0, v4, s_bias[qi],
                                       FIELDS == 4 ? s_corr[qi] : 0.0f, iv[h], row0, n);
            }
          }
        }
      }
    }
    cp_async_wait<0>();
  }
}

template <int FIELDS>
int mma_ksteps(int dk) {
  return (dk + T_CHUNK_COLS - 1) / T_CHUNK_COLS * (FIELDS / 2);
}

template <bool B_SMEM, int FIELDS>
int mma_smem_bytes(int dk, int nt_max) {
  return T_STAGES * T_STAGE_BYTES +
         (B_SMEM ? mma_ksteps<FIELDS>(dk) * nt_max * 32 * (int)sizeof(uint2) : 0) +
         nt_max * 8 * (int)(sizeof(int) + (FIELDS == 4 ? sizeof(float) : 0));
}

// the most dynamic shared memory any launch of one kernel asks for: the
// fragments stay within T_B_BUDGET (mma_fit)
constexpr int T_SMEM_MAX = T_STAGES * T_STAGE_BYTES + T_B_BUDGET + T_MAX_NT * 8 * 8;
constexpr int T_MAX_DEVICES = 64;

// What a launch asks of the runtime, asked once: each kernel's shared
// memory cap (set once per device), the SM count, and the blocks per SM
// for the last shared-memory size (a race between host threads can only
// pair a size with another size's grid, which the persistent kernel
// takes). Asking on every call took more host time than a small batch's
// kernel takes on the card.
struct LaunchCache {
  int ready = 0, sms = 0, smem = -1, per_sm = 0;
};

template <int KIND, bool B_SMEM, int FIELDS, int NT>
int mma_blocks_per_sm(int dk, int nt_max, int* per_sm, int* sms) {
  static LaunchCache cache[T_MAX_DEVICES];
  auto kernel = mma_scan_kernel<KIND, B_SMEM, FIELDS, NT>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= T_MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  LaunchCache& lc = cache[dev];
  if (!lc.ready) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T_SMEM_MAX);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&lc.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    lc.ready = 1;
  }
  const int smem = mma_smem_bytes<B_SMEM, FIELDS>(dk, nt_max);
  if (lc.smem != smem) {
    int n = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, T_THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    lc.per_sm = n;
    lc.smem = smem;
  }
  *per_sm = lc.per_sm;
  if (sms != nullptr) *sms = lc.sms;
  return 0;
}

template <int KIND, bool B_SMEM, int FIELDS, int NT>
int launch_mma(const uint8_t* packed, int dk, long long c, const QueryWords& qw, int nq,
               int groups, int nt_max, const int* bias, const float* corr, const float* inv,
               long long n, void* out, cudaStream_t s) {
  int per_sm = 0, sms = 0;
  const int e = mma_blocks_per_sm<KIND, B_SMEM, FIELDS, NT>(dk, nt_max, &per_sm, &sms);
  if (e != 0) return e;
  const long long tiles = (c + T_TILE - 1) / T_TILE;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int grid = (int)(tiles < resident ? tiles : resident);  // persistent
  const int smem = mma_smem_bytes<B_SMEM, FIELDS>(dk, nt_max);
  mma_scan_kernel<KIND, B_SMEM, FIELDS, NT><<<grid, T_THREADS, smem, s>>>(
      packed, dk, c, qw, nq, groups, nt_max, bias, corr, inv, n, out);
  return (int)cudaGetLastError();
}

// groups of 8 queries whose fragments fit in shared memory at this width
// (0: none, the fragments come from global memory)
template <int FIELDS>
int mma_fit(int dk) {
  const int fit = T_B_BUDGET / (mma_ksteps<FIELDS>(dk) * 32 * (int)sizeof(uint2));
  return fit < T_MAX_NT ? fit : T_MAX_NT;
}

// the accumulators a pass of nq queries needs: 2, 4 or 8 n8 tiles (fewer
// registers, so more blocks per SM, at small Q)
inline int mma_nt(int nq) {
  const int nt = ((nq < T_MAX_NT * 8 ? nq : T_MAX_NT * 8) + 7) / 8;
  return nt <= 2 ? 2 : nt <= 4 ? 4 : 8;
}

template <bool B>
using smem_tag = std::integral_constant<bool, B>;
template <int N>
using nt_tag = std::integral_constant<int, N>;

// f(B_SMEM tag, NT tag, nt_max) for the kernel nq queries at width dk take
template <int FIELDS, typename F>
int with_mma_shape(int dk, int nq, F&& f) {
  const int fit = mma_fit<FIELDS>(dk), nt = mma_nt(nq);
  const int nt_max = fit < 1 ? nt : (fit < nt ? fit : nt);
  if (fit < 1) {
    if (nt == 2) return f(smem_tag<false>{}, nt_tag<2>{}, nt_max);
    if (nt == 4) return f(smem_tag<false>{}, nt_tag<4>{}, nt_max);
    return f(smem_tag<false>{}, nt_tag<8>{}, nt_max);
  }
  if (nt == 2) return f(smem_tag<true>{}, nt_tag<2>{}, nt_max);
  if (nt == 4) return f(smem_tag<true>{}, nt_tag<4>{}, nt_max);
  return f(smem_tag<true>{}, nt_tag<8>{}, nt_max);
}

// the batched scan of nq >= 2 queries: packed is packed_t [dk, C], 16-byte
// aligned, C % 128 == 0
template <int KIND, int FIELDS>
int launch_batched(const uint8_t* packed, int dk, long long c, const QueryWords& qw, int nq,
                   int groups, const int* bias, const float* corr, const float* inv,
                   long long n, void* out, cudaStream_t s) {
  return with_mma_shape<FIELDS>(dk, nq, [&](auto b_smem, auto nt, int nt_max) {
    return launch_mma<KIND, decltype(b_smem)::value, FIELDS, decltype(nt)::value>(
        packed, dk, c, qw, nq, groups, nt_max, bias, corr, inv, n, out, s);
  });
}

// blocks per SM of the batched scan of nq queries at width dk
template <int KIND, int FIELDS>
int batched_blocks_per_sm(int dk, int nq, int* per_sm) {
  return with_mma_shape<FIELDS>(dk, nq, [&](auto b_smem, auto nt, int nt_max) {
    return mma_blocks_per_sm<KIND, decltype(b_smem)::value, FIELDS, decltype(nt)::value>(
        dk, nt_max, per_sm, nullptr);
  });
}

}  // namespace
