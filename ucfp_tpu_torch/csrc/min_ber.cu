// The Haitsma-Kalker (Philips) minimum bit-error-rate search.
//
// ucfp_min_ber replaces min_ber_batch of ucfp_tpu/ops/audio/haitsma.py
// (202-246), which is no Pallas kernel but a lax.fori_loop over every
// offset of an XOR + popcount over [R, Qb] words; PyTorch has no popcount,
// so the port's counterpart is this kernel. For each stored row r of db
// [R, Tb] (u32 words), its true length lens[r], and a query q [Qb] with
// q_true live words:
//   errs(o) = sum_{j < q_true} popc(db[r, o + j] ^ q[j])
//   over the offsets 0 <= o <= min(lens[r] - q_true, Tb - Qb)
// (the reference slides over Tb - Qb + 1 offsets and masks those past
// lens[r] - q_true). The minimum errs wins, the FIRST minimal offset on a
// tie (the reference's strict < over ascending offsets, on BERs that order
// as the errs do since errs < 2^22 and one denominator serves the row).
// The kernel writes each row's best key, errs << 32 | offset, or all ones
// for a row with no offset (lens[r] < q_true, dead rows included); the
// wrapper (ops/audio/haitsma.py) turns it into ber = errs / (32 *
// max(q_true, 1)) in float32, IEEE division, and the offset, (inf, -1)
// for none.
//
// Bound: operations. The popcounts, sum_r (lens[r] - q_true + 1) * q_true,
// run at 16 per clock per SM (compute capability 9.0); at the served shape
// (2^14 rows of 2,311 words, Tb 4,096, a 359-word query) that is ~1.15e10,
// ~2.7 ms on 132 SMs at 1.98 GHz, while the 256 MB of rows take ~0.08 ms
// at 3.35 TB/s.
//
// Design (simple first): one block per (row, tile of MB_THREADS offsets),
// one thread per offset. The block stages the query and the tile's window
// (MB_THREADS + chunk - 1 words) in shared memory, MB_QCHUNK query words a
// pass, so a query or a row of any length fits (a 1-hour track is ~281k
// words); each thread then loops over the chunk's words: a broadcast read
// of the query word, a conflict-free read of the window word, XOR, popc,
// add. The block reduces its threads' keys (errs << 32 | offset, whose
// unsigned order is errs first, then the lower offset) and one 64-bit
// atomicMin per block folds them into the row's best. The wrapper turns
// each best key into (ber, offset).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MB_THREADS = 256;  // offsets per block, one per thread
constexpr int MB_QCHUNK = 1024;  // query words staged per pass
constexpr unsigned long long NO_OFFSET = ~0ull;

__device__ __forceinline__ unsigned long long min_u64(unsigned long long a,
                                                      unsigned long long b) {
  return b < a ? b : a;
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = min_u64(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

__global__ void __launch_bounds__(MB_THREADS)
min_ber_tiles(const uint32_t* __restrict__ db, long long tb, const int* __restrict__ lens,
              const uint32_t* __restrict__ q, int qb, int q_true, int tiles,
              unsigned long long* __restrict__ best) {
  __shared__ uint32_t qs[MB_QCHUNK];
  __shared__ uint32_t win[MB_THREADS + MB_QCHUNK];
  __shared__ unsigned long long warp_best[MB_THREADS / 32];
  const int r = blockIdx.x;
  const uint32_t* row = db + (long long)r * tb;
  // the row's last offset; below 0 when the query is longer than the row
  const long long last = min((long long)lens[r] - q_true, tb - qb);
  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const long long o0 = (long long)tile * MB_THREADS;
    if (o0 > last) break;  // the same for every thread of the block
    unsigned errs = 0;
    for (int c0 = 0; c0 < q_true; c0 += MB_QCHUNK) {
      const int cn = min(MB_QCHUNK, q_true - c0);
      __syncthreads();  // the previous pass is done with the shared words
      for (int i = threadIdx.x; i < cn; i += MB_THREADS) qs[i] = q[c0 + i];
      const int wn = MB_THREADS + cn - 1;
      for (int i = threadIdx.x; i < wn; i += MB_THREADS) {
        const long long g = o0 + c0 + i;
        win[i] = g < tb ? row[g] : 0u;
      }
      __syncthreads();
      const uint32_t* w = win + threadIdx.x;
#pragma unroll 8
      for (int j = 0; j < cn; ++j) errs += __popc(w[j] ^ qs[j]);
    }
    const long long o = o0 + threadIdx.x;
    unsigned long long key =
        o <= last ? ((unsigned long long)errs << 32) | (unsigned long long)o : NO_OFFSET;
    key = warp_min(key);
    if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x >> 5] = key;
    __syncthreads();
    if (threadIdx.x < 32) {
      key = threadIdx.x < MB_THREADS / 32 ? warp_best[threadIdx.x] : NO_OFFSET;
      key = warp_min(key);
      if (threadIdx.x == 0 && key != NO_OFFSET) atomicMin(best + r, key);
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
  const int tiles = (int)((n_off + MB_THREADS - 1) / MB_THREADS);
  const dim3 grid(rows, tiles < 65535 ? tiles : 65535);
  min_ber_tiles<<<grid, MB_THREADS, 0, s>>>(db, tb, lens, q, qb, q_true, tiles, best);
  return (int)cudaGetLastError();
}
