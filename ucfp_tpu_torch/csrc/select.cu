// Top-k selection over the fused scans' candidates.
//
// ucfp_select_topk replaces the final jax.lax.top_k that every scan of
// ucfp_tpu/ops/pallas_scan.py runs outside its pallas_call over the flat
// [Q, tiles * 128] candidates (pallas_scan.py:133, 230, 309, 352-354, 482,
// 555-560, 652, 768): the first k of a stable sort, largest first (or
// smallest first), ties to the LOWER candidate position. Values are
// float32, bfloat16 (widened exactly) or int32 (Hamming distances).
//
// Keys. Every candidate gets a unique 64-bit key: the high word is the
// value's order-preserving bits (floats: -0.0 made +0.0 first, since the
// stable sort holds them equal and the position decides; sign flipped for
// positives, all bits for negatives; int32: the sign bit flipped), all
// bits complemented for smallest-first; the low word is the reversed
// position N - 1 - pos, so the lower position wins a tie. The k largest
// keys in descending order are then exactly the stable sort's first k.
// The values written out are the originals (a -0.0 keeps its sign). NaN
// never reaches this function: the scans' scores are finite or +-inf and
// no order is defined for it here.
//
// Bound: device memory, barely -- one read of the candidates (N * 4 or
// N * 2 bytes per query, 64 KB at N = 16,384), which the cells kernel has
// just written and which sit in the 50 MB L2; the time is the passes'
// latency, not bytes. Design: one block of 1,024 threads per query.
// One SM walks a query's candidates several times, so the design is
// about round trips: every pass issues 8 (histogram) or 16 (compaction)
// loads a thread before it uses any, and where the query's order words
// fit in shared memory beside the sort (N * 4 bytes: N = 16,384 and
// 39,040 do, 78,080 does not) the first pass keeps them there.
//  1. Radix select of the high word, 8 bits a pass from the top: a 256-bin
//     histogram in shared memory (warp-aggregated atomics, so a run of
//     equal values does not serialize on one bin), a block scan picks the
//     bin that holds the k-th key. It stops early once that bin is taken
//     whole. This gives the threshold word T and how many keys equal to T
//     the answer takes (the first ones by position).
//  2. One compaction pass in position order: ballots give each warp's
//     counts of the keys above T and equal to T, one scan of the (item,
//     warp) totals gives every winner its slot, and the k winners' keys go
//     to shared memory.
//  3. A bitonic sort of the k keys in shared memory, descending (up to
//     SORT_CAP = 16,384 keys, 128 KB). For a larger k the winners go to
//     device memory, runs of SORT_CAP are sorted in shared memory, and
//     runs are merged in device memory: each key's slot in the merged run
//     is its own index plus its rank in the partner run, found by a binary
//     search (the keys are unique, so the ranks never collide).
//  4. The values and catalog indices of the winners are gathered from the
//     candidates in key order.
//
// Plain C interface (loaded with ctypes): launches on the caller's stream,
// allocates nothing (the >SORT_CAP scratch comes from the wrapper, sized
// by ucfp_select_scratch),
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int HU = 16;     // loads in flight per thread in a histogram pass
constexpr int ITEMS = 16;  // candidates per thread in a compaction chunk
constexpr int RADIX = 256;
constexpr int SORT_CAP = 16384;  // keys one block sorts in shared memory
constexpr int SMEM_MAX = 220 * 1024;  // dynamic shared memory: keys + cached words
constexpr unsigned FULL = 0xffffffffu;

constexpr int VAL_F32 = 0;
constexpr int VAL_BF16 = 1;
constexpr int VAL_I32 = 2;

template <int KIND>
__device__ __forceinline__ uint32_t order_word(const void* __restrict__ vals, long long i,
                                               bool largest) {
  uint32_t b;
  if constexpr (KIND == VAL_I32) {
    b = reinterpret_cast<const uint32_t*>(vals)[i] ^ 0x80000000u;
  } else {
    if constexpr (KIND == VAL_F32)
      b = reinterpret_cast<const uint32_t*>(vals)[i];
    else
      b = (uint32_t)reinterpret_cast<const uint16_t*>(vals)[i] << 16;
    if (b == 0x80000000u) b = 0u;  // -0.0 ties with +0.0
    b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
  return largest ? b : ~b;
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v += y;
  }
  return v;
}

// one compare-exchange of element i (value x) with element i ^ stride
// (value y) in a bitonic stage of `size`: the lower index of a pair keeps
// the larger key where the stage sorts descending
__device__ __forceinline__ unsigned long long bitonic_keep(unsigned long long x,
                                                           unsigned long long y, int i,
                                                           int stride, int size) {
  const bool desc = (i & size) == 0, low = (i & stride) == 0;
  return (desc == low) ? (x > y ? x : y) : (x < y ? x : y);
}

// the stages of sizes [size_lo, size_hi] whose strides are below 64, in
// registers: each warp holds 64-key segments, keys lane and lane + 32,
// so stride 32 pairs a thread's own two keys and smaller strides pair
// lanes (shuffles); no block barrier inside
__device__ void bitonic_warp(unsigned long long* s, int p, int size_lo, int size_hi) {
  const int lane = threadIdx.x & 31;
  for (int seg = (threadIdx.x >> 5) * 64; seg < p; seg += THREADS * 2) {
    const int ia = seg + lane, ib = ia + 32;
    unsigned long long a = s[ia], b = s[ib];
    for (int size = size_lo; size <= size_hi; size <<= 1) {
      for (int stride = size > 64 ? 32 : size >> 1; stride > 0; stride >>= 1) {
        if (stride == 32) {
          const unsigned long long na = bitonic_keep(a, b, ia, 32, size);
          b = bitonic_keep(b, a, ib, 32, size);
          a = na;
        } else {
          a = bitonic_keep(a, __shfl_xor_sync(FULL, a, stride), ia, stride, size);
          b = bitonic_keep(b, __shfl_xor_sync(FULL, b, stride), ib, stride, size);
        }
      }
    }
    s[ia] = a;
    s[ib] = b;
  }
  __syncthreads();
}

// descending bitonic sort of s[0..p), p a power of two >= 64: strides of
// 64 and more are block steps (one barrier each), the rest bitonic_warp
__device__ void bitonic_desc(unsigned long long* s, int p) {
  bitonic_warp(s, p, 2, 64);
  for (int size = 128; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride >= 64; stride >>= 1) {
      for (int t = threadIdx.x; t < p / 2; t += THREADS) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const unsigned long long a = s[lo], b = s[hi];
        if ((a < b) == desc) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
    bitonic_warp(s, p, size, size);
  }
}

// shared-memory sort slots for k keys: a power of two, 64 to SORT_CAP
__host__ __device__ __forceinline__ int sort_slots(int k) {
  int p = 64;
  while (p < k && p < SORT_CAP) p <<= 1;
  return p;
}

// whether a query's order words fit in shared memory beside the sort
__host__ __device__ __forceinline__ bool words_fit(int n, int k) {
  return (long long)sort_slots(k) * 8 + (long long)n * 4 <= SMEM_MAX;
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
select_topk_kernel(const void* __restrict__ vals, const int* __restrict__ gidx, int n, int k,
                   int largest_i, void* __restrict__ out_val, int* __restrict__ out_idx,
                   unsigned long long* __restrict__ scratch) {
  extern __shared__ unsigned long long s_keys[];
  __shared__ int s_hist[RADIX];
  __shared__ int s_tot[ITEMS][WARPS];  // compaction: per (item, warp) counts, then offsets
  __shared__ int s_row[ITEMS];
  __shared__ int s_sel[3];  // digit, keys still needed from it, its count
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool largest = largest_i != 0;
  const long long base = (long long)blockIdx.x * n;
  const void* v = vals;
  const int p = sort_slots(k);
  // the order words, computed once in the first pass, when they fit
  uint32_t* s_words = words_fit(n, k) ? reinterpret_cast<uint32_t*>(s_keys + p) : nullptr;

  // 1. radix select of the k-th largest order word
  uint32_t prefix = 0u, mask = 0u;
  int need = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (tid < RADIX) s_hist[tid] = 0;
    __syncthreads();
    for (int i0 = 0; i0 < n; i0 += THREADS * HU) {
      uint32_t u[HU];
#pragma unroll
      for (int j = 0; j < HU; ++j) {  // all loads first: one round trip per HU
        const int i = i0 + j * THREADS + tid;
        u[j] = 0u;
        if (i < n)
          u[j] = (s_words && shift != 24) ? s_words[i] : order_word<KIND>(v, base + i, largest);
      }
#pragma unroll
      for (int j = 0; j < HU; ++j) {
        const int i = i0 + j * THREADS + tid;
        if (s_words && shift == 24 && i < n) s_words[i] = u[j];
        int digit = RADIX;  // not counted
        if (i < n && (u[j] & mask) == prefix) digit = (int)((u[j] >> shift) & 0xffu);
        // a warp of one digit (a run of equal values, the -inf of invalid
        // rows, the tail past n) adds once instead of 32 times to one bin
        const int d0 = __shfl_sync(FULL, digit, 0);
        if (__all_sync(FULL, digit == d0)) {
          if (lane == 0 && d0 < RADIX) atomicAdd(&s_hist[d0], 32);
        } else if (digit < RADIX) {
          atomicAdd(&s_hist[digit], 1);
        }
      }
    }
    __syncthreads();
    // bins from the top: thread t holds bin 255 - t
    int h = 0, incl = 0;
    if (tid < RADIX) {
      h = s_hist[RADIX - 1 - tid];
      incl = warp_incl_scan(h, lane);
      if (lane == 31) s_row[warp] = incl;
    }
    __syncthreads();
    if (tid < RADIX) {
      for (int w = 0; w < warp; ++w) incl += s_row[w];
      const int above = incl - h;  // keys in higher bins
      if (above < need && incl >= need) {
        s_sel[0] = RADIX - 1 - tid;
        s_sel[1] = need - above;
        s_sel[2] = h;
      }
    }
    __syncthreads();
    prefix |= (uint32_t)s_sel[0] << shift;
    mask |= 0xffu << shift;
    need = s_sel[1];
    const bool whole = s_sel[1] == s_sel[2];
    __syncthreads();  // s_sel, s_row and s_hist are rewritten by the next pass
    if (whole) break;  // the bin is taken whole: the masked word decides
  }

  // 2. compaction in position order: the keys above the threshold, then
  // the first `need` keys equal to it. A chunk is THREADS * ITEMS
  // candidates, item j of thread t at i0 + j * THREADS + t, so the
  // position order is (item, warp, lane); one scan of the (item, warp)
  // totals gives every thread its offsets.
  const bool in_smem = k <= SORT_CAP;
  unsigned long long* dst = in_smem ? s_keys : scratch + (long long)blockIdx.x * k;
  const int n_gt = k - need;
  const unsigned lt = (1u << lane) - 1u;
  int run_gt = 0, run_eq = 0;
  for (int i0 = 0; i0 < n; i0 += THREADS * ITEMS) {
    uint32_t u[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = i0 + j * THREADS + tid;
      u[j] = 0u;
      if (i < n) u[j] = s_words ? s_words[i] : order_word<KIND>(v, base + i, largest);
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = i0 + j * THREADS + tid;
      const uint32_t m = u[j] & mask;
      const unsigned bgt = __ballot_sync(FULL, i < n && m > prefix);
      const unsigned beq = __ballot_sync(FULL, i < n && m == prefix);
      if (lane == 0) s_tot[j][warp] = __popc(bgt) | (__popc(beq) << 16);
    }
    __syncthreads();
    for (int j = warp; j < ITEMS; j += WARPS) {  // warp j scans item row j over the warps
      const int t = lane < WARPS ? s_tot[j][lane] : 0;
      const int inc = warp_incl_scan(t, lane);
      if (lane < WARPS) s_tot[j][lane] = inc - t;
      if (lane == 31) s_row[j] = inc;
    }
    __syncthreads();
    int row_off = 0;  // keys of this chunk before item row j
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = i0 + j * THREADS + tid;
      const uint32_t m = u[j] & mask;
      const bool is_gt = i < n && m > prefix, is_eq = i < n && m == prefix;
      const unsigned bgt = __ballot_sync(FULL, is_gt), beq = __ballot_sync(FULL, is_eq);
      const int before = row_off + s_tot[j][warp];
      row_off += s_row[j];
      const int gb = run_gt + (before & 0xffff) + __popc(bgt & lt);
      const int eb = run_eq + (before >> 16) + __popc(beq & lt);
      const unsigned long long key = ((unsigned long long)u[j] << 32) | (uint32_t)(n - 1 - i);
      if (is_gt) dst[gb + min(eb, need)] = key;
      else if (is_eq && eb < need) dst[gb + eb] = key;
    }
    run_gt += row_off & 0xffff;
    run_eq += row_off >> 16;
    __syncthreads();  // s_tot and s_row are rewritten by the next chunk
    if (run_gt == n_gt && run_eq >= need) break;
  }

  // 3. sort the k winners by key, descending
  const unsigned long long* sorted;
  if (in_smem) {
    for (int i = k + tid; i < p; i += THREADS) s_keys[i] = 0ull;  // below every real key
    __syncthreads();
    bitonic_desc(s_keys, p);
    sorted = s_keys;
  } else {
    for (int r0 = 0; r0 < k; r0 += SORT_CAP) {
      const int len = min(SORT_CAP, k - r0);
      const int pr = sort_slots(len);
      for (int i = tid; i < pr; i += THREADS) s_keys[i] = i < len ? dst[r0 + i] : 0ull;
      __syncthreads();
      bitonic_desc(s_keys, pr);
      for (int i = tid; i < len; i += THREADS) dst[r0 + i] = s_keys[i];
      __syncthreads();
    }
    unsigned long long* src = dst;
    unsigned long long* oth = scratch + (long long)gridDim.x * k + (long long)blockIdx.x * k;
    for (int run = SORT_CAP; run < k; run <<= 1) {
      for (int i = tid; i < k; i += THREADS) {
        const int r = i / run;
        const int start = r * run;
        const int pstart = (r ^ 1) * run;
        const int plen = pstart < k ? min(run, k - pstart) : 0;
        const unsigned long long key = src[i];
        // rank: partner keys above this one (descending, all distinct)
        int lo = 0, hi = plen;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (src[pstart + mid] > key) lo = mid + 1;
          else hi = mid;
        }
        oth[min(start, pstart) + (i - start) + lo] = key;
      }
      __syncthreads();
      unsigned long long* t = src;
      src = oth;
      oth = t;
    }
    sorted = src;
  }

  // 4. gather the winners' own values and catalog indices
  const long long ob = (long long)blockIdx.x * k;
  for (int i = tid; i < k; i += THREADS) {
    const long long pos = base + (n - 1 - (int)(uint32_t)sorted[i]);
    if constexpr (KIND == VAL_BF16)
      static_cast<uint16_t*>(out_val)[ob + i] = static_cast<const uint16_t*>(vals)[pos];
    else
      static_cast<uint32_t*>(out_val)[ob + i] = static_cast<const uint32_t*>(vals)[pos];
    out_idx[ob + i] = gidx[pos];
  }
}

template <int KIND>
int launch(const void* vals, const int* gidx, int q, int n, int k, int largest, void* out_val,
           int* out_idx, unsigned long long* scratch, cudaStream_t s) {
  const int smem = sort_slots(k) * (int)sizeof(unsigned long long) + (words_fit(n, k) ? n * 4 : 0);
  if (smem > 48 * 1024) {  // above the default limit: opt in (per device)
    const cudaError_t e = cudaFuncSetAttribute(
        select_topk_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  select_topk_kernel<KIND><<<q, THREADS, smem, s>>>(vals, gidx, n, k, largest, out_val,
                                                    out_idx, scratch);
  return (int)cudaGetLastError();
}

}  // namespace

// The 8-byte keys of device memory ucfp_select_topk needs as its scratch
// for q queries' top k: 0 (no scratch) while k fits the shared-memory sort.
extern "C" long long ucfp_select_scratch(int q, int k) {
  return k > SORT_CAP ? 2LL * q * k : 0;
}

// kind: 0 float32, 1 bfloat16, 2 int32. scratch: ucfp_select_scratch(q, k)
// keys, or null when that is 0.

extern "C" int ucfp_select_topk(const void* vals, const int* gidx, int kind, int q, int n, int k,
                                int largest, void* out_val, int* out_idx, void* scratch,
                                void* stream) {
  if (q <= 0 || q > 65535 || n <= 0 || k <= 0 || k > n ||
      (k > SORT_CAP && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  auto* sc = static_cast<unsigned long long*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case VAL_F32:
      return launch<VAL_F32>(vals, gidx, q, n, k, largest, out_val, out_idx, sc, s);
    case VAL_BF16:
      return launch<VAL_BF16>(vals, gidx, q, n, k, largest, out_val, out_idx, sc, s);
    case VAL_I32:
      return launch<VAL_I32>(vals, gidx, q, n, k, largest, out_val, out_idx, sc, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
