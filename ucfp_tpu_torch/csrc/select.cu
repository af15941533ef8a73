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
// latency, not bytes. Two launch paths share the steps below:
//  - one block of 1,024 threads per query, where the queries' blocks fill
//    the card (or N is small). One SM walks a query's candidates several
//    times, so the design is about round trips: every pass issues 16
//    loads a thread before it uses any, and where the query's order words
//    fit in shared memory beside the sort (N * 4 bytes: N = 16,384 and
//    39,040 do, 78,080 does not) the first pass keeps them there.
//  - a thread-block cluster of CLUSTER CTAs per query, for a few queries
//    over many candidates (q * CLUSTER <= SMs, N >= CLUSTER_MIN_N): one
//    SM per query left the rest of the card idle and trailed torch.topk
//    from about 40,000 candidates on. CTA r owns the contiguous positions
//    [r * span, (r + 1) * span), span = ceil(N / CLUSTER), and keeps its
//    order words in its shared memory (9,760 words at N = 78,080). Each
//    pass every CTA counts its own 256 bins; after cluster.sync() every
//    CTA sums the cluster's bins through distributed shared memory and so
//    picks the same bin (histograms double-buffered by pass, so one
//    cluster barrier a pass suffices). A CTA's keys above the threshold
//    are its counts in the bins above each pass's pick, its keys equal to
//    it its count in the last pick; an exclusive prefix of those over the
//    lower ranks keeps the position order, so ties still go to the lower
//    position, and each CTA compacts its own range into rank 0's shared
//    memory (k <= SORT_CAP) or the device scratch. Rank 0 sorts and
//    gathers, but from k = SPLIT_MIN_K to SORT_CAP the cluster shares
//    that too: CTA r sorts slice r of the winners (p / CLUSTER slots),
//    copies the other sorted slices into its own shared memory, and
//    writes each of its keys to its index in the slice plus the keys
//    above it in the other slices (binary searches; the keys are unique).
//    fused_scan._select_cluster_plain mirrors the partition and the
//    shared sort.
// The steps:
//  1. Radix select of the high word, 8 bits a pass from the top: a 256-bin
//     histogram in shared memory (warp-aggregated atomics, so a run of
//     equal values does not serialize on one bin), a block scan picks the
//     bin that holds the k-th key. It stops early once that bin is taken
//     whole, and skips the bytes that every key shares (the first pass
//     also takes the AND and OR of the words: Hamming distances share
//     their top three bytes). This gives the threshold word T and how many
//     keys equal to T the answer takes (the first ones by position). A
//     pass runs only the items a thread has positions for, so a short
//     range (a cluster rank's) costs its own length, not 16 items a thread.
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
// What a launch asks of the runtime is asked once per device and value
// kind: the shared-memory cap of both kernels (set to SMEM_MAX), the SM
// count, and how many clusters the card holds at once at the largest
// shared-memory size; a cluster that cannot be scheduled is an error,
// never another path. (Clusters of 16 CTAs, a non-portable size, were no
// faster on an H100 at one query and slower at 16 queries.)
//
// Plain C interface (loaded with ctypes): launches on the caller's stream,
// allocates nothing (the >SORT_CAP scratch comes from the wrapper, sized
// by ucfp_select_scratch),
// returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int HU = 16;     // loads in flight per thread in a histogram pass
constexpr int ITEMS = 16;  // candidates per thread in a compaction chunk
constexpr int RADIX = 256;
constexpr int SORT_CAP = 16384;  // keys one block sorts in shared memory
constexpr int SMEM_MAX = 220 * 1024;  // dynamic shared memory: keys + cached words
constexpr unsigned FULL = 0xffffffffu;
constexpr int CLUSTER = 8;  // CTAs per query on the cluster path (the portable size)
constexpr int CLUSTER_MIN_N = 12288;  // fewer candidates: one block per query
constexpr int SPLIT_MIN_K = 513;  // from this k the cluster shares the sort of the winners
constexpr int MAX_DEVICES = 64;

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

// positions per CTA of a cluster over n candidates
__host__ __device__ __forceinline__ int cluster_span(int n) {
  return (n + CLUSTER - 1) / CLUSTER;
}

// whether a block's `words` order words fit in shared memory beside the sort
__host__ __device__ __forceinline__ bool words_fit(int words, int k) {
  return (long long)sort_slots(k) * 8 + (long long)words * 4 <= SMEM_MAX;
}

// one radix pass's histogram over positions [lo, lo + len) of a query:
// the 8 bits at `shift` of every word whose masked bits equal prefix. The
// first pass (shift 24) reads the candidates, keeps the words in s_words
// when given (later passes read them back from there), and folds the
// words into bits[0] (AND) and bits[1] (OR), which start at ~0 and 0.
template <int KIND>
__device__ void count_digits(const void* __restrict__ v, long long base, int lo, int len,
                             bool largest, uint32_t* s_words, int shift, uint32_t mask,
                             uint32_t prefix, int* hist, unsigned* bits) {
  const int tid = threadIdx.x, lane = tid & 31;
  uint32_t all = ~0u, any = 0u;
  for (int i0 = 0; i0 < len; i0 += THREADS * HU) {
    // the items that hold a position: a small range skips the rest
    const int jn = min(HU, (len - i0 + THREADS - 1) / THREADS);
    uint32_t u[HU];
#pragma unroll
    for (int j = 0; j < HU; ++j) {  // all loads first: one round trip per HU
      const int i = i0 + j * THREADS + tid;
      u[j] = 0u;
      if (j < jn && i < len)
        u[j] = (s_words && shift != 24) ? s_words[i]
                                        : order_word<KIND>(v, base + lo + i, largest);
    }
#pragma unroll
    for (int j = 0; j < HU; ++j) {
      if (j >= jn) break;  // the same for the whole block
      const int i = i0 + j * THREADS + tid;
      if (shift == 24 && i < len) {
        if (s_words) s_words[i] = u[j];
        all &= u[j];
        any |= u[j];
      }
      int digit = RADIX;  // not counted
      if (i < len && (u[j] & mask) == prefix) digit = (int)((u[j] >> shift) & 0xffu);
      // a warp of one digit (a run of equal values, the -inf of invalid
      // rows, the tail past the range) adds once instead of 32 times
      const int d0 = __shfl_sync(FULL, digit, 0);
      if (__all_sync(FULL, digit == d0)) {
        if (lane == 0 && d0 < RADIX) atomicAdd(&hist[d0], 32);
      } else if (digit < RADIX) {
        atomicAdd(&hist[digit], 1);
      }
    }
  }
  if (shift == 24) {
    all = __reduce_and_sync(FULL, all);
    any = __reduce_or_sync(FULL, any);
    if (lane == 0) {
      atomicAnd(&bits[0], all);
      atomicOr(&bits[1], any);
    }
  }
}

// after the first pass: the bytes below the top one that every key shares
// (AND and OR of all the words agree there) need no pass of their own;
// they join the threshold's prefix and mask, and *shift moves past them
__device__ __forceinline__ void skip_shared_bytes(unsigned all, unsigned any, int* shift,
                                                  uint32_t* prefix, uint32_t* mask) {
  const uint32_t same = ~(all ^ any);
  while (*shift > 0 && ((same >> (*shift - 8)) & 0xffu) == 0xffu) {
    *shift -= 8;
    *prefix |= all & (0xffu << *shift);
    *mask |= 0xffu << *shift;
  }
}

// the bin that holds the need-th key: thread t < RADIX holds h, the count
// of bin RADIX - 1 - t (bins from the top). Sets s_sel to (digit, keys
// still needed from it, its count); ends with a block barrier.
__device__ void pick_bin(int h, int need, int* s_row, int* s_sel) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int incl = 0;
  if (tid < RADIX) {
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
}

// 2. compaction of positions [lo, lo + len) of a query of n in position
// order: the keys above the threshold (masked word > prefix), then the
// first `need` keys equal to it, given run_gt / run_eq keys of each kind
// at lower positions. A key above takes slot (above before) + min(equal
// before, need), a key equal (above before) + (equal before). A chunk is
// THREADS * ITEMS positions, item j of thread t at i0 + j * THREADS + t,
// so the position order is (item, warp, lane); one scan of the (item,
// warp) totals gives every thread its offsets.
template <int KIND>
__device__ void compact(const void* __restrict__ v, long long base, int n, int lo, int len,
                        bool largest, const uint32_t* s_words, uint32_t mask,
                        uint32_t prefix, int k, int need, int run_gt, int run_eq,
                        unsigned long long* dst, int (*s_tot)[WARPS], int* s_row) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_gt = k - need;
  const unsigned lt = (1u << lane) - 1u;
  if (run_gt == n_gt && run_eq >= need) return;  // lower positions took every slot
  for (int i0 = 0; i0 < len; i0 += THREADS * ITEMS) {
    // the item rows that hold a position (the same for the whole block)
    const int jn = min(ITEMS, (len - i0 + THREADS - 1) / THREADS);
    uint32_t u[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = i0 + j * THREADS + tid;
      u[j] = 0u;
      if (j < jn && i < len)
        u[j] = s_words ? s_words[i] : order_word<KIND>(v, base + lo + i, largest);
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (j >= jn) break;
      const int i = i0 + j * THREADS + tid;
      const uint32_t m = u[j] & mask;
      const unsigned bgt = __ballot_sync(FULL, i < len && m > prefix);
      const unsigned beq = __ballot_sync(FULL, i < len && m == prefix);
      if (lane == 0) s_tot[j][warp] = __popc(bgt) | (__popc(beq) << 16);
    }
    __syncthreads();
    for (int j = warp; j < jn; j += WARPS) {  // warp j scans item row j over the warps
      const int t = lane < WARPS ? s_tot[j][lane] : 0;
      const int inc = warp_incl_scan(t, lane);
      if (lane < WARPS) s_tot[j][lane] = inc - t;
      if (lane == 31) s_row[j] = inc;
    }
    __syncthreads();
    int row_off = 0;  // keys of this chunk before item row j
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (j >= jn) break;
      const int i = i0 + j * THREADS + tid;
      const uint32_t m = u[j] & mask;
      const bool is_gt = i < len && m > prefix, is_eq = i < len && m == prefix;
      const unsigned bgt = __ballot_sync(FULL, is_gt), beq = __ballot_sync(FULL, is_eq);
      const int before = row_off + s_tot[j][warp];
      row_off += s_row[j];
      const int gb = run_gt + (before & 0xffff) + __popc(bgt & lt);
      const int eb = run_eq + (before >> 16) + __popc(beq & lt);
      const unsigned long long key =
          ((unsigned long long)u[j] << 32) | (uint32_t)(n - 1 - (lo + i));
      if (is_gt) dst[gb + min(eb, need)] = key;
      else if (is_eq && eb < need) dst[gb + eb] = key;
    }
    run_gt += row_off & 0xffff;
    run_eq += row_off >> 16;
    __syncthreads();  // s_tot and s_row are rewritten by the next chunk
    if (run_gt == n_gt && run_eq >= need) break;
  }
}

// 3-4. sort the k winners by key, descending, then gather their own values
// and catalog indices into row `ob` of the outputs. The winners are in
// s_keys (k <= SORT_CAP, p slots) or in the device scratch run `dst`, with
// `oth` a second run of k keys for the merges.
template <int KIND>
__device__ void sort_gather(unsigned long long* s_keys, int p, int k, unsigned long long* dst,
                            unsigned long long* oth, const void* __restrict__ vals,
                            const int* __restrict__ gidx, long long base, int n,
                            void* __restrict__ out_val, int* __restrict__ out_idx,
                            long long ob) {
  const int tid = threadIdx.x;
  const unsigned long long* sorted;
  if (k <= SORT_CAP) {
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
  for (int i = tid; i < k; i += THREADS) {
    const long long pos = base + (n - 1 - (int)(uint32_t)sorted[i]);
    if constexpr (KIND == VAL_BF16)
      static_cast<uint16_t*>(out_val)[ob + i] = static_cast<const uint16_t*>(vals)[pos];
    else
      static_cast<uint32_t*>(out_val)[ob + i] = static_cast<const uint32_t*>(vals)[pos];
    out_idx[ob + i] = gidx[pos];
  }
}

// one block of THREADS per query (blockIdx.x)
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
  __shared__ unsigned s_bits[2];  // AND and OR of the query's words
  const int tid = threadIdx.x;
  const bool largest = largest_i != 0;
  const long long base = (long long)blockIdx.x * n;
  const int p = sort_slots(k);
  // the order words, computed once in the first pass, when they fit
  uint32_t* s_words = words_fit(n, k) ? reinterpret_cast<uint32_t*>(s_keys + p) : nullptr;

  // 1. radix select of the k-th largest order word
  uint32_t prefix = 0u, mask = 0u;
  int need = k;
  if (tid < 2) s_bits[tid] = tid ? 0u : ~0u;
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (tid < RADIX) s_hist[tid] = 0;
    __syncthreads();
    count_digits<KIND>(vals, base, 0, n, largest, s_words, shift, mask, prefix, s_hist, s_bits);
    __syncthreads();
    pick_bin(tid < RADIX ? s_hist[RADIX - 1 - tid] : 0, need, s_row, s_sel);
    prefix |= (uint32_t)s_sel[0] << shift;
    mask |= 0xffu << shift;
    need = s_sel[1];
    const bool whole = s_sel[1] == s_sel[2];
    __syncthreads();  // s_sel, s_row and s_hist are rewritten by the next pass
    if (whole) break;  // the bin is taken whole: the masked word decides
    if (shift == 24) skip_shared_bytes(s_bits[0], s_bits[1], &shift, &prefix, &mask);
  }
  unsigned long long* dst = k <= SORT_CAP ? s_keys : scratch + (long long)blockIdx.x * k;
  compact<KIND>(vals, base, n, 0, n, largest, s_words, mask, prefix, k, need, 0, 0, dst, s_tot,
                s_row);
  const long long ob = (long long)blockIdx.x * k;
  sort_gather<KIND>(s_keys, p, k, dst, scratch + (long long)gridDim.x * k + ob, vals, gidx, base,
                    n, out_val, out_idx, ob);
}

// one cluster of CLUSTER CTAs per query (blockIdx.y); CTA r owns the
// positions [r * span, (r + 1) * span)
template <int KIND>
__global__ void __launch_bounds__(THREADS)
select_cluster_kernel(const void* __restrict__ vals, const int* __restrict__ gidx, int n, int k,
                      int largest_i, void* __restrict__ out_val, int* __restrict__ out_idx,
                      unsigned long long* __restrict__ scratch) {
  extern __shared__ unsigned long long s_keys[];
  __shared__ int s_hist[2][RADIX];  // this CTA's counts, by pass parity
  __shared__ int s_tot[ITEMS][WARPS];
  __shared__ int s_row[ITEMS];
  __shared__ int s_sel[3];
  __shared__ int s_cnt[2];  // this CTA's keys above / equal to the threshold
  __shared__ int s_pre[2];  // the same, summed over the lower ranks
  __shared__ unsigned s_bits[2];  // AND and OR of this CTA's words
  __shared__ unsigned s_all[2];   // ... and of the cluster's
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31;
  const int rank = (int)cluster.block_rank();
  const bool largest = largest_i != 0;
  const long long qi = blockIdx.y;
  const long long base = qi * n;
  const int p = sort_slots(k);
  const int span = cluster_span(n);
  const int lo = min(n, rank * span);
  const int len = min(n, lo + span) - lo;
  uint32_t* s_words = words_fit(span, k) ? reinterpret_cast<uint32_t*>(s_keys + p) : nullptr;
  if (tid < 2) {
    s_cnt[tid] = 0;
    s_bits[tid] = tid ? 0u : ~0u;
  }

  // 1. radix select over the cluster's summed histograms
  uint32_t prefix = 0u, mask = 0u;
  int need = k;
  for (int shift = 24, pass = 0; shift >= 0; shift -= 8, ++pass) {
    int* hist = s_hist[pass & 1];
    if (tid < RADIX) hist[tid] = 0;
    __syncthreads();
    count_digits<KIND>(vals, base, lo, len, largest, s_words, shift, mask, prefix, hist,
                       s_bits);
    // every CTA's counts of this pass are in; this pass's buffer is not
    // zeroed again before every CTA has passed the next pass's barrier
    cluster.sync();
    int h = 0, own = 0;
    if (tid < RADIX) {
      own = hist[RADIX - 1 - tid];
#pragma unroll
      for (int r = 0; r < CLUSTER; ++r)  // the ranks' loads all in flight
        h += cluster.map_shared_rank(&hist[0], r)[RADIX - 1 - tid];
    }
    if (shift == 24 && tid < 32) {  // the cluster's AND and OR, read by every thread
      unsigned all = ~0u, any = 0u;  // after pick_bin's barriers
      if (lane < CLUSTER) {
        const unsigned* b = cluster.map_shared_rank(&s_bits[0], lane);
        all = b[0];
        any = b[1];
      }
      all = __reduce_and_sync(FULL, all);
      any = __reduce_or_sync(FULL, any);
      if (lane == 0) {
        s_all[0] = all;
        s_all[1] = any;
      }
    }
    pick_bin(h, need, s_row, s_sel);
    const int digit = s_sel[0];
    if (tid < RADIX) {  // this CTA's keys in the bins above the pick are above T
      const int above = __reduce_add_sync(FULL, RADIX - 1 - tid > digit ? own : 0);
      if (lane == 0 && above) atomicAdd(&s_cnt[0], above);
      if (RADIX - 1 - tid == digit) s_cnt[1] = own;  // the last pass's is kept
    }
    prefix |= (uint32_t)digit << shift;
    mask |= 0xffu << shift;
    need = s_sel[1];
    const bool whole = s_sel[1] == s_sel[2];
    __syncthreads();
    if (whole) break;  // the same pass in every CTA: the bins are the cluster's
    if (shift == 24) skip_shared_bytes(s_all[0], s_all[1], &shift, &prefix, &mask);
  }
  cluster.sync();  // every CTA's counts are in
  if (tid < 32) {
    int gt = 0, eq = 0;
    if (lane < rank) {
      const int* c = cluster.map_shared_rank(&s_cnt[0], lane);
      gt = c[0];
      eq = c[1];
    }
    gt = __reduce_add_sync(FULL, gt);
    eq = __reduce_add_sync(FULL, eq);
    if (lane == 0) {
      s_pre[0] = gt;
      s_pre[1] = eq;
    }
  }
  __syncthreads();
  unsigned long long* dst =
      k <= SORT_CAP ? cluster.map_shared_rank(&s_keys[0], 0) : scratch + qi * k;
  compact<KIND>(vals, base, n, lo, len, largest, s_words, mask, prefix, k, need, s_pre[0],
                s_pre[1], dst, s_tot, s_row);
  cluster.sync();  // the winners are in rank 0's shared memory or the scratch
  if (k < SPLIT_MIN_K || k > SORT_CAP) {
    if (rank != 0) return;  // no CTA reads another's shared memory from here on
    sort_gather<KIND>(s_keys, p, k, k <= SORT_CAP ? s_keys : dst,
                      scratch + (long long)gridDim.y * k + qi * k, vals, gidx, base, n,
                      out_val, out_idx, qi * k);
    return;
  }
  // 3-4 shared by the cluster. Slice r of the winners, slots [r * c, (r +
  // 1) * c) with c = p / CLUSTER (p is 8c from k = 513 on), is copied from
  // rank 0 into CTA r at the same slots, padded with keys below every real
  // one, and sorted there.
  const int c = p / CLUSTER;
  unsigned long long* slice = s_keys + rank * c;
  const unsigned long long* src = cluster.map_shared_rank(&s_keys[0], 0) + rank * c;
  for (int i = tid; i < c; i += THREADS) slice[i] = rank * c + i < k ? src[i] : 0ull;
  __syncthreads();
  bitonic_desc(slice, c);
  cluster.sync();  // every slice sorted, at its slots, in its owner
  for (int i = tid; i < p; i += THREADS)  // the other slices, from their owners
    if (i / c != rank) s_keys[i] = *cluster.map_shared_rank(&s_keys[i], i / c);
  cluster.sync();  // no CTA reads another's shared memory from here on
  // each key of this slice goes to its rank in the answer: its index in
  // the slice plus the keys above it in each other slice (a binary search
  // each, 8 lanes to a key; the keys are unique, so no two ranks collide)
  const int real = max(0, min(c, k - rank * c));  // real keys in this slice
  const int part = tid & (CLUSTER - 1);
  for (int i0 = 0; i0 < c; i0 += THREADS / CLUSTER) {
    const int i = i0 + tid / CLUSTER;
    const unsigned long long key = i < real ? slice[i] : 0ull;
    int above = 0;
    if (i < real) {
      if (part == rank) {
        above = i;
      } else {
        const unsigned long long* other = s_keys + part * c;
        int a = 0, b = c;
        while (a < b) {
          const int mid = (a + b) >> 1;
          if (other[mid] > key) a = mid + 1;
          else b = mid;
        }
        above = a;
      }
    }
#pragma unroll
    for (int off = CLUSTER / 2; off > 0; off >>= 1) above += __shfl_xor_sync(FULL, above, off);
    if (i < real && part == 0) {
      const long long pos = base + (n - 1 - (int)(uint32_t)key);
      if constexpr (KIND == VAL_BF16)
        static_cast<uint16_t*>(out_val)[qi * k + above] = static_cast<const uint16_t*>(vals)[pos];
      else
        static_cast<uint32_t*>(out_val)[qi * k + above] = static_cast<const uint32_t*>(vals)[pos];
      out_idx[qi * k + above] = gidx[pos];
    }
  }
}

// What a launch asks of the runtime, asked once per device and value kind.
struct SelectSetup {
  int ready = 0, sms = 0;
  int clusters = 0;  // clusters the card holds at once at SMEM_MAX
};

// a launch of one cluster of CLUSTER CTAs for each of q queries; attr
// holds the cluster dimension the config points to
cudaLaunchConfig_t cluster_config(int q, int smem, cudaStream_t s, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, q, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int KIND>
int select_setup(SelectSetup** out) {
  static SelectSetup cache[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  SelectSetup& su = cache[dev];
  if (!su.ready) {
    auto one = select_topk_kernel<KIND>;
    auto many = select_cluster_kernel<KIND>;
    e = cudaFuncSetAttribute(one, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(many, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&su.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg = cluster_config(1, SMEM_MAX, nullptr, &attr);
      e = cudaOccupancyMaxActiveClusters(&su.clusters, many, &cfg);
    }
    if (e != cudaSuccess) return (int)e;
    su.ready = 1;
  }
  *out = &su;
  return 0;
}

// cluster: 0 one block per query, CLUSTER for a cluster of CLUSTER CTAs per
// query, or -1 to pick by (q, n): a cluster where the queries' clusters
// fit the card's SMs and there are CLUSTER_MIN_N candidates or more
template <int KIND>
int launch(const void* vals, const int* gidx, int q, int n, int k, int largest, void* out_val,
           int* out_idx, unsigned long long* scratch, int cluster, cudaStream_t s) {
  SelectSetup* su = nullptr;
  const int e = select_setup<KIND>(&su);
  if (e != 0) return e;
  if (cluster < 0) cluster = (q * CLUSTER <= su->sms && n >= CLUSTER_MIN_N) ? CLUSTER : 0;
  if (cluster == 0) {
    const int smem = sort_slots(k) * 8 + (words_fit(n, k) ? n * 4 : 0);
    select_topk_kernel<KIND><<<q, THREADS, smem, s>>>(vals, gidx, n, k, largest, out_val,
                                                      out_idx, scratch);
    return (int)cudaGetLastError();
  }
  if (cluster != CLUSTER) return (int)cudaErrorInvalidValue;
  if (su->clusters < 1) return (int)cudaErrorLaunchOutOfResources;  // none fits the card
  const int span = cluster_span(n);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(q, sort_slots(k) * 8 + (words_fit(span, k) ? span * 4 : 0), s, &attr);
  const cudaError_t le = cudaLaunchKernelEx(&cfg, select_cluster_kernel<KIND>, vals, gidx, n, k,
                                            largest, out_val, out_idx, scratch);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

}  // namespace

// The 8-byte keys of device memory ucfp_select_topk needs as its scratch
// for q queries' top k: 0 (no scratch) while k fits the shared-memory sort.
extern "C" long long ucfp_select_scratch(int q, int k) {
  return k > SORT_CAP ? 2LL * q * k : 0;
}

// kind: 0 float32, 1 bfloat16, 2 int32. scratch: ucfp_select_scratch(q, k)
// keys, or null when that is 0. cluster: as launch's (-1 picks the path).

extern "C" int ucfp_select_topk_path(const void* vals, const int* gidx, int kind, int q, int n,
                                     int k, int largest, void* out_val, int* out_idx,
                                     void* scratch, int cluster, void* stream) {
  if (q <= 0 || q > 65535 || n <= 0 || k <= 0 || k > n ||
      (k > SORT_CAP && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  auto* sc = static_cast<unsigned long long*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case VAL_F32:
      return launch<VAL_F32>(vals, gidx, q, n, k, largest, out_val, out_idx, sc, cluster, s);
    case VAL_BF16:
      return launch<VAL_BF16>(vals, gidx, q, n, k, largest, out_val, out_idx, sc, cluster, s);
    case VAL_I32:
      return launch<VAL_I32>(vals, gidx, q, n, k, largest, out_val, out_idx, sc, cluster, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ucfp_select_topk(const void* vals, const int* gidx, int kind, int q, int n, int k,
                                int largest, void* out_val, int* out_idx, void* scratch,
                                void* stream) {
  return ucfp_select_topk_path(vals, gidx, kind, q, n, k, largest, out_val, out_idx, scratch, -1,
                               stream);
}

// The path rule's constants and what the runtime reported for this device:
// info = {CLUSTER, CLUSTER_MIN_N, SMs, clusters the card holds at once at
// the largest shared-memory size}.
extern "C" int ucfp_select_cluster_info(int* info) {
  SelectSetup* su = nullptr;
  const int e = select_setup<VAL_F32>(&su);
  if (e != 0) return e;
  info[0] = CLUSTER;
  info[1] = CLUSTER_MIN_N;
  info[2] = su->sms;
  info[3] = su->clusters;
  return 0;
}
