// The asymmetric sketch scan of the UCFP_KNN_QUANT=sketch tier.
//
// ucfp_sketch_scan replaces the Pallas kernel of
// ucfp_tpu/ops/knn.py:asym_sketch_scores_tiled (_asym_scan_kernel) and the
// final const - 2 * wsum step that sits outside it. The sketch keeps the
// reference's lane-tiled layout, [C/128, 24, 128] int32: row g*128 + lane's
// word w at [g, w, lane]. For one query plan (qsign [24], masks [4, 24],
// level weights w[4] and plane counts n[4]):
//
//   d_l   = sum_w __popc((sketch[w] ^ qsign[w]) & masks[l][w])
//   wsum  = fma(w3, d3, fma(w2, d2, fma(w0, d0, w1 * d1)))
//   const = fma(w3, n3, fma(w2, n2, fma(w1, n1, w0 * n0)))   (sum(w * n))
//   out   = const - 2 * wsum
//
// The fused multiply-adds are the ones XLA's CPU backend emits for the
// reference's level sum (ops/sketch_scan.py); they are written with
// __fmaf_rn / __fmul_rn / __fsub_rn so that nvcc's own contraction cannot
// change them, and the outputs equal the plain version bit for bit.
//
// Bound: device memory, only just. The function must read the sketch once
// (96 bytes per row) and write one float (4 bytes): at C = 2^22, 0.42 GB,
// 0.125 ms at 3.35 TB/s. Its 96 popcounts per row (4.0e8 at 2^22) take
// about 0.096 ms at 16 per clock per SM on 132 SMs at 1,980 MHz.
//
// Design. One thread per row, one 128-thread block per 128-row group:
// thread `lane` reads word w at [g, w, lane], so a warp's 24 loads are
// each 128 contiguous bytes. The plan sits in shared memory (broadcast
// reads); each word costs one XOR, four AND and four __popc. The plan's
// four tensors are read where they lie, so a launch needs no host work
// beyond the call.
//
// Plain C interface (loaded with ctypes): launches on the caller's
// stream, allocates nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;  // sketch_scan.LANES
constexpr int WORDS = 24;   // sketch_scan.WORDS
constexpr int LEVELS = 4;   // sketch_scan.LEVELS

__global__ void __launch_bounds__(LANES)
sketch_kernel(const uint32_t* __restrict__ tiled, const uint32_t* __restrict__ qsign,
              const uint32_t* __restrict__ masks, const float* __restrict__ wts,
              const float* __restrict__ cnt, float* __restrict__ out) {
  __shared__ uint32_t s_plan[WORDS * (1 + LEVELS)];  // qsign, then masks [L, W]
  for (int i = threadIdx.x; i < WORDS * (1 + LEVELS); i += LANES)
    s_plan[i] = i < WORDS ? qsign[i] : masks[i - WORDS];
  __syncthreads();
  const uint32_t* p = tiled + (long long)blockIdx.x * WORDS * LANES + threadIdx.x;
  int d[LEVELS] = {0, 0, 0, 0};
#pragma unroll
  for (int w = 0; w < WORDS; ++w) {
    const uint32_t x = __ldg(p + w * LANES) ^ s_plan[w];
#pragma unroll
    for (int l = 0; l < LEVELS; ++l) d[l] += __popc(x & s_plan[WORDS * (1 + l) + w]);
  }
  const float w0 = wts[0], w1 = wts[1], w2 = wts[2], w3 = wts[3];
  float wsum = __fmaf_rn(w0, (float)d[0], __fmul_rn(w1, (float)d[1]));
  wsum = __fmaf_rn(w3, (float)d[3], __fmaf_rn(w2, (float)d[2], wsum));
  float konst = __fmaf_rn(w1, cnt[1], __fmul_rn(w0, cnt[0]));
  konst = __fmaf_rn(w3, cnt[3], __fmaf_rn(w2, cnt[2], konst));
  out[(long long)blockIdx.x * LANES + threadIdx.x] = __fsub_rn(konst, __fmul_rn(2.0f, wsum));
}

}  // namespace

extern "C" int ucfp_sketch_scan(const void* tiled, long long groups, const void* qsign,
                                const void* masks, const float* wts, const float* cnt,
                                float* out, void* stream) {
  if (groups <= 0 || groups > 0x7fffffffLL || qsign == nullptr || masks == nullptr ||
      wts == nullptr || cnt == nullptr)
    return (int)cudaErrorInvalidValue;
  sketch_kernel<<<(unsigned)groups, LANES, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tiled), static_cast<const uint32_t*>(qsign),
      static_cast<const uint32_t*>(masks), wts, cnt, out);
  return (int)cudaGetLastError();
}
