// Copied from ucfp_tpu/native/imgbatch.cpp; unchanged apart from these
// lines and comments that no longer quote the reference's measurements.
// Native batch-image decode for the high-rate ingest route.
//
// The batch image route (/v1/ingest/image/batch/{tid}, framing
// [u64 rid][u32 len][bytes]*) feeds pre-decoded 24-bit BI_RGB BMPs in
// the common high-rate case (upstream pipelines that already hold raw
// pixels send BMP to skip double compression — see
// ucfp_tpu/modality/image.py:_fast_bmp_rgb). The per-image Python cost
// of that path (frame unpack, header parse, three astype(int32) luma
// temporaries, np.stack regroup) was the largest host cost after the
// earlier decode work. This module does the whole batch in one ctypes call:
//
//   probe(body)  -> frame count + uniform (h, w), or a fallback code
//   fill(body)   -> record ids + BT.601 luma planes [n, h, w] uint8
//
// Fast path ONLY when every frame is a plain 24bpp BI_RGB BMP of the
// SAME dimensions within the preprocess limits; anything else returns
// FALLBACK and the Python path (PIL decode, per-image errors, mixed
// shapes) handles the request exactly as before. Luma is the exact
// integer formula of image.py:decode_gray — (299 r + 587 g + 114 b
// + 500) / 1000 in unsigned math, floor division equal to Python's //
// for non-negative values — so the output is byte-identical (tested in
// tests/test_imgbatch_native.py).
//
// Reference analog: the reference decodes one image per request inside
// the handler (reference src/modality/image.rs:62-88); batching
// is this build's accelerator-first ingest seam (SURVEY.md §7).

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kOk = 0;
constexpr int kFallback = 1;          // valid framing, not fast-path
constexpr int kTruncatedHeader = -1;  // 12-byte frame header cut short
constexpr int kTruncatedBody = -2;    // frame body cut short
constexpr int kTooMany = -3;          // more than max_n frames

struct Bmp {
  uint32_t data_off;  // pixel data offset within the frame
  int32_t w;
  int32_t rows;
  uint32_t stride;
  bool bottom_up;
};

inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint16_t rd16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}

inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

// Mirror of image.py:_fast_bmp_view — plain uncompressed 24bpp only.
bool parse_bmp(const uint8_t* p, size_t len, Bmp* out) {
  if (len < 54 || p[0] != 'B' || p[1] != 'M') return false;
  const uint32_t off = rd32(p + 10);
  const uint32_t hsz = rd32(p + 14);
  if (hsz < 40) return false;  // BITMAPCOREHEADER: PIL handles it
  int32_t w, h;
  std::memcpy(&w, p + 18, 4);
  std::memcpy(&h, p + 22, 4);
  const uint16_t bpp = rd16(p + 28);
  const uint32_t comp = rd32(p + 30);
  if (comp != 0 || bpp != 24 || w <= 0 || h == 0 || h == INT32_MIN)
    return false;
  const int32_t rows = h < 0 ? -h : h;
  const uint64_t stride = (static_cast<uint64_t>(w) * 3 + 3) / 4 * 4;
  if (static_cast<uint64_t>(off) + stride * rows > len) return false;
  out->data_off = off;
  out->w = w;
  out->rows = rows;
  out->stride = static_cast<uint32_t>(stride);
  out->bottom_up = h > 0;
  return true;
}

}  // namespace

extern "C" {

// Scan the frame stream. On kOk, *n_out frames of identical (h, w)
// fast-path BMPs within the limits were found. kFallback means the
// framing is intact but the Python path must decode. Negative codes are
// framing errors the handler maps to the same 400s as the Python parse.
int ucfp_imgbatch_probe(const uint8_t* body, size_t body_len, int max_n,
                        int min_dim, int max_dim, long long max_bytes,
                        int* n_out, int* h_out, int* w_out) {
  size_t off = 0;
  int n = 0;
  int h = -1, w = -1;
  bool fast = true;
  while (off < body_len) {
    if (off + 12 > body_len) return kTruncatedHeader;
    const uint32_t len = rd32(body + off + 8);
    off += 12;
    if (off + len > body_len || len > body_len) return kTruncatedBody;
    if (++n > max_n) return kTooMany;
    if (fast) {
      Bmp b;
      if (static_cast<long long>(len) > max_bytes ||
          !parse_bmp(body + off, len, &b) ||
          (b.w < b.rows ? b.w : b.rows) < min_dim ||
          (b.w > b.rows ? b.w : b.rows) > max_dim ||
          (h >= 0 && (b.rows != h || b.w != w))) {
        fast = false;
      } else {
        h = b.rows;
        w = b.w;
      }
    }
    off += len;
  }
  if (n == 0 || !fast) return kFallback;
  *n_out = n;
  *h_out = h;
  *w_out = w;
  return kOk;
}

// Fill rids[n] and gray[n*h*w] for a body that probed kOk. Returns the
// frame count, or -1 if the body no longer parses (callers pass the
// same buffer back-to-back, so this only guards memory safety).
int ucfp_imgbatch_fill(const uint8_t* body, size_t body_len, uint64_t* rids,
                       uint8_t* gray, int n_cap, int h, int w) {
  size_t off = 0;
  int n = 0;
  while (off < body_len) {
    if (off + 12 > body_len || n >= n_cap) return -1;
    const uint64_t rid = rd64(body + off);
    const uint32_t len = rd32(body + off + 8);
    off += 12;
    if (off + len > body_len || len > body_len) return -1;
    Bmp b;
    if (!parse_bmp(body + off, len, &b) || b.rows != h || b.w != w) return -1;
    rids[n] = rid;
    const uint8_t* base = body + off + b.data_off;
    uint8_t* dst_img = gray + static_cast<size_t>(n) * h * w;
    for (int y = 0; y < h; ++y) {
      // decode_gray computes luma in stored order then flips bottom-up
      // rows: output row y reads stored row (h-1-y) for bottom-up files.
      const uint8_t* src =
          base + static_cast<size_t>(b.bottom_up ? h - 1 - y : y) * b.stride;
      uint8_t* dst = dst_img + static_cast<size_t>(y) * w;
      for (int x = 0; x < w; ++x) {
        const uint8_t* px = src + x * 3;  // stored B, G, R
        dst[x] = static_cast<uint8_t>(
            (299u * px[2] + 587u * px[1] + 114u * px[0] + 500u) / 1000u);
      }
    }
    ++n;
    off += len;
  }
  return n;
}

// Fixed-point separable tent resize over a batch of luma planes —
// the exact integer mirror of ops/imagehash.py np_resize/resize_exact:
// two matmul stages against the Q15 weight matrices (built by Python's
// resize_matrix_q and passed in), each stage rounding (acc + 16384)
// >> 15. Row sums are exactly 2^15 and pixels <= 255, so every
// accumulator stays below 255 * 2^15 < 2^31 — int32-safe, and the
// result is byte-identical to the device resize (the single-hash
// kernels then apply an identity resize; tested in
// tests/test_imgbatch_native.py). Shipping the resized plane instead
// of the full luma cuts host->device ingest bytes 4x at 64x64 inputs
// (more at camera sizes).
//
// Weight rows are tent filters: only a short contiguous span is
// non-zero (<= 2*radius + 2 taps), so each stage walks a precomputed
// [lo, hi) span instead of the full row.
extern "C" int ucfp_imgbatch_resize(const uint8_t* gray, int n, int in_h,
                                    int in_w, const int32_t* wh, int oh,
                                    const int32_t* ww, int ow,
                                    uint8_t* out) {
  if (n <= 0 || in_h <= 0 || in_w <= 0 || oh <= 0 || ow <= 0) return -1;
  // per-output-row non-zero spans of both weight matrices
  int* spans = new int[2 * (oh + ow)];
  int* wh_lo = spans;
  int* wh_hi = spans + oh;
  int* ww_lo = spans + 2 * oh;
  int* ww_hi = spans + 2 * oh + ow;
  for (int o = 0; o < oh; ++o) {
    int lo = 0, hi = in_h;
    const int32_t* row = wh + static_cast<size_t>(o) * in_h;
    while (lo < hi && row[lo] == 0) ++lo;
    while (hi > lo && row[hi - 1] == 0) --hi;
    wh_lo[o] = lo;
    wh_hi[o] = hi;
  }
  for (int p = 0; p < ow; ++p) {
    int lo = 0, hi = in_w;
    const int32_t* row = ww + static_cast<size_t>(p) * in_w;
    while (lo < hi && row[lo] == 0) ++lo;
    while (hi > lo && row[hi - 1] == 0) --hi;
    ww_lo[p] = lo;
    ww_hi[p] = hi;
  }
  int32_t* t = new int32_t[static_cast<size_t>(oh) * in_w];
  for (int i = 0; i < n; ++i) {
    const uint8_t* img = gray + static_cast<size_t>(i) * in_h * in_w;
    // stage 1: rows — t[o][w] = ((sum_h wh[o][h] * g[h][w]) + R) >> 15
    for (int o = 0; o < oh; ++o) {
      const int32_t* wrow = wh + static_cast<size_t>(o) * in_h;
      int32_t* trow = t + static_cast<size_t>(o) * in_w;
      for (int w = 0; w < in_w; ++w) trow[w] = 16384;
      for (int h = wh_lo[o]; h < wh_hi[o]; ++h) {
        const int32_t wv = wrow[h];
        if (wv == 0) continue;
        const uint8_t* grow = img + static_cast<size_t>(h) * in_w;
        for (int w = 0; w < in_w; ++w)
          trow[w] += wv * static_cast<int32_t>(grow[w]);
      }
      for (int w = 0; w < in_w; ++w) trow[w] >>= 15;
    }
    // stage 2: cols — out[o][p] = ((sum_w t[o][w] * ww[p][w]) + R) >> 15
    uint8_t* dst = out + static_cast<size_t>(i) * oh * ow;
    for (int o = 0; o < oh; ++o) {
      const int32_t* trow = t + static_cast<size_t>(o) * in_w;
      for (int p = 0; p < ow; ++p) {
        const int32_t* wrow = ww + static_cast<size_t>(p) * in_w;
        int32_t acc = 16384;
        for (int w = ww_lo[p]; w < ww_hi[p]; ++w) acc += trow[w] * wrow[w];
        dst[static_cast<size_t>(o) * ow + p] =
            static_cast<uint8_t>(acc >> 15);
      }
    }
  }
  delete[] t;
  delete[] spans;
  return 0;
}

}  // extern "C"
