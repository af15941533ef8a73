// Copied from ucfp_tpu/native/walstore.cpp; unchanged apart from this line
// and two comments that no longer quote the reference's measurements.
// Native write-ahead log: CRC32-framed binary records, fsync'd batches,
// torn-tail-tolerant replay.
//
// The host-side durability engine standing where the reference uses the
// native redb crate (reference: src/index/embedded/mod.rs:37-88 — single
// file, one fsync per committed transaction, crash-consistent). Scope is
// a Bitcask-style log rather than a COW B-tree because the backend keeps
// its tables in memory and rebuilds on boot; the log only needs ordered,
// checksummed, durable frames.
//
// Frame layout (little-endian):
//   u32 magic 0x55434650 ("UCFP") | u32 len | u32 crc32(payload) | payload
//
// Replay stops at the first bad magic/len/crc — a torn tail from a crash
// is dropped, matching the JSON WAL fallback's last-complete-line rule.
//
// C ABI for ctypes; every function returns 0 on success, negative errno
// style on failure.

#include <array>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>

#include <fcntl.h>
#include <unistd.h>
#include <sys/stat.h>

namespace {

constexpr uint32_t kMagic = 0x55434650;  // "UCFP"

// C++11 magic static: thread-safe one-time init (ctypes releases the
// GIL around calls, so two stores' first appends can race a hand-rolled
// init flag and CRC frames with a half-built table)
const uint32_t* crc_table() {
  static const auto table = [] {
    std::array<uint32_t, 256> t{};
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int j = 0; j < 8; j++)
        c = (c & 1) ? (0xEDB88320u ^ (c >> 1)) : (c >> 1);
      t[i] = c;
    }
    return t;
  }();
  return table.data();
}

uint32_t crc32(const uint8_t* data, size_t len) {
  const uint32_t* tbl = crc_table();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; i++) c = tbl[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Store {
  int fd = -1;
  std::string path;
  std::vector<uint8_t> pending;  // buffered frames awaiting commit
  bool failed = false;  // sticky after fsync failure: data may be lost
};

// Byte offset of the last frame boundary that parses cleanly — the
// truncation point for torn tails.
off_t last_good_offset(int fd) {
  off_t good = 0;
  off_t pos = 0;
  std::vector<uint8_t> buf;
  for (;;) {
    uint32_t header[3];
    ssize_t n = ::pread(fd, header, sizeof(header), pos);
    if (n != (ssize_t)sizeof(header)) break;
    if (header[0] != kMagic) break;
    uint32_t len = header[1];
    if (len > (1u << 30)) break;
    buf.resize(len);
    if (::pread(fd, buf.data(), len, pos + sizeof(header)) != (ssize_t)len)
      break;
    if (crc32(buf.data(), len) != header[2]) break;
    pos += sizeof(header) + len;
    good = pos;
  }
  return good;
}

}  // namespace

extern "C" {

// Open (create if missing) the log at `path`. Returns handle or null.
void* ucfp_wal_open(const char* path) {
  Store* s = new Store();
  s->path = path;
  s->fd = ::open(path, O_RDWR | O_CREAT | O_APPEND, 0644);
  if (s->fd < 0) {
    delete s;
    return nullptr;
  }
  // truncate any crash-torn tail NOW: with O_APPEND, frames written
  // after garbage bytes would be permanently invisible to replay
  // (replay stops at the first bad frame)
  struct stat st{};
  if (::fstat(s->fd, &st) == 0 && st.st_size > 0) {
    off_t good = last_good_offset(s->fd);
    if (good < st.st_size) {
      if (::ftruncate(s->fd, good) != 0) {
        ::close(s->fd);
        delete s;
        return nullptr;
      }
      ::fsync(s->fd);
    }
  }
  return s;
}

// Buffer one frame; durable only after ucfp_wal_commit.
int ucfp_wal_append(void* h, const uint8_t* data, uint32_t len) {
  Store* s = static_cast<Store*>(h);
  if (!s || s->fd < 0) return -1;
  uint32_t header[3] = {kMagic, len, crc32(data, len)};
  const uint8_t* hb = reinterpret_cast<const uint8_t*>(header);
  s->pending.insert(s->pending.end(), hb, hb + sizeof(header));
  s->pending.insert(s->pending.end(), data, data + len);
  return 0;
}

// Buffer `count` frames from one concatenated payload buffer (frame i
// spans lens[i] bytes). Byte-identical to `count` ucfp_wal_append
// calls — this exists so the group-commit writer pays ONE ctypes
// crossing per round instead of one per record.
int ucfp_wal_append_many(void* h, const uint8_t* data,
                         const uint32_t* lens, uint32_t count) {
  Store* s = static_cast<Store*>(h);
  if (!s || s->fd < 0) return -1;
  size_t total = 0;
  for (uint32_t i = 0; i < count; i++) total += 12u + (size_t)lens[i];
  s->pending.reserve(s->pending.size() + total);
  const uint8_t* p = data;
  for (uint32_t i = 0; i < count; i++) {
    uint32_t header[3] = {kMagic, lens[i], crc32(p, lens[i])};
    const uint8_t* hb = reinterpret_cast<const uint8_t*>(header);
    s->pending.insert(s->pending.end(), hb, hb + sizeof(header));
    s->pending.insert(s->pending.end(), p, p + lens[i]);
    p += lens[i];
  }
  return 0;
}

// Buffer `count` frames of ONE fixed length from a concatenated
// payload (frame i spans [i*frame_len, (i+1)*frame_len)). Byte-identical
// to `count` ucfp_wal_append calls — the compaction path emits uniform
// run frames and this skips both the per-frame Python slicing and the
// lens array.
int ucfp_wal_append_fixed(void* h, const uint8_t* data, uint32_t frame_len,
                          uint64_t count) {
  Store* s = static_cast<Store*>(h);
  if (!s || s->fd < 0) return -1;
  s->pending.reserve(s->pending.size() + count * (12u + (size_t)frame_len));
  const uint8_t* p = data;
  for (uint64_t i = 0; i < count; i++) {
    uint32_t header[3] = {kMagic, frame_len, crc32(p, frame_len)};
    const uint8_t* hb = reinterpret_cast<const uint8_t*>(header);
    s->pending.insert(s->pending.end(), hb, hb + sizeof(header));
    s->pending.insert(s->pending.end(), p, p + frame_len);
    p += frame_len;
  }
  return 0;
}

// Write buffered frames and fsync — one durability point per batch,
// matching the reference's one-commit-per-txn.
int ucfp_wal_commit(void* h) {
  Store* s = static_cast<Store*>(h);
  if (!s || s->fd < 0) return -1;
  if (s->failed) return -5;  // fsync once failed: durability unknowable
  if (s->pending.empty()) return 0;
  off_t start = ::lseek(s->fd, 0, SEEK_END);
  size_t off = 0;
  while (off < s->pending.size()) {
    ssize_t n = ::write(s->fd, s->pending.data() + off, s->pending.size() - off);
    if (n < 0) {
      // roll the file back to the pre-commit boundary and KEEP pending:
      // a retry then rewrites the whole batch cleanly instead of
      // appending it after a torn prefix. If the rollback itself fails
      // the file may hold a torn prefix — poison the store so a retried
      // commit cannot append after it and report success.
      if (start < 0 || ::ftruncate(s->fd, start) != 0) s->failed = true;
      return -2;
    }
    off += static_cast<size_t>(n);
  }
  if (::fsync(s->fd) != 0) {
    // after a failed fsync the kernel may mark dirty pages clean, so
    // the written bytes must be considered lost — poison the store so
    // every later commit fails loudly instead of "succeeding" without
    // durability (pending is cleared ONLY after a successful fsync)
    s->failed = true;
    return -3;
  }
  s->pending.clear();
  return 0;
}

// Replay all complete frames through `cb(ctx, data, len)`; returns the
// number of frames delivered, or negative on I/O error. Stops silently
// at a torn tail.
typedef void (*ucfp_wal_cb)(void* ctx, const uint8_t* data, uint32_t len);

long ucfp_wal_replay(const char* path, ucfp_wal_cb cb, void* ctx) {
  FILE* f = ::fopen(path, "rb");
  if (!f) return 0;  // no log yet: nothing to replay
  long count = 0;
  std::vector<uint8_t> buf;
  for (;;) {
    uint32_t header[3];
    if (::fread(header, 1, sizeof(header), f) != sizeof(header)) break;
    if (header[0] != kMagic) break;
    uint32_t len = header[1];
    if (len > (1u << 30)) break;
    buf.resize(len);
    if (::fread(buf.data(), 1, len, f) != len) break;
    if (crc32(buf.data(), len) != header[2]) break;
    cb(ctx, buf.data(), len);
    count++;
  }
  ::fclose(f);
  return count;
}

// Bulk replay: parse and CRC-validate every complete frame, returning
// ONE malloc'd buffer of the concatenated payloads plus (count+1) u64
// offsets into it (frame i spans [offs[i], offs[i+1])). Semantically
// identical to ucfp_wal_replay (same torn-tail rule) — this exists so
// restart-scale replay crosses the C ABI once instead of once per
// record (the per-frame ctypes callback + string_at dominated the
// per-record replay cost). The caller owns
// both buffers and must release each with ucfp_wal_buf_free. Returns
// the frame count, 0 for a missing/empty log, or -12 on allocation
// failure (outputs are null).
long ucfp_wal_replay_concat(const char* path, uint8_t** data_out,
                            uint64_t** offs_out) {
  *data_out = nullptr;
  *offs_out = nullptr;
  FILE* f = ::fopen(path, "rb");
  if (!f) return 0;
  std::vector<uint8_t> data;
  std::vector<uint64_t> offs;
  offs.push_back(0);
  for (;;) {
    uint32_t header[3];
    if (::fread(header, 1, sizeof(header), f) != sizeof(header)) break;
    if (header[0] != kMagic) break;
    uint32_t len = header[1];
    if (len > (1u << 30)) break;
    size_t base = data.size();
    data.resize(base + len);
    if (::fread(data.data() + base, 1, len, f) != len) {
      data.resize(base);
      break;
    }
    if (crc32(data.data() + base, len) != header[2]) {
      data.resize(base);
      break;
    }
    offs.push_back(data.size());
  }
  ::fclose(f);
  long count = (long)offs.size() - 1;
  uint8_t* db = (uint8_t*)std::malloc(data.empty() ? 1 : data.size());
  uint64_t* ob = (uint64_t*)std::malloc(offs.size() * sizeof(uint64_t));
  if (!db || !ob) {
    std::free(db);
    std::free(ob);
    return -12;
  }
  if (!data.empty()) std::memcpy(db, data.data(), data.size());
  std::memcpy(ob, offs.data(), offs.size() * sizeof(uint64_t));
  *data_out = db;
  *offs_out = ob;
  return count;
}

void ucfp_wal_buf_free(void* p) { std::free(p); }

// Atomically replace the log with the frames buffered since open — used
// by compaction: open a fresh store at path.tmp, append the snapshot,
// then rename over the old log.
int ucfp_wal_replace(void* h, const char* final_path) {
  Store* s = static_cast<Store*>(h);
  if (!s || s->fd < 0) return -1;
  int rc = ucfp_wal_commit(h);
  if (rc != 0) return rc;
  if (::rename(s->path.c_str(), final_path) != 0) return -4;
  // fsync the containing directory so the rename itself is durable
  std::string dir(final_path);
  size_t slash = dir.find_last_of('/');
  dir = (slash == std::string::npos) ? std::string(".") : dir.substr(0, slash);
  int dfd = ::open(dir.c_str(), O_RDONLY | O_DIRECTORY);
  if (dfd >= 0) {
    ::fsync(dfd);
    ::close(dfd);
  }
  s->path = final_path;
  return 0;
}

int ucfp_wal_close(void* h) {
  Store* s = static_cast<Store*>(h);
  if (!s) return -1;
  if (s->fd >= 0) {
    ucfp_wal_commit(h);
    ::close(s->fd);
  }
  delete s;
  return 0;
}

}  // extern "C"
