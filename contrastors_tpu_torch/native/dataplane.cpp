// Native data-plane for the streaming shard loader.
//
// The reference feeds GPUs from a single-threaded Python gzip/json loader
// (reference: dataset/text_text_loader.py, num_workers=0 at
// trainers/text_text.py:216 — a known bottleneck, SURVEY.md §7 hard part 7).
// This C++ module keeps the hosts fed (a copy of the JAX package's
// contrastors_tpu/native/dataplane.cpp, built by the port's own bindings):
//   * dp_index_file: one-pass streaming inflate recording newline offsets in
//     the DECOMPRESSED stream (the counts/offsets index format);
//   * dp_open / dp_read_range: persistent inflate states with forward
//     skipping, so sequential rank-batch reads never re-inflate from zero;
//   * dp_index_many: thread-parallel indexing across shards.
//
// Exposed via a C ABI consumed from Python with ctypes (no pybind11 in the
// image). Build: g++ -O3 -shared -fPIC dataplane.cpp -lz -lpthread.

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr size_t kInChunk = 1 << 20;   // 1 MiB compressed read
constexpr size_t kOutChunk = 1 << 20;  // 1 MiB inflate window

struct Stream {
  FILE* file = nullptr;
  z_stream zs{};
  uint64_t out_pos = 0;  // decompressed bytes consumed so far
  std::vector<unsigned char> in_buf;
  bool eof = false;
  bool err = false;  // inflate/IO error: callers must fail, not truncate

  ~Stream() {
    if (file) fclose(file);
    inflateEnd(&zs);
  }
};

bool stream_open(Stream* s, const char* path) {
  s->file = fopen(path, "rb");
  if (!s->file) return false;
  s->in_buf.resize(kInChunk);
  std::memset(&s->zs, 0, sizeof(s->zs));
  // 15+16: gzip wrapper
  if (inflateInit2(&s->zs, 15 + 16) != Z_OK) return false;
  s->out_pos = 0;
  s->eof = false;
  return true;
}

// Inflate exactly `len` bytes into out (or skip if out == nullptr).
// Returns bytes produced.
uint64_t stream_pump(Stream* s, unsigned char* out, uint64_t len) {
  uint64_t produced = 0;
  std::vector<unsigned char> skip_buf;
  while (produced < len && !s->eof) {
    if (s->zs.avail_in == 0) {
      size_t got = fread(s->in_buf.data(), 1, kInChunk, s->file);
      if (got == 0) {
        if (ferror(s->file)) s->err = true;
        break;
      }
      s->zs.next_in = s->in_buf.data();
      s->zs.avail_in = static_cast<uInt>(got);
    }
    uint64_t want = len - produced;
    if (out == nullptr && skip_buf.size() < kOutChunk) skip_buf.resize(kOutChunk);
    unsigned char* dst = out ? out + produced : skip_buf.data();
    uInt avail = static_cast<uInt>(std::min<uint64_t>(want, kOutChunk));
    s->zs.next_out = dst;
    s->zs.avail_out = avail;
    int rc = inflate(&s->zs, Z_NO_FLUSH);
    produced += avail - s->zs.avail_out;
    if (rc == Z_STREAM_END) {
      // support multi-member gzip files
      if (inflateReset(&s->zs) != Z_OK) {
        s->err = true;
        s->eof = true;
        break;
      }
      if (s->zs.avail_in == 0 && feof(s->file)) s->eof = true;
    } else if (rc != Z_OK && rc != Z_BUF_ERROR) {
      s->err = true;  // Z_DATA_ERROR etc: corrupt shard, not a clean end
      s->eof = true;
      break;
    }
  }
  s->out_pos += produced;
  return produced;
}

}  // namespace

extern "C" {

// ---- whole-file newline indexing -----------------------------------------

// Returns row count; *offsets_out (malloc'd, 2*n int64: start,end pairs)
// must be freed with dp_free. Returns -1 on error.
int64_t dp_index_file(const char* path, int64_t** offsets_out) {
  Stream s;
  if (!stream_open(&s, path)) return -1;
  std::vector<int64_t> offsets;  // start,end pairs
  std::vector<unsigned char> buf(kOutChunk);
  uint64_t pos = 0;
  uint64_t line_start = 0;
  while (true) {
    uint64_t got = stream_pump(&s, buf.data(), kOutChunk);
    if (got == 0) break;
    for (uint64_t i = 0; i < got; ++i) {
      if (buf[i] == '\n') {
        offsets.push_back(static_cast<int64_t>(line_start));
        offsets.push_back(static_cast<int64_t>(pos + i + 1));
        line_start = pos + i + 1;
      }
    }
    pos += got;
  }
  if (s.err) return -1;  // corrupt mid-file: a partial index would
                           // silently undercount rows in counts.json
  if (line_start < pos) {  // trailing line without newline
    offsets.push_back(static_cast<int64_t>(line_start));
    offsets.push_back(static_cast<int64_t>(pos));
  }
  int64_t n = static_cast<int64_t>(offsets.size() / 2);
  auto* arr = static_cast<int64_t*>(malloc(offsets.size() * sizeof(int64_t)));
  if (!arr) return -1;
  std::memcpy(arr, offsets.data(), offsets.size() * sizeof(int64_t));
  *offsets_out = arr;
  return n;
}

void dp_free(void* p) { free(p); }

// ---- thread-parallel indexing across shards -------------------------------

// paths: array of C strings; results[i] -> offsets ptr; counts[i] -> rows.
void dp_index_many(const char** paths, int64_t n_paths, int64_t n_threads,
                   int64_t** results, int64_t* counts) {
  std::vector<std::thread> workers;
  std::mutex mu;
  int64_t next = 0;
  auto work = [&]() {
    while (true) {
      int64_t i;
      {
        std::lock_guard<std::mutex> lock(mu);
        if (next >= n_paths) return;
        i = next++;
      }
      counts[i] = dp_index_file(paths[i], &results[i]);
    }
  };
  int64_t t = std::max<int64_t>(1, std::min<int64_t>(n_threads, n_paths));
  for (int64_t i = 0; i < t; ++i) workers.emplace_back(work);
  for (auto& w : workers) w.join();
}

// ---- persistent streams with forward seek ---------------------------------

void* dp_open(const char* path) {
  auto* s = new Stream();
  if (!stream_open(s, path)) {
    delete s;
    return nullptr;
  }
  return s;
}

void dp_close(void* handle) { delete static_cast<Stream*>(handle); }

int64_t dp_tell(void* handle) {
  return static_cast<int64_t>(static_cast<Stream*>(handle)->out_pos);
}

// Read [start, start+len) of the decompressed stream into buf.
// Requires start >= current position (forward-only; reopen to rewind).
// Returns bytes read or -1.
int64_t dp_read_range(void* handle, int64_t start, int64_t len, char* buf) {
  auto* s = static_cast<Stream*>(handle);
  if (static_cast<uint64_t>(start) < s->out_pos) return -1;
  uint64_t skip = static_cast<uint64_t>(start) - s->out_pos;
  while (skip > 0) {
    uint64_t got = stream_pump(s, nullptr, std::min<uint64_t>(skip, kOutChunk));
    if (got == 0) return -1;
    skip -= got;
  }
  int64_t got = static_cast<int64_t>(
      stream_pump(s, reinterpret_cast<unsigned char*>(buf), static_cast<uint64_t>(len)));
  if (s->err) return -1;
  return got;
}

}  // extern "C"
