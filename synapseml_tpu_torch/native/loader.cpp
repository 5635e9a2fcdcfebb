// Native CSV parser: the host C++ of the PyTorch port's ingest path.
//
// A copy of the JAX package's ``native/loader.cpp`` (its CSV part): a
// mmap'd CSV is split at row boundaries into per-thread chunks, each
// thread parses straight into a preallocated column-major float32 block
// (one contiguous run per column), entirely outside the GIL.  Host code,
// not a device kernel.  Built by ``g++`` at first use
// (``synapseml_tpu_torch/native/__init__.py``) and bound over ctypes
// through a plain C ABI.

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct MappedFile {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;

  bool open(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size == 0) {
      ::close(fd);
      fd = -1;
      return false;
    }
    size = static_cast<size_t>(st.st_size);
    void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) {
      ::close(fd);
      fd = -1;
      return false;
    }
    data = static_cast<const char*>(p);
    return true;
  }

  ~MappedFile() {
    if (data) munmap(const_cast<char*>(data), size);
    if (fd >= 0) ::close(fd);
  }
};

// fast float parse: common fixed/scientific notation, NaN on failure
inline float parse_field(const char* s, const char* end) {
  while (s < end && (*s == ' ' || *s == '\t')) ++s;
  while (end > s && (end[-1] == ' ' || end[-1] == '\t' || end[-1] == '\r'))
    --end;
  if (s == end) return NAN;
  char buf[64];
  size_t len = static_cast<size_t>(end - s);
  if (len >= sizeof(buf)) return NAN;
  memcpy(buf, s, len);
  buf[len] = '\0';
  char* parse_end = nullptr;
  float v = strtof(buf, &parse_end);
  if (parse_end == buf) return NAN;
  return v;
}

inline size_t count_cols(const char* line, const char* end, char delim) {
  size_t n = 1;
  for (const char* p = line; p < end && *p != '\n'; ++p)
    if (*p == delim) ++n;
  return n;
}

const char* line_end(const char* p, const char* end) {
  const char* nl = static_cast<const char*>(
      memchr(p, '\n', static_cast<size_t>(end - p)));
  return nl ? nl : end;
}

}  // namespace

extern "C" {

// Probe dimensions: rows (excluding header when has_header), cols.
// Returns 0 on success.
int sml_csv_dims(const char* path, int has_header, char delim,
                 int64_t* out_rows, int64_t* out_cols) {
  MappedFile f;
  if (!f.open(path)) return -1;
  const char* p = f.data;
  const char* end = f.data + f.size;
  *out_cols = static_cast<int64_t>(count_cols(p, line_end(p, end), delim));
  int64_t lines = 0;
  while (p < end) {
    const char* nl = line_end(p, end);
    if (nl > p) ++lines;  // skip empty lines
    p = nl + 1;
  }
  *out_rows = lines - (has_header ? 1 : 0);
  return *out_rows >= 0 ? 0 : -2;
}

// Parse into column-major out[col * rows + row] (one contiguous block per
// column — the layout Dataset columns want).  Returns 0 on success.
int sml_csv_read_f32(const char* path, int has_header, char delim,
                     int64_t rows, int64_t cols, float* out, int n_threads) {
  MappedFile f;
  if (!f.open(path)) return -1;
  const char* begin = f.data;
  const char* end = f.data + f.size;
  if (has_header) begin = line_end(begin, end) + 1;
  if (begin >= end) return rows == 0 ? 0 : -2;

  if (n_threads <= 0) {
    unsigned hw = std::thread::hardware_concurrency();
    n_threads = hw ? static_cast<int>(hw) : 4;
  }
  if (n_threads > rows && rows > 0) n_threads = static_cast<int>(rows);

  // split [begin, end) into n_threads chunks aligned to line starts, and
  // pre-count rows per chunk so each thread knows its output offset
  std::vector<const char*> starts;
  std::vector<int64_t> row_offsets;
  size_t span = static_cast<size_t>(end - begin);
  starts.push_back(begin);
  for (int t = 1; t < n_threads; ++t) {
    const char* guess = begin + span * static_cast<size_t>(t) /
                                    static_cast<size_t>(n_threads);
    if (guess >= end) break;
    const char* aligned = line_end(guess, end) + 1;
    if (aligned < end && aligned > starts.back()) starts.push_back(aligned);
  }
  starts.push_back(end);
  row_offsets.assign(starts.size(), 0);
  std::vector<std::thread> counters;
  for (size_t t = 0; t + 1 < starts.size(); ++t) {
    counters.emplace_back([&, t] {
      int64_t n = 0;
      for (const char* p = starts[t]; p < starts[t + 1];) {
        const char* nl = line_end(p, starts[t + 1]);
        if (nl > p) ++n;
        p = nl + 1;
      }
      row_offsets[t + 1] = n;
    });
  }
  for (auto& th : counters) th.join();
  int64_t total = 0;
  for (size_t t = 1; t < row_offsets.size(); ++t) {
    int64_t n = row_offsets[t];
    row_offsets[t] = total + n;
    row_offsets[t - 1] = total;
    total += n;
  }
  if (!row_offsets.empty()) row_offsets.back() = total;
  if (total != rows) return -3;

  std::atomic<int> bad_cols{0};
  std::vector<std::thread> workers;
  for (size_t t = 0; t + 1 < starts.size(); ++t) {
    workers.emplace_back([&, t] {
      int64_t row = row_offsets[t];
      for (const char* p = starts[t]; p < starts[t + 1];) {
        const char* nl = line_end(p, starts[t + 1]);
        if (nl > p) {
          const char* field = p;
          int64_t c = 0;
          for (const char* q = p; q <= nl && c < cols; ++q) {
            if (q == nl || *q == delim) {
              out[c * rows + row] = parse_field(field, q);
              field = q + 1;
              ++c;
            }
          }
          if (c != cols) bad_cols.fetch_add(1, std::memory_order_relaxed);
          for (; c < cols; ++c) out[c * rows + row] = NAN;
          ++row;
        }
        p = nl + 1;
      }
    });
  }
  for (auto& th : workers) th.join();
  return bad_cols.load() ? 1 : 0;  // 1 = ragged rows NaN-padded
}

}  // extern "C"
