// wstio: native shard I/O for the activation feature cache.
//
// The reference framework has no native runtime at all (SURVEY §2.9) and
// torch.load()s whole layers into RAM (feature_cache.py:130).  At full
// scale one whisper-tiny encoder layer is ~230 GB f32 — training must
// stream batches from disk.  This library memory-maps the .npy shards of
// a cached layer and assembles shuffled mini-batches with a row-gather
// that runs outside the Python GIL (ctypes releases it), so a Python
// prefetch thread overlaps batch assembly with device steps.
//
// Built at first use by runtime/shard_reader.py with the host C++ compiler
// (-O3 -shared -fPIC) into build/libwstio_<hash>.so.
// Python binding: runtime/shard_reader.py (ctypes, with a numpy memmap
// fallback where no compiler is found).

#include <cstdint>
#include <cstring>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Shard {
  char* base = nullptr;     // mmap base
  size_t map_size = 0;      // total mapped bytes
  const char* data = nullptr;  // first row (past the npy header)
  int64_t rows = 0;
};

struct Reader {
  std::vector<Shard> shards;
  std::vector<int64_t> cum;  // cumulative row counts, cum[0] = 0
  int64_t row_bytes = 0;
  int64_t total_rows = 0;
};

// Unmap every mapped shard and free the Reader (shared by wstio_close and
// the partial-open failure paths, which previously leaked the mappings of
// already-opened shards for the process lifetime).
void destroy_reader(Reader* r) {
  for (auto& s : r->shards) {
    if (s.base && s.base != MAP_FAILED) {
      munmap(s.base, s.map_size);
    }
  }
  delete r;
}

}  // namespace

extern "C" {

// Open a set of shards.  data_offsets[i] is the byte offset of the first
// row in shard i (the .npy header size, parsed by the Python side);
// rows[i] is the row count of shard i.
void* wstio_open(const char** paths, int n_shards, const int64_t* data_offsets,
                 const int64_t* rows, int64_t row_bytes) {
  Reader* r = new Reader();
  r->row_bytes = row_bytes;
  r->cum.push_back(0);
  for (int i = 0; i < n_shards; ++i) {
    int fd = ::open(paths[i], O_RDONLY);
    if (fd < 0) {
      destroy_reader(r);
      return nullptr;
    }
    struct stat st;
    if (fstat(fd, &st) != 0) {
      ::close(fd);
      destroy_reader(r);
      return nullptr;
    }
    Shard s;
    s.map_size = static_cast<size_t>(st.st_size);
    s.base = static_cast<char*>(
        mmap(nullptr, s.map_size, PROT_READ, MAP_PRIVATE, fd, 0));
    ::close(fd);
    if (s.base == MAP_FAILED) {
      destroy_reader(r);
      return nullptr;
    }
    madvise(s.base, s.map_size, MADV_WILLNEED);
    s.data = s.base + data_offsets[i];
    s.rows = rows[i];
    r->total_rows += s.rows;
    r->cum.push_back(r->total_rows);
    r->shards.push_back(s);
  }
  return r;
}

int64_t wstio_total_rows(void* handle) {
  return static_cast<Reader*>(handle)->total_rows;
}

// Gather rows by global index into a contiguous output buffer.
// Runs without the GIL when called through ctypes.  The caller checks
// that every index lies in [0, total_rows).
void wstio_gather(void* handle, const int64_t* indices, int64_t n,
                  char* out) {
  Reader* r = static_cast<Reader*>(handle);
  const int64_t rb = r->row_bytes;
  const size_t n_shards = r->shards.size();
  for (int64_t i = 0; i < n; ++i) {
    int64_t g = indices[i];
    // branchless-ish upper_bound over the (tiny) cum table
    size_t lo = 0, hi = n_shards;
    while (lo + 1 < hi) {
      size_t mid = (lo + hi) / 2;
      if (g >= r->cum[mid]) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    const Shard& s = r->shards[lo];
    const int64_t local = g - r->cum[lo];
    std::memcpy(out + i * rb, s.data + local * rb, rb);
  }
}

void wstio_close(void* handle) {
  destroy_reader(static_cast<Reader*>(handle));
}

}  // extern "C"
