// Parallel .npy reader for the data layer (the port's own copy of
// cfdbench_tpu/native/npy_reader.cc).
//
// The dataset is thousands of case dirs each holding u.npy / v.npy
// (C-order little-endian float arrays, (T, H, W)). np.load is
// single-threaded per file and a Python loop serializes the whole split;
// this library reads a batch of files into caller-provided float32
// buffers with a thread pool, converting <f8 to f32 on the fly in
// fixed-size chunks.
//
// Scope is deliberately narrow: npy format versions 1.0/2.0/3.0, dtypes
// '<f4' and '<f8', C-order only: what the dataset contains. Any other
// dtype or Fortran order returns its error code, and the Python side
// reads that batch with np.load (cfdbench_tpu_torch/data/fast_io.py);
// every other error is raised there.
//
// Build: g++ -O2 -shared -fPIC -pthread -std=c++17, driven from Python
// (cfdbench_tpu_torch/native/__init__.py) into build/cfdbench_tpu_torch/.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kMaxDims = 8;

// Error codes (mirrored in cfdbench_tpu_torch/native/__init__.py).
enum : int {
  kOk = 0,
  kErrOpen = 1,
  kErrMagic = 2,
  kErrHeader = 3,
  kErrDtype = 4,
  kErrFortran = 5,
  kErrShort = 6,
  kErrSize = 7,
};

struct NpyInfo {
  int64_t shape[kMaxDims];
  int ndim = 0;
  int dtype_size = 0;  // 4 or 8
  int64_t data_offset = 0;
  int64_t count = 0;
};

int parse_header(FILE* f, NpyInfo* info) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return kErrMagic;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return kErrMagic;
  const int major = magic[6];
  uint32_t header_len = 0;
  int preamble = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return kErrHeader;
    header_len = b[0] | (b[1] << 8);
    preamble = 10;
  } else if (major == 2 || major == 3) {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return kErrHeader;
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
    preamble = 12;
  } else {
    return kErrHeader;
  }
  if (header_len > 1 << 20) return kErrHeader;
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) return kErrHeader;

  // dtype: accept '<f4' / '<f8' (and '|f4' never occurs; '=f4' treated
  // as little-endian, which this library assumes for the host).
  size_t d = header.find("'descr'");
  if (d == std::string::npos) return kErrHeader;
  size_t colon = header.find(':', d);
  if (colon == std::string::npos) return kErrHeader;
  size_t v1 = header.find('\'', colon);
  size_t v2 = header.find('\'', v1 + 1);
  if (v1 == std::string::npos || v2 == std::string::npos) return kErrHeader;
  std::string descr = header.substr(v1 + 1, v2 - v1 - 1);
  if (descr == "<f4" || descr == "=f4") {
    info->dtype_size = 4;
  } else if (descr == "<f8" || descr == "=f8") {
    info->dtype_size = 8;
  } else {
    return kErrDtype;
  }

  size_t fo = header.find("'fortran_order'");
  if (fo == std::string::npos) return kErrHeader;
  size_t fv = header.find_first_of("TF", fo + 15);
  if (fv == std::string::npos) return kErrHeader;
  if (header[fv] == 'T') return kErrFortran;

  size_t sh = header.find("'shape'");
  if (sh == std::string::npos) return kErrHeader;
  size_t p1 = header.find('(', sh);
  size_t p2 = header.find(')', p1);
  if (p1 == std::string::npos || p2 == std::string::npos) return kErrHeader;
  std::string dims = header.substr(p1 + 1, p2 - p1 - 1);
  info->ndim = 0;
  info->count = 1;
  const char* s = dims.c_str();
  while (*s) {
    while (*s == ' ' || *s == ',') ++s;
    if (!*s) break;
    char* end = nullptr;
    long long v = strtoll(s, &end, 10);
    if (end == s) return kErrHeader;
    if (info->ndim >= kMaxDims) return kErrHeader;
    info->shape[info->ndim++] = v;
    info->count *= v;
    s = end;
  }
  info->data_offset = preamble + header_len;
  return kOk;
}

int read_into_f32(const char* path, float* out, int64_t n) {
  FILE* f = fopen(path, "rb");
  if (!f) return kErrOpen;
  NpyInfo info;
  int rc = parse_header(f, &info);
  if (rc != kOk) {
    fclose(f);
    return rc;
  }
  if (info.count != n) {
    fclose(f);
    return kErrSize;
  }
  if (info.dtype_size == 4) {
    if (fread(out, 4, (size_t)n, f) != (size_t)n) rc = kErrShort;
  } else {
    // Chunked f8 → f32 conversion (bounded scratch, cache-friendly).
    constexpr int64_t kChunk = 1 << 16;  // 512 KiB of doubles
    std::vector<double> buf(kChunk);
    int64_t done = 0;
    while (done < n) {
      int64_t take = std::min(kChunk, n - done);
      if (fread(buf.data(), 8, (size_t)take, f) != (size_t)take) {
        rc = kErrShort;
        break;
      }
      for (int64_t i = 0; i < take; ++i) {
        out[done + i] = (float)buf[i];
      }
      done += take;
    }
  }
  fclose(f);
  return rc;
}

}  // namespace

extern "C" {

// Fills shape[ndim], ndim, dtype_size; returns 0 or an error code.
int cfd_npy_header(const char* path, int64_t* shape, int* ndim,
                   int* dtype_size) {
  FILE* f = fopen(path, "rb");
  if (!f) return kErrOpen;
  NpyInfo info;
  int rc = parse_header(f, &info);
  fclose(f);
  if (rc != kOk) return rc;
  for (int i = 0; i < info.ndim; ++i) shape[i] = info.shape[i];
  *ndim = info.ndim;
  *dtype_size = info.dtype_size;
  return kOk;
}

// Single file into a float32 buffer of n elements.
int cfd_npy_read_f32(const char* path, float* out, int64_t n) {
  return read_into_f32(path, out, n);
}

// Batch: thread pool over an atomic work index. rcs[i] gets the
// per-file result code. Returns the first non-zero code (or 0).
int cfd_npy_read_f32_batch(const char** paths, float** outs,
                           const int64_t* ns, int* rcs, int count,
                           int n_threads) {
  std::atomic<int> next(0);
  std::atomic<int> first_err(0);
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= count) return;
      int rc = read_into_f32(paths[i], outs[i], ns[i]);
      rcs[i] = rc;
      if (rc != kOk) {
        int expected = 0;
        first_err.compare_exchange_strong(expected, rc);
      }
    }
  };
  int t = n_threads;
  if (t < 1) t = 1;
  if (t > count) t = count;
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int i = 0; i < t; ++i) pool.emplace_back(work);
  for (auto& th : pool) th.join();
  return first_err.load();
}

}  // extern "C"
