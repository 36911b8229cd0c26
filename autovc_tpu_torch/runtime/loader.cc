// autovc_tpu_torch native runtime: threaded audio/feature IO + batch packing.
//
// The host-side heavy lifting of the data path, in a small C++ core with a
// plain C ABI for ctypes (autovc_tpu_torch/runtime/bindings.py):
//   - PCM WAV decode (16-bit, channels averaged) -> float32, multithreaded
//     over files
//   - a minimal .npy (float32, C-order, 1-D/2-D) reader, multithreaded
//   - batch packing: gather len_crop crops from resident feature buffers
//     into a contiguous batch, zero-padded past an utterance's end
//
// Built at first use by bindings.py: g++ -O3 -fPIC -std=c++17 -shared
// -lpthread into build/runtime/ at the root of the checkout.

#include <atomic>
#include <functional>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Buffer {
  std::vector<float> data;
  int64_t rows = 0;  // frames (or samples)
  int64_t cols = 0;  // feature dim (1 for waveforms)
  bool ok = false;
};

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(n));
  size_t got = std::fread(out->data(), 1, static_cast<size_t>(n), f);
  std::fclose(f);
  return got == static_cast<size_t>(n);
}

uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
uint16_t rd_u16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}

// Decode a 16-bit PCM (mono or averaged multichannel) RIFF WAV.
Buffer decode_wav(const char* path) {
  Buffer b;
  std::vector<uint8_t> raw;
  if (!read_file(path, &raw) || raw.size() < 44) return b;
  if (std::memcmp(raw.data(), "RIFF", 4) || std::memcmp(raw.data() + 8, "WAVE", 4))
    return b;
  size_t pos = 12;
  uint16_t channels = 1, bits = 16;
  uint32_t data_off = 0, data_len = 0;
  while (pos + 8 <= raw.size()) {
    uint32_t chunk_len = rd_u32(&raw[pos + 4]);
    if (!std::memcmp(&raw[pos], "fmt ", 4) && pos + 24 <= raw.size()) {
      channels = rd_u16(&raw[pos + 10]);
      bits = rd_u16(&raw[pos + 22]);
    } else if (!std::memcmp(&raw[pos], "data", 4)) {
      data_off = static_cast<uint32_t>(pos + 8);
      data_len = chunk_len;
      break;
    }
    pos += 8 + chunk_len + (chunk_len & 1);
  }
  if (!data_off || bits != 16 || channels == 0) return b;
  if (data_off + static_cast<size_t>(data_len) > raw.size())
    data_len = static_cast<uint32_t>(raw.size() - data_off);
  int64_t n = data_len / 2 / channels;
  b.data.resize(static_cast<size_t>(n));
  const uint8_t* src = raw.data() + data_off;
  for (int64_t i = 0; i < n; ++i) {
    float acc = 0.f;
    for (int c = 0; c < channels; ++c) {
      int16_t s;
      std::memcpy(&s, src + (i * channels + c) * 2, 2);
      acc += static_cast<float>(s);
    }
    b.data[static_cast<size_t>(i)] = acc / (32768.f * channels);
  }
  b.rows = n;
  b.cols = 1;
  b.ok = true;
  return b;
}

// Minimal .npy v1/v2 reader for little-endian float32 C-order 1-D/2-D arrays.
Buffer load_npy(const char* path) {
  Buffer b;
  std::vector<uint8_t> raw;
  if (!read_file(path, &raw) || raw.size() < 10) return b;
  if (raw[0] != 0x93 || std::memcmp(&raw[1], "NUMPY", 5)) return b;
  uint8_t major = raw[6];
  size_t hlen, hoff;
  if (major == 1) {
    hlen = rd_u16(&raw[8]);
    hoff = 10;
  } else {
    hlen = rd_u32(&raw[8]);
    hoff = 12;
  }
  if (hoff + hlen > raw.size()) return b;
  std::string hdr(reinterpret_cast<char*>(&raw[hoff]), hlen);
  if (hdr.find("'descr': '<f4'") == std::string::npos &&
      hdr.find("\"descr\": \"<f4\"") == std::string::npos)
    return b;
  if (hdr.find("'fortran_order': False") == std::string::npos) return b;
  size_t sp = hdr.find("'shape': (");
  if (sp == std::string::npos) return b;
  sp += 10;
  int64_t rows = 0, cols = 1;
  rows = std::strtoll(hdr.c_str() + sp, nullptr, 10);
  size_t comma = hdr.find(',', sp);
  size_t close = hdr.find(')', sp);
  if (comma != std::string::npos && comma < close) {
    const char* p = hdr.c_str() + comma + 1;
    while (*p == ' ') ++p;
    if (*p != ')') cols = std::strtoll(p, nullptr, 10);
    // reject >=3-D arrays: a further dimension before ')' would otherwise be
    // silently dropped and the store would expose the first rows*cols floats
    // of a larger tensor as if it were the whole array
    size_t comma2 = hdr.find(',', comma + 1);
    if (comma2 != std::string::npos && comma2 < close) {
      const char* q = hdr.c_str() + comma2 + 1;
      while (*q == ' ') ++q;
      if (*q != ')') return b;
    }
  }
  size_t data_off = hoff + hlen;
  size_t count = static_cast<size_t>(rows) * static_cast<size_t>(cols);
  if (data_off + count * 4 > raw.size()) return b;
  b.data.resize(count);
  std::memcpy(b.data.data(), raw.data() + data_off, count * 4);
  b.rows = rows;
  b.cols = cols;
  b.ok = true;
  return b;
}

void parallel_for(int64_t n, int threads, const std::function<void(int64_t)>& fn) {
  if (threads <= 1 || n <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  int tcount = static_cast<int>(std::min<int64_t>(threads, n));
  pool.reserve(static_cast<size_t>(tcount));
  for (int t = 0; t < tcount; ++t) {
    pool.emplace_back([&] {
      for (;;) {
        int64_t i = next.fetch_add(1);
        if (i >= n) return;
        fn(i);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Batched WAV decode. paths: array of C strings. For each file, writes up to
// max_len samples into out + i*max_len and the true length into lengths[i]
// (0 on failure). Returns number of successfully decoded files.
int64_t avc_read_wavs(const char** paths, int64_t n_files, float* out,
                      int64_t max_len, int64_t* lengths, int threads) {
  std::atomic<int64_t> ok_count(0);
  parallel_for(n_files, threads, [&](int64_t i) {
    Buffer b = decode_wav(paths[i]);
    if (!b.ok) {
      lengths[i] = 0;
      return;
    }
    int64_t n = std::min<int64_t>(b.rows, max_len);
    std::memcpy(out + i * max_len, b.data.data(), static_cast<size_t>(n) * 4);
    lengths[i] = b.rows;
    ok_count.fetch_add(1);
  });
  return ok_count.load();
}

// Opaque feature store: resident float32 feature buffers for batch packing.
struct AvcStore {
  std::vector<Buffer> items;
};

AvcStore* avc_store_create() { return new AvcStore(); }
void avc_store_destroy(AvcStore* s) { delete s; }

// Load one .npy into the store; returns its index or -1.
int64_t avc_store_load_npy(AvcStore* s, const char* path) {
  Buffer b = load_npy(path);
  if (!b.ok) return -1;
  s->items.push_back(std::move(b));
  return static_cast<int64_t>(s->items.size() - 1);
}

// Threaded bulk load; indices written to out_ids (-1 on failure per file).
void avc_store_load_npy_batch(AvcStore* s, const char** paths, int64_t n,
                              int64_t* out_ids, int threads) {
  size_t base = s->items.size();
  s->items.resize(base + static_cast<size_t>(n));
  parallel_for(n, threads, [&](int64_t i) {
    s->items[base + static_cast<size_t>(i)] = load_npy(paths[i]);
  });
  for (int64_t i = 0; i < n; ++i)
    out_ids[i] = s->items[base + static_cast<size_t>(i)].ok
                     ? static_cast<int64_t>(base) + i
                     : -1;
}

int64_t avc_store_rows(AvcStore* s, int64_t id) { return s->items[static_cast<size_t>(id)].rows; }
int64_t avc_store_cols(AvcStore* s, int64_t id) { return s->items[static_cast<size_t>(id)].cols; }

// Zero-copy view of a resident buffer (valid until the store is destroyed;
// the store is append-only so pointers stay stable modulo vector growth —
// call only after all loads are done).
const float* avc_store_data(AvcStore* s, int64_t id) {
  return s->items[static_cast<size_t>(id)].data.data();
}

// Pack a batch: for row b, copy len_crop rows starting at offsets[b] from
// item ids[b] into out (B, len_crop, cols), zero-padding past the end
// (reference crop/pad semantics, data_loader.py:68-78).
void avc_store_pack(AvcStore* s, const int64_t* ids, const int64_t* offsets,
                    int64_t batch, int64_t len_crop, float* out, int threads) {
  int64_t cols = s->items[static_cast<size_t>(ids[0])].cols;
  parallel_for(batch, threads, [&](int64_t bi) {
    const Buffer& it = s->items[static_cast<size_t>(ids[bi])];
    float* dst = out + bi * len_crop * cols;
    int64_t start = offsets[bi];
    int64_t avail = it.rows > start ? std::min<int64_t>(len_crop, it.rows - start) : 0;
    if (avail > 0)
      std::memcpy(dst, it.data.data() + start * cols,
                  static_cast<size_t>(avail * cols) * 4);
    if (avail < len_crop)
      std::memset(dst + avail * cols, 0,
                  static_cast<size_t>((len_crop - avail) * cols) * 4);
  });
}

}  // extern "C"
