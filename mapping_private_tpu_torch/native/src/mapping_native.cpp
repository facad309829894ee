// Native host library of mapping_private_tpu_torch: the host-side data path.
//
// The reference's data loading is C++ (PCL's PCD reader, used by every
// test/ executable).  This library gives the port the same native-speed
// ingest: a multithreaded ASCII float tokenizer (the hot path when reading
// ASCII PCD files), packed 30-bit grid-hash keys and RGB float unpacking.
// The same source as the JAX package's native library.
//
// A plain C ABI consumed through ctypes (no pybind11).
// Build: mapping_private_tpu_torch/native/build.py (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <thread>
#include <vector>

extern "C" {

// Parse whitespace-separated floats from text[0:len) into out (up to
// capacity).  Returns the number parsed, or -1 on overflow.
long parse_floats(const char* text, long len, float* out, long capacity) {
  const char* p = text;
  const char* end = text + len;
  long n = 0;
  while (p < end) {
    // skip whitespace
    while (p < end && (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t'))
      ++p;
    if (p >= end) break;
    char* next = nullptr;
    float v = strtof(p, &next);
    if (next == p) {  // unparseable token (e.g. 'nan' handled by strtof; skip junk)
      while (p < end && !(*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t'))
        ++p;
      continue;
    }
    if (n >= capacity) return -1;
    out[n++] = v;
    p = next;
  }
  return n;
}

// Multithreaded variant: splits the buffer at whitespace boundaries and
// parses chunks concurrently.  Chunks write into disjoint slices sized by
// a counting prepass (token counts are exact, so the concatenation is
// identical to the serial parse).
static long count_tokens(const char* p, const char* end) {
  long n = 0;
  bool in_tok = false;
  for (; p < end; ++p) {
    bool ws = (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t');
    if (!ws && !in_tok) { ++n; in_tok = true; }
    else if (ws) in_tok = false;
  }
  return n;
}

long parse_floats_mt(const char* text, long len, float* out, long capacity,
                     int num_threads) {
  if (num_threads <= 1 || len < (1 << 20))
    return parse_floats(text, len, out, capacity);
  const char* end = text + len;
  std::vector<const char*> bounds(num_threads + 1);
  bounds[0] = text;
  for (int t = 1; t < num_threads; ++t) {
    const char* p = text + (len * t) / num_threads;
    while (p < end && !(*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t'))
      ++p;  // advance to a whitespace boundary
    bounds[t] = p;
  }
  bounds[num_threads] = end;

  std::vector<long> counts(num_threads);
  std::vector<std::thread> workers;
  for (int t = 0; t < num_threads; ++t)
    workers.emplace_back([&, t] { counts[t] = count_tokens(bounds[t], bounds[t + 1]); });
  for (auto& w : workers) w.join();
  workers.clear();

  std::vector<long> offsets(num_threads + 1, 0);
  for (int t = 0; t < num_threads; ++t) offsets[t + 1] = offsets[t] + counts[t];
  if (offsets[num_threads] > capacity) return -1;

  std::vector<long> parsed(num_threads);
  for (int t = 0; t < num_threads; ++t)
    workers.emplace_back([&, t] {
      parsed[t] = parse_floats(bounds[t], bounds[t + 1] - bounds[t],
                               out + offsets[t], counts[t]);
    });
  for (auto& w : workers) w.join();
  // compact in case any chunk skipped junk tokens (parsed < counted)
  long total = 0;
  for (int t = 0; t < num_threads; ++t) {
    if (parsed[t] < 0) return -1;
    if (total != offsets[t] && parsed[t] > 0)
      memmove(out + total, out + offsets[t], parsed[t] * sizeof(float));
    total += parsed[t];
  }
  return total;
}

// Packed 30-bit grid-hash keys (10 bits per axis, wrap mod 1024).
void grid_keys(const float* xyz, long n, float inv_cell, int32_t* keys) {
  constexpr int32_t MASKB = (1 << 10) - 1;
  for (long i = 0; i < n; ++i) {
    int32_t cx = (int32_t)floorf(xyz[3 * i + 0] * inv_cell) & MASKB;
    int32_t cy = (int32_t)floorf(xyz[3 * i + 1] * inv_cell) & MASKB;
    int32_t cz = (int32_t)floorf(xyz[3 * i + 2] * inv_cell) & MASKB;
    keys[i] = (cx << 20) | (cy << 10) | cz;
  }
}

// PCL packed-rgb float → separate r/g/b channels (io/pcd.py _unpack_rgb).
void unpack_rgb(const float* rgbf, long n, float* r, float* g, float* b) {
  for (long i = 0; i < n; ++i) {
    uint32_t v;
    memcpy(&v, &rgbf[i], sizeof(v));
    r[i] = (float)((v >> 16) & 0xFF);
    g[i] = (float)((v >> 8) & 0xFF);
    b[i] = (float)(v & 0xFF);
  }
}

}  // extern "C"
