// Native host-side IO runtime for nerf_rs_tpu.
//
// Counterpart of the reference's host runtime pieces: the raw
// little-endian f32 tensor reader (/root/reference/src/lib.rs:34-42), the
// binary PPM writer with clamp*255+0.5 quantization (lib.rs:567-580), and
// the RGBA converter (lib.rs:582-592). Implemented in C++ (not a Python
// wrapper): mmap'd tensor reads, multithreaded quantization, single-write
// image output. Exposed through a plain C ABI consumed via ctypes
// (nerf_rs_tpu/io/native.py).
//
// Build: make -C csrc    (produces _nerf_io.so next to this file)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <functional>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr int kMaxThreads = 16;

inline uint8_t quantize(float v) {
  // clamp(0,1) * 255 + 0.5, truncated — byte-identical to the reference.
  if (v < 0.0f) v = 0.0f;
  if (v > 1.0f) v = 1.0f;
  return static_cast<uint8_t>(v * 255.0f + 0.5f);
}

void parallel_for(int64_t n, int64_t grain,
                  const std::function<void(int64_t, int64_t)> &fn) {
  int threads = static_cast<int>(std::thread::hardware_concurrency());
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 1) threads = 1;
  if (n < grain * 2 || threads == 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    pool.emplace_back([=, &fn] { fn(lo, hi); });
  }
  for (auto &th : pool) th.join();
}

}  // namespace

extern "C" {

// Read `count` little-endian f32 values from `path` into `out`.
// Returns 0 on success, negative errno-style codes otherwise.
int nio_read_f32(const char *path, float *out, int64_t count) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -2;
  }
  int64_t bytes = count * static_cast<int64_t>(sizeof(float));
  if (st.st_size != bytes) {
    close(fd);
    return -3;  // size mismatch (matches the numpy fallback's exact check)
  }
  void *mapped = mmap(nullptr, bytes, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mapped == MAP_FAILED) {
    close(fd);
    return -4;
  }
  std::memcpy(out, mapped, bytes);
  munmap(mapped, bytes);
  close(fd);
  return 0;
}

// Size of `path` in bytes, or negative on error.
int64_t nio_file_size(const char *path) {
  struct stat st;
  if (stat(path, &st) != 0) return -1;
  return static_cast<int64_t>(st.st_size);
}

// Quantize n float pixels to u8 with the reference's formula (threaded).
int nio_quantize_u8(const float *in, uint8_t *out, int64_t n) {
  parallel_for(n, 1 << 20, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) out[i] = quantize(in[i]);
  });
  return 0;
}

// Interleave RGB float pixels into RGBA u8 with A=255 (threaded).
int nio_rgb_to_rgba_u8(const float *rgb, uint8_t *rgba, int64_t n_pixels) {
  parallel_for(n_pixels, 1 << 18, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      rgba[4 * i + 0] = quantize(rgb[3 * i + 0]);
      rgba[4 * i + 1] = quantize(rgb[3 * i + 1]);
      rgba[4 * i + 2] = quantize(rgb[3 * i + 2]);
      rgba[4 * i + 3] = 255;
    }
  });
  return 0;
}

// Write a binary P6 PPM from pre-quantized RGB bytes. Returns 0 on success.
int nio_write_ppm(const char *path, const uint8_t *rgb, int width, int height) {
  FILE *f = fopen(path, "wb");
  if (!f) return -1;
  if (fprintf(f, "P6\n%d %d\n255\n", width, height) < 0) {
    fclose(f);
    return -2;
  }
  size_t n = static_cast<size_t>(width) * height * 3;
  size_t written = fwrite(rgb, 1, n, f);
  fclose(f);
  return written == n ? 0 : -3;
}

// Quantize float RGB and write a PPM in one call (render hot path).
int nio_write_ppm_f32(const char *path, const float *rgb, int width, int height) {
  int64_t n = static_cast<int64_t>(width) * height * 3;
  std::vector<uint8_t> buf(n);
  nio_quantize_u8(rgb, buf.data(), n);
  return nio_write_ppm(path, buf.data(), width, height);
}

}  // extern "C"
