// Native KITTI/Mulran ".bin" scan loader.
//
// C++ equivalent of the reference's C++ data path (bin_runner.cpp:125-165):
// read float32 x,y,z,intensity records with a 4-float stride, drop NaNs,
// filter by range, and optionally apply the undocumented KITTI 0.205
// degree vertical-angle correction (bin_runner.cpp:55,153-161). Python
// binds this through ctypes (madicp_tpu/native/loader.py) — no pybind11
// in this toolchain.
//
// All math runs in double, matching the numpy fallback reader
// (utils/kitti.py), so the two paths produce bitwise-comparable clouds.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <vector>

namespace {

constexpr double kVerticalAngleRad = 0.205 * M_PI / 180.0;

// Rodrigues rotation of p about unit axis k by angle a.
inline void rotate(const double p[3], const double k[3], double c, double s,
                   double out[3]) {
  const double kxp[3] = {k[1] * p[2] - k[2] * p[1], k[2] * p[0] - k[0] * p[2],
                         k[0] * p[1] - k[1] * p[0]};
  const double kdp = k[0] * p[0] + k[1] * p[1] + k[2] * p[2];
  for (int i = 0; i < 3; ++i) {
    out[i] = p[i] * c + kxp[i] * s + k[i] * kdp * (1.0 - c);
  }
}

}  // namespace

extern "C" {

// Reads `path`, writes up to `cap` filtered points into `out` (row-major
// N x 3 doubles). Returns the number of points written, or -1 on I/O error.
long madicp_read_bin(const char* path, double min_range, double max_range,
                     int apply_correction, double* out, long cap) {
  std::FILE* f = std::fopen(path, "rb");
  if (f == nullptr) return -1;

  const double c = std::cos(kVerticalAngleRad);
  const double s = std::sin(kVerticalAngleRad);

  long n = 0;
  std::vector<float> buf(4 * 4096);
  size_t got;
  while ((got = std::fread(buf.data(), sizeof(float), buf.size(), f)) > 0) {
    const size_t records = got / 4;
    for (size_t r = 0; r < records && n < cap; ++r) {
      const double p[3] = {static_cast<double>(buf[4 * r]),
                           static_cast<double>(buf[4 * r + 1]),
                           static_cast<double>(buf[4 * r + 2])};
      if (!std::isfinite(p[0]) || !std::isfinite(p[1]) || !std::isfinite(p[2]))
        continue;
      const double norm = std::sqrt(p[0] * p[0] + p[1] * p[1] + p[2] * p[2]);
      if (norm < min_range || norm > max_range) continue;
      if (apply_correction != 0) {
        // axis = normalize(p x z); rotate p toward +z by 0.205 degrees
        double axis[3] = {p[1], -p[0], 0.0};
        const double an = std::sqrt(axis[0] * axis[0] + axis[1] * axis[1]);
        if (an > 0.0) {
          axis[0] /= an;
          axis[1] /= an;
          rotate(p, axis, c, s, &out[3 * n]);
        } else {
          out[3 * n] = p[0];
          out[3 * n + 1] = p[1];
          out[3 * n + 2] = p[2];
        }
      } else {
        out[3 * n] = p[0];
        out[3 * n + 1] = p[1];
        out[3 * n + 2] = p[2];
      }
      ++n;
    }
  }
  std::fclose(f);
  return n;
}

// Number of 16-byte records in a file (capacity hint for the caller).
long madicp_bin_records(const char* path) {
  std::FILE* f = std::fopen(path, "rb");
  if (f == nullptr) return -1;
  std::fseek(f, 0, SEEK_END);
  const long bytes = std::ftell(f);
  std::fclose(f);
  return bytes / 16;
}

}  // extern "C"
