// mlis_runtime — native host-side IO kernels.
//
// The reference's hot host paths are Python per-point/per-message loops
// (SURVEY §2.4: pointcloud parsing at test_lidar_floor_tracker.py:42-75 is a
// per-point Python loop over 48-byte strided PointCloud2 blobs). These C++
// kernels do the strided decodes in one pass; Python binds via ctypes
// (mlis_tpu_torch/runtime/native.py) with numpy fallbacks when no C++
// compiler is found.
//
// Built on first use by mlis_tpu_torch/runtime/native.py (g++ -O3 -fPIC
// -std=c++17 -shared) into build/mlis_tpu_torch/libmlis_runtime.so.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Decode an Ouster-style PointCloud2 blob: fixed point_step stride with
// float32 x/y/z at given offsets and an optional ring channel (uint8 or
// uint16). Writes xyz_out as [n, 3] float32 and ring_out as int32 (or -1 if
// ring_off < 0). Returns the number of points decoded.
long mlis_decode_pointcloud(const unsigned char* data, long data_len,
                            int point_step, int x_off, int y_off, int z_off,
                            int ring_off, int ring_size, float* xyz_out,
                            int* ring_out) {
  if (point_step <= 0 || data_len < point_step) return 0;
  const long n = data_len / point_step;
  const unsigned char* p = data;
  for (long i = 0; i < n; ++i, p += point_step) {
    float x, y, z;
    std::memcpy(&x, p + x_off, 4);
    std::memcpy(&y, p + y_off, 4);
    std::memcpy(&z, p + z_off, 4);
    xyz_out[3 * i + 0] = x;
    xyz_out[3 * i + 1] = y;
    xyz_out[3 * i + 2] = z;
    if (ring_out != nullptr) {
      if (ring_off < 0) {
        ring_out[i] = -1;
      } else if (ring_size == 1) {
        ring_out[i] = p[ring_off];
      } else {  // uint16 little-endian (Ouster)
        uint16_t r;
        std::memcpy(&r, p + ring_off, 2);
        ring_out[i] = r;
      }
    }
  }
  return n;
}

// Parse a TUM trajectory file (timestamp tx ty tz qx qy qz qw per line;
// '#' comments and short lines skipped). out is row-major [n_max, 8].
// Returns rows written, or -1 if the file cannot be opened.
long mlis_parse_tum(const char* path, double* out, long n_max) {
  FILE* f = std::fopen(path, "r");
  if (f == nullptr) return -1;
  char line[1024];
  long rows = 0;
  while (rows < n_max && std::fgets(line, sizeof(line), f) != nullptr) {
    const char* s = line;
    while (*s == ' ' || *s == '\t') ++s;
    if (*s == '#' || *s == '\n' || *s == '\0') continue;
    double v[8];
    char* end = nullptr;
    const char* cur = s;
    int got = 0;
    for (; got < 8; ++got) {
      v[got] = std::strtod(cur, &end);
      if (end == cur) break;
      cur = end;
    }
    if (got < 8) continue;
    std::memcpy(out + rows * 8, v, sizeof(v));
    ++rows;
  }
  std::fclose(f);
  return rows;
}

// Batch-parse serialized ROS1 sensor_msgs/Imu messages.
// blob: concatenated message bodies; offsets[i]: byte offset of message i;
// lengths[i]: its length. Extracts header stamp (sec+nsec -> double),
// linear_acceleration and angular_velocity. Returns messages parsed.
//
// ROS1 Imu layout (little-endian):
//   uint32 seq | uint32 sec | uint32 nsec | uint32 frame_id_len | frame_id
//   | 4 f64 orientation | 9 f64 cov | 3 f64 angular_velocity | 9 f64 cov
//   | 3 f64 linear_acceleration | 9 f64 cov
long mlis_parse_imu_batch(const unsigned char* blob, const long* offsets,
                          const long* lengths, long n, double* stamps,
                          double* accel, double* gyro) {
  long ok = 0;
  for (long i = 0; i < n; ++i) {
    const unsigned char* p = blob + offsets[i];
    const long len = lengths[i];
    if (len < 16) continue;
    uint32_t sec, nsec, fid_len;
    std::memcpy(&sec, p + 4, 4);
    std::memcpy(&nsec, p + 8, 4);
    std::memcpy(&fid_len, p + 12, 4);
    const long base = 16 + (long)fid_len;
    // orientation(32) + cov(72) = 104; angular 24 + cov 72; linear 24 + 72
    if (len < base + 104 + 96 + 96) continue;
    stamps[ok] = (double)sec + 1e-9 * (double)nsec;
    std::memcpy(gyro + 3 * ok, p + base + 104, 24);
    std::memcpy(accel + 3 * ok, p + base + 104 + 96, 24);
    ++ok;
  }
  return ok;
}

// Batch-parse serialized ROS1 nav_msgs/Odometry messages into TUM rows
// [stamp tx ty tz qx qy qz qw]. Returns messages parsed.
// Layout: header (seq,sec,nsec,frame_id) | string child_frame_id |
//   pose: 3 f64 position + 4 f64 orientation + 36 f64 cov | twist...
long mlis_parse_odometry_batch(const unsigned char* blob, const long* offsets,
                               const long* lengths, long n, double* tum_out) {
  long ok = 0;
  for (long i = 0; i < n; ++i) {
    const unsigned char* p = blob + offsets[i];
    const long len = lengths[i];
    if (len < 16) continue;
    uint32_t sec, nsec, fid_len;
    std::memcpy(&sec, p + 4, 4);
    std::memcpy(&nsec, p + 8, 4);
    std::memcpy(&fid_len, p + 12, 4);
    long cur = 16 + (long)fid_len;
    if (len < cur + 4) continue;
    uint32_t cid_len;
    std::memcpy(&cid_len, p + cur, 4);
    cur += 4 + (long)cid_len;
    if (len < cur + 56) continue;
    double* row = tum_out + 8 * ok;
    row[0] = (double)sec + 1e-9 * (double)nsec;
    std::memcpy(row + 1, p + cur, 56);  // 3 pos + 4 quat doubles
    ++ok;
  }
  return ok;
}

}  // extern "C"
