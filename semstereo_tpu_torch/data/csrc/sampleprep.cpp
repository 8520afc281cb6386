// Native sample-preparation kernels for the input pipeline.
//
// The original torch code delegates its host-side hot loop (uint8 decode ->
// float normalize -> gt pyramid) to torchvision/cv2 C++ kernels inside 16
// DataLoader workers (its main_us3d.py:94, datasets/data_io.py:6-13,
// datasets/us3d_.py:178-182).  This file supplies the equivalent native ops
// for our thread-pool loader: fused uint8->ImageNet-normalized float32
// conversion and strided nearest downsampling, exposed through a plain C ABI
// consumed via ctypes (no pybind11 dependency).
//
// A copy of the JAX package's native/sampleprep.cpp.  data/native.py builds it
// at first use with g++ -O3 -march=native -shared -fPIC into the package's
// git-ignored _build/ directory.

#include <cstdint>
#include <cstring>

extern "C" {

// uint8 HWC RGB -> float32 HWC, (x/255 - mean) / std.
void normalize_image_u8(const uint8_t* src, float* dst, int64_t h, int64_t w,
                        const float* mean, const float* stddev) {
  float scale[3], bias[3];
  for (int c = 0; c < 3; ++c) {
    scale[c] = 1.0f / (255.0f * stddev[c]);
    bias[c] = -mean[c] / stddev[c];
  }
  const int64_t n = h * w;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* p = src + i * 3;
    float* q = dst + i * 3;
    q[0] = p[0] * scale[0] + bias[0];
    q[1] = p[1] * scale[1] + bias[1];
    q[2] = p[2] * scale[2] + bias[2];
  }
}

// Strided nearest downsample of a float32 [H, W] map by an integer factor
// (picks rows/cols 0, f, 2f, ... — cv2.INTER_NEAREST for integer factors).
void downsample_nearest_f32(const float* src, float* dst, int64_t h, int64_t w,
                            int64_t factor) {
  const int64_t oh = h / factor, ow = w / factor;
  for (int64_t y = 0; y < oh; ++y) {
    const float* row = src + (y * factor) * w;
    float* out = dst + y * ow;
    for (int64_t x = 0; x < ow; ++x) out[x] = row[x * factor];
  }
}

// Stack n contiguous float32 arrays of `elems` elements into one batch buffer.
void collate_f32(const float* const* srcs, float* dst, int64_t n, int64_t elems) {
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(dst + i * elems, srcs[i], sizeof(float) * elems);
  }
}

}  // extern "C"
