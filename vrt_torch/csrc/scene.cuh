// What the scene march (march.cu) and the fused resolve (resolve.cu) share:
// NaN-propagating max / min and sign, the stacked-volume tables, the
// instance table, and the world -> object transform of a ray.  Every
// function follows the operation order of its plain-torch version, and both
// sources are built with --fmad=false, so each operation rounds on its own
// as in eager PyTorch.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vrt {

// jnp.sign: NaN stays NaN (a NaN never compares equal or <= 0).
__device__ __forceinline__ float sgn(float x) {
  if (isnan(x)) return x;
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// NaN-propagating max / min (jnp.maximum, torch.maximum, torch.amax).
__device__ __forceinline__ float nmax(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return a < b ? b : a;
}
__device__ __forceinline__ float nmin(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return b < a ? b : a;
}

__device__ __forceinline__ float sum8(const float p[8]) {
  return ((p[0] + p[4]) + (p[2] + p[6])) + ((p[1] + p[5]) + (p[3] + p[7]));
}

template <typename T>
__device__ __forceinline__ float load_corner(const T* p);
template <>
__device__ __forceinline__ float load_corner<float>(const float* p) {
  return __ldg(p);
}
// bf16 rows travel as raw 16-bit words: bf16 -> f32 is exact as u16 << 16.
template <>
__device__ __forceinline__ float load_corner<uint16_t>(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}

// The tables of a stacked DeviceVolume (V volumes padded to C cells a side).
struct Tables {
  const int32_t* n;        // [V] voxels per axis
  const float* cell_size;  // [V]
  const float* extends;    // [V]
  const uint8_t* accel;    // [V*C^3] packed, skips clamped to 127
  const void* corners;     // [V*C^3, ch] f32 or bf16
  const float* sdf;        // [V*N^3] voxel densities, N = C + 1
  int cc;                  // C: cells per axis of the padded tables
  int ch;                  // corner-table channels, 8 or 9
};

// The scene's instances: world = diag(scale) . R(rot) + pos.
struct Instances {
  const int32_t* volume;  // [I]
  const float* pos;       // [I,3]
  const float* rot;       // [I,4] quaternion (x, y, z, w)
  const float* scale;     // [I,3]
  const uint8_t* active;  // [I] bool
  int count;
};

__device__ __forceinline__ void cross3(const float a[3], const float b[3],
                                       float c[3]) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// core/quat.py rotate(q, v): t = 2 * cross(qv, v); v + qw * t + cross(qv, t).
__device__ __forceinline__ void rotate(const float qv[3], float qw,
                                       const float v[3], float out[3]) {
  float t[3], c[3];
  cross3(qv, v, t);
  for (int k = 0; k < 3; ++k) t[k] = 2.0f * t[k];
  cross3(qv, t, c);
  for (int k = 0; k < 3; ++k) out[k] = (v[k] + qw * t[k]) + c[k];
}

// renderer.py _world_to_object with instance i's transform: rotate by the
// conjugate after (o_w - pos) / scale and d_w / scale; t is preserved.
__device__ __forceinline__ void world_to_object(const Instances& in, int i,
                                                const float o_w[3],
                                                const float d_w[3],
                                                float o[3], float d[3]) {
  float qv[3], a[3], b[3];
  for (int k = 0; k < 3; ++k) {
    qv[k] = -__ldg(in.rot + 4 * i + k);
    const float s = __ldg(in.scale + 3 * i + k);
    a[k] = (o_w[k] - __ldg(in.pos + 3 * i + k)) / s;
    b[k] = d_w[k] / s;
  }
  const float qw = __ldg(in.rot + 4 * i + 3);
  rotate(qv, qw, a, o);
  rotate(qv, qw, b, d);
}

}  // namespace vrt
