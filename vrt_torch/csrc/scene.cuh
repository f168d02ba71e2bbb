// What the scene march (march.cu), the fused resolve (resolve.cu) and the
// shading (shade.cu) share: NaN-propagating max / min and sign, the
// stacked-volume tables, the instance table, the world -> object transform
// of a ray and its backward in the transform, and the corners of a cell
// read from one rank's slab planes.  Every
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

// One rank's x-slab of a slab-sharded volume as its voxel planes: f32
// [span, nn, nn], plane x holding global voxel plane x0 + x; n voxels a side
// of the full volume.  A voxel reads 0 outside the volume or outside the
// planes, as vrt/dist/brick.py::_slab_fetch reads it.
struct SlabPlanes {
  const float* sdf;
  long long nn;
  int span, x0, n;

  __device__ __forceinline__ bool valid(int x, int y, int z) const {
    const int lx = x - x0;
    return x >= 0 && y >= 0 && z >= 0 && x < n && y < n && z < n &&
           lx >= 0 && lx < span;
  }
  // flat index of global voxel (x, y, z) (meaningful where valid)
  __device__ __forceinline__ long long index(int x, int y, int z) const {
    return (static_cast<long long>(x - x0) * nn + y) * nn + z;
  }
  // the 8 corners of cell c in the corner order (bit k of corner j is its
  // offset on axis k), each read by voxel: independent loads, z and z + 1
  // adjacent
  __device__ __forceinline__ void corners(const int c[3], float v[8]) const {
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int x = c[0] + (j & 1), y = c[1] + ((j >> 1) & 1),
                z = c[2] + ((j >> 2) & 1);
      v[j] = valid(x, y, z) ? __ldg(sdf + index(x, y, z)) : 0.0f;
    }
  }
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

// rotate(qv, qw, v)'s cotangents in the quaternion and in v (added).
__device__ __forceinline__ void rotate_bwd(const float qv[3], float qw,
                                           const float v[3],
                                           const float g[3], float g_qv[3],
                                           float& g_qw, float g_v[3]) {
  float tt[3], a[3], b[3], gt[3];
  cross3(qv, v, tt);
  for (int c = 0; c < 3; ++c) tt[c] = 2.0f * tt[c];
  g_qw += (g[0] * tt[0] + g[1] * tt[1]) + g[2] * tt[2];
  cross3(tt, g, a);            // d(qv x tt) / d qv
  for (int c = 0; c < 3; ++c) g_qv[c] += a[c];
  cross3(g, qv, b);            // d(qv x tt) / d tt
  for (int c = 0; c < 3; ++c) gt[c] = 2.0f * (qw * g[c] + b[c]);
  cross3(v, gt, a);            // d(qv x v) / d qv
  cross3(gt, qv, b);           // d(qv x v) / d v
  for (int c = 0; c < 3; ++c) {
    g_qv[c] += a[c];
    g_v[c] += g[c] + b[c];
  }
}

// The words of an instance transform's cotangents in the instance
// variants' sums: pos 3, rot 4, scale 3 (gpuscene.INSTANCE_FIELDS' order).
constexpr int kInstanceWords = 10;

// The cotangents of an instance transform (pos, rot, scale) for the
// cotangent g of an object-space vector x = rotate(conj(rot), a), a =
// (x_w - pos) / scale for a point (kPoint), x_w / scale for a direction
// (world_to_object), added into gi (kInstanceWords).  Under rotate's formula
// the transpose of rotate(conj(q), .) is rotate(q, .) exactly, whatever |q|:
// x_w's cotangent is rotate(rot, g) / scale, which goes with a minus into
// pos (a point's) and, times a, into scale; the quaternion's is rotate_bwd
// on the conjugate, its vector part's sign flipped
// (renderer.py _object_backward).
template <bool kPoint>
__device__ __forceinline__ void object_bwd(const float pos[3],
                                           const float rot[4],
                                           const float scale[3],
                                           const float x_w[3],
                                           const float g[3],
                                           float gi[kInstanceWords]) {
  const float qc[3] = {-rot[0], -rot[1], -rot[2]};
  float a[3], ga[3], gq[3] = {0.0f, 0.0f, 0.0f}, g_v[3] = {0.0f, 0.0f, 0.0f};
  float gw = 0.0f;
  for (int k = 0; k < 3; ++k)
    a[k] = kPoint ? (x_w[k] - pos[k]) / scale[k] : x_w[k] / scale[k];
  rotate(rot, rot[3], g, ga);
  rotate_bwd(qc, rot[3], a, g, gq, gw, g_v);
  for (int k = 0; k < 3; ++k) {
    const float gx = ga[k] / scale[k];
    if (kPoint) gi[k] -= gx;
    gi[3 + k] -= gq[k];
    gi[7 + k] -= gx * a[k];
  }
  gi[6] += gw;
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
