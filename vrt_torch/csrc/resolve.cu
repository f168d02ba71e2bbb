// The fused resolve, forward, for Hopper (sm_90a): one thread per ray turns
// a scene hit into (t, object-space normal, unlit).
//
// It replaces no Pallas kernel: vrt resolves hits with XLA ops
// (vrt/render/renderer.py::resolve_scene -> vrt/march/resolve.py::
// resolve_hits, with vrt/march/isosurface.py::make_stacked_corner_fetch,
// trilinear_rows and central_difference_normal_rows).  It computes what
// vrt_torch.render.renderer.resolve_scene_reference computes for a frame
// that records no autograd graph: the per-ray instance (inst = -1 reads
// instance 0), world -> object, on surface hits the central-difference
// normal of the trilinear field from the corner rows of the hit cell's six
// neighbours (a row is valid when cell >= 0 and cell + 1 < n, else zeros;
// the first 8 channels; bf16 widened exactly), t = the march's root with
// non-finite values flushed to 0, on solid-entry hits the biased slab entry
// t, and the selects by hit kind.  The hit cell's own row feeds only the
// gradient term, which such a frame skips, so it is not read.
//
// What bounds it: bytes.  A ray brings 60 B (o, d, inst, kind, t, cell, face
// normal) and takes 17 B away; a surface hit adds six rows of 16 B (bf16) or
// 32-36 B (f32) from a table of 19 to 67 MB, neighbours of one cell, so they
// share sectors and L2 lines.  At 1920x1080 that is 160 MB, 0.048 ms at
// 3.35 TB/s, plus at most 0.2 GB of rows.  The plain version instead writes
// the [R,7,8] f32 rows (464 MB) through the row gather K3 and reads them back
// through some hundred element-wise kernels, after gathering every ray's
// transform from the instance table.
//
// What the design does about it: everything between the hit and the normal
// stays in registers.  Rows are read only on surface lanes (elsewhere the
// normal is not selected), with 16-byte loads where rows and base are
// 16-byte aligned and one __ldg per element otherwise (9-channel rows).
// Built with --fmad=false, and every sum in the plain version's order, so
// the result equals the plain version's bit for bit.

#include "scene.cuh"

namespace {

using namespace vrt;

constexpr int kKindSurface = 1;
constexpr int kKindSolidEntry = 2;
constexpr int kKindExhausted = 3;
constexpr int kKindDebug = 5;

struct ResolveParams {
  const float* o_w;        // [R,3]
  const float* d_w;        // [R,3]
  const int32_t* winner;   // [R] instance, -1 for none
  const int32_t* kind;     // [R]
  const float* t;          // [R]
  const int32_t* cell;     // [R,3]
  const float* face;       // [R,3]
  Instances inst;
  Tables tb;
  long long rays;
  float* t_out;            // [R]
  float* normal;           // [R,3]
  uint8_t* unlit;          // [R]
};

// The first 8 channels of a corner row as f32.  E is float or uint16_t (the
// bits of bf16); kV16 reads 16 bytes per load.
template <typename E, bool kV16>
__device__ __forceinline__ void load_row(const E* row, float v[8]) {
  if (kV16) {
    const uint4* src = reinterpret_cast<const uint4*>(row);
    if (sizeof(E) == 4) {
      for (int q = 0; q < 2; ++q) {
        const uint4 w = __ldg(src + q);
        v[4 * q + 0] = __uint_as_float(w.x);
        v[4 * q + 1] = __uint_as_float(w.y);
        v[4 * q + 2] = __uint_as_float(w.z);
        v[4 * q + 3] = __uint_as_float(w.w);
      }
    } else {
      const uint4 w = __ldg(src);
      const uint32_t u[4] = {w.x, w.y, w.z, w.w};
      for (int q = 0; q < 4; ++q) {
        v[2 * q + 0] = __uint_as_float(u[q] << 16);
        v[2 * q + 1] = __uint_as_float(u[q] & 0xffff0000u);
      }
    }
  } else {
    for (int j = 0; j < 8; ++j) v[j] = load_corner<E>(row + j);
  }
}

// isosurface.py trilinear_rows: abs((1 - i) - p) weights, sum8's order.
__device__ __forceinline__ float trilinear(const float v[8],
                                           const float q[3]) {
  float term[8];
  for (int i = 0; i < 8; ++i) {
    float w[3];
    for (int k = 0; k < 3; ++k)
      w[k] = fabsf((((i >> k) & 1) ? 0.0f : 1.0f) - q[k]);
    term[i] = ((w[0] * w[1]) * w[2]) * v[i];
  }
  return sum8(term);
}

template <typename E, bool kV16>
__global__ void __launch_bounds__(256) resolve_kernel(const ResolveParams p) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= p.rays) return;
  const int kind = p.kind[i];
  const float t0 = p.t[i];

  float normal[3];
  float t = t0;
  if (kind == kKindSurface || kind == kKindSolidEntry) {
    float o_w[3], d_w[3], o[3], d[3];
    for (int k = 0; k < 3; ++k) {
      o_w[k] = p.o_w[3 * i + k];
      d_w[k] = p.d_w[3 * i + k];
    }
    const int a = max(p.winner[i], 0);
    world_to_object(p.inst, a, o_w, d_w, o, d);
    const int v = __ldg(p.inst.volume + a);
    const float ext = __ldg(p.tb.extends + v);
    if (kind == kKindSolidEntry) {
      // resolve.py _slab_enter + 0.01
      float te = 0.0f;
      for (int k = 0; k < 3; ++k) {
        const bool finite = d[k] != 0.0f;
        const float s_min = d[k] > 0.0f ? -ext : ext;
        const float inv = finite ? 1.0f / d[k] : 0.0f;
        const float tk = finite ? (s_min - o[k]) * inv : -INFINITY;
        te = k == 0 ? tk : nmax(te, tk);
      }
      t = te + 0.01f;
      for (int k = 0; k < 3; ++k) normal[k] = p.face[3 * i + k];
    } else {
      const int n = __ldg(p.tb.n + v);
      const float h = __ldg(p.tb.cell_size + v);
      const long long cc = p.tb.cc;
      const E* table = static_cast<const E*>(p.tb.corners) +
                       static_cast<long long>(v) * cc * cc * cc * p.tb.ch;
      t = isfinite(t0) ? t0 : 0.0f;
      int cell[3];
      float q[3];
      for (int k = 0; k < 3; ++k) {
        cell[k] = p.cell[3 * i + k];
        const float base = static_cast<float>(cell[k]) * h - ext;
        q[k] = ((o[k] + d[k] * t) - base) / h;
      }
      // central_difference_normal_rows over the +x, -x, +y, -y, +z, -z
      // neighbours
      float g[3];
      for (int k = 0; k < 3; ++k) {
        float f[2];
        for (int s = 0; s < 2; ++s) {
          int c[3] = {cell[0], cell[1], cell[2]};
          c[k] += s == 0 ? 1 : -1;
          const bool valid = c[0] >= 0 && c[1] >= 0 && c[2] >= 0 &&
                             c[0] + 1 < n && c[1] + 1 < n && c[2] + 1 < n;
          float v8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          if (valid)
            load_row<E, kV16>(
                table + ((c[0] * cc + c[1]) * cc + c[2]) * p.tb.ch, v8);
          f[s] = trilinear(v8, q);
        }
        g[k] = f[0] - f[1];
      }
      const float n2 = (g[0] * g[0] + g[1] * g[1]) + g[2] * g[2];
      const bool good = n2 > 0.0f && isfinite(n2);
      const float norm = sqrtf(good ? n2 : 1.0f);
      for (int k = 0; k < 3; ++k) normal[k] = good ? g[k] / norm : 0.0f;
    }
  } else if (kind == kKindDebug) {
    normal[0] = 1.0f;
    normal[1] = 0.0f;
    normal[2] = 0.0f;
  } else {
    for (int k = 0; k < 3; ++k) normal[k] = p.face[3 * i + k];
  }

  p.t_out[i] = t;
  p.unlit[i] = (kind == kKindExhausted || kind == kKindDebug) ? 1 : 0;
  for (int k = 0; k < 3; ++k) p.normal[3 * i + k] = normal[k];
}

}  // namespace

// One thread per ray.  bf16 1 reads the corner table as bf16 bits, else as
// f32; v16 1 takes the 16-byte load path (the caller checks that the rows
// and the table's base are 16-byte aligned).  Returns cudaGetLastError().
extern "C" int vrt_resolve_scene(
    const float* o_w, const float* d_w, const int32_t* winner,
    const int32_t* kind, const float* t, const int32_t* cell,
    const float* face, const int32_t* inst_volume, const float* inst_pos,
    const float* inst_rot, const float* inst_scale, int n_inst,
    const int32_t* n, const float* cell_size, const float* extends,
    const void* corners, int cc, int ch, int bf16, int v16, long long rays,
    float* t_out, float* normal, uint8_t* unlit, void* stream) {
  if (n_inst < 1 || ch < 8) return cudaErrorInvalidValue;
  const ResolveParams p{
      o_w, d_w, winner, kind, t, cell, face,
      Instances{inst_volume, inst_pos, inst_rot, inst_scale, nullptr, n_inst},
      Tables{n, cell_size, extends, nullptr, corners, nullptr, cc, ch},
      rays, t_out, normal, unlit};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>((rays + 255) / 256);
  if (bf16) {
    if (v16) resolve_kernel<uint16_t, true><<<grid, 256, 0, s>>>(p);
    else resolve_kernel<uint16_t, false><<<grid, 256, 0, s>>>(p);
  } else {
    if (v16) resolve_kernel<float, true><<<grid, 256, 0, s>>>(p);
    else resolve_kernel<float, false><<<grid, 256, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
